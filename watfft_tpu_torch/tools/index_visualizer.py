"""Per-stage dataflow of the port's Stockham plan, and the CUDA stage's
thread map.

The port's counterpart of `tools/index_visualizer.py` (after
tools/index_visualizer.js of wat-fft): which rows each stage reads and
writes, so that a stage-coordination fault (stage i's output not laid out
as stage i+1 reads it) is found in the index tables. For every stage
(R, l) of `ops.stockham.stage_plan(n)`, one group a butterfly:

    read rows   p*q + j*l + k          (q = n/R; the R contiguous blocks)
    twiddle     offset + (p-1)*q + j*l + k, p = 1..R-1 (none where l == 1)
    write rows  j*R*l + p*l + k        (the Stockham interleave)

`thread_map(n, P)` gives the same rows as the CUDA stage reaches them
(`stage_io` in `ops/csrc/stockham.cuh`): a transform takes tpt = n/P
threads; thread th does the butterflies i = th + m*tpt, m < P/R; it reads
rows p*q + i and twiddle rows twoff + (p-1)*q + i and writes rows
((i >> log2 l)*R << log2 l) + (i & (l-1)) + s*l. P is the largest radix
the instance unrolls: the plan's own (the engine, `make_plan`), which on
the port's plan is min(n, 16), the P of the column-tile instances too
(they run the plans with a radix-16 stage).

Four invariants are checked mechanically:
  1. every stage's writes are a permutation of 0..n-1,
  2. every stage's reads cover 0..n-1 (the blocks of the previous writes),
  3. the composed data movement is a permutation,
  4. at P = min(n, 16), the (thread, m) pairs cover each butterfly
     exactly once, and the thread map's reads,
     twiddle rows and writes equal the groups of invariants 1-3.
(The values' natural order is `permutation_validator`'s proof.)

    python -m watfft_tpu_torch.tools.index_visualizer [n ...] [--rows K] [--quiet]

Sizes default to 64 and 2048; `--rows` caps the groups and threads printed a
stage; `--quiet` prints the verdicts alone. Pure index algebra: no device.
Exit code 0 iff every invariant holds.
"""

from __future__ import annotations

import sys

import numpy as np

from ..ops.stockham import MAX_RADIX, make_twiddle_pack, stage_plan

__all__ = ["stage_patterns", "check_invariants", "thread_map", "check_thread_map",
           "thread_width", "visualize", "main"]


def _write_row(j: int, k: int, p: int, r: int, l: int) -> int:
    """Row of output p of butterfly (j, k): the Stockham interleave."""
    return j * r * l + p * l + k


def _thread_base(i: int, r: int, log2l: int) -> int:
    """`stage_io`'s first output row of butterfly i; output s lands s*l past it."""
    return ((i >> log2l) * r << log2l) + (i & ((1 << log2l) - 1))


def stage_patterns(n: int) -> list[dict]:
    """The read / twiddle / write table of every stage of n's plan: one dict a
    stage, {r, l, q, g, tw_offset, rows: [(read_rows, tw_rows, write_rows),
    ...]}, one entry a butterfly (j, k) in the order j*l + k: the R rows
    that combine, the R-1 twiddle pack rows of p = 1..R-1 (None where
    l == 1) and the R rows the outputs land on."""
    offsets = make_twiddle_pack(n, False)[2]
    stages = []
    for idx, (r, l) in enumerate(stage_plan(n)):
        q, g = n // r, n // (r * l)
        rows = []
        for j in range(g):
            for k in range(l):
                read = [p * q + j * l + k for p in range(r)]
                write = [_write_row(j, k, p, r, l) for p in range(r)]
                tw = None
                if offsets[idx] >= 0:
                    tw = [offsets[idx] + (p - 1) * q + j * l + k for p in range(1, r)]
                rows.append((read, tw, write))
        stages.append({"r": r, "l": l, "q": q, "g": g, "tw_offset": offsets[idx],
                       "rows": rows})
    return stages


def check_invariants(n: int, stages: list[dict]) -> list[str]:
    """Invariants 1-3 over the pattern table; the failures as strings."""
    fails = []
    perm = np.arange(n)
    for i, s in enumerate(stages):
        writes = np.full(n, -1)
        for read, _, write in s["rows"]:
            for rr, wr in zip(read, write):
                if not 0 <= wr < n:
                    fails.append(f"n={n} stage {i}: row {wr} written, outside 0..{n - 1}")
                    continue
                if writes[wr] != -1:
                    fails.append(f"n={n} stage {i}: row {wr} written twice")
                writes[wr] = rr
        if (writes < 0).any():
            fails.append(f"n={n} stage {i}: {int((writes < 0).sum())} rows never written")
            continue
        if sorted(r for read, _, _ in s["rows"] for r in read) != list(range(n)):
            fails.append(f"n={n} stage {i}: reads are not a cover of 0..n-1")
        perm = perm[writes]
    if sorted(perm.tolist()) != list(range(n)):
        fails.append(f"n={n}: composed chain is not a permutation")
    return fails


def thread_width(n: int) -> int:
    """The P the CUDA instances run n's plan at: min(n, 16), the plan's
    largest radix (the engine's P) and the column tile's 16 where the plan
    has a radix-16 stage."""
    return min(n, MAX_RADIX)


def thread_map(n: int, P: int) -> list[dict]:
    """The rows each thread of one transform reaches in every stage at P
    points a thread: one dict a stage, {r, l, tpt, m, threads: [(th, m, i,
    read_rows, tw_rows, write_rows), ...]}, in `stage_io`'s order."""
    offsets = make_twiddle_pack(n, False)[2]
    tpt = n // P
    out = []
    for idx, (r, l) in enumerate(stage_plan(n)):
        if r > P:
            raise ValueError(f"n={n}: a radix-{r} stage needs P >= {r}, got P={P}")
        q, log2l, twoff = n // r, l.bit_length() - 1, offsets[idx]
        threads = []
        for th in range(tpt):
            for m in range(P // r):
                i = th + m * tpt
                read = [p * q + i for p in range(r)]
                tw = None if twoff < 0 else [twoff + (p - 1) * q + i for p in range(1, r)]
                base = _thread_base(i, r, log2l)
                threads.append((th, m, i, read, tw, [base + s * l for s in range(r)]))
        out.append({"r": r, "l": l, "tpt": tpt, "m": P // r, "threads": threads})
    return out


def check_thread_map(n: int, P: int, stages: list[dict]) -> list[str]:
    """Invariant 4 at P: the (thread, m) pairs cover each butterfly exactly
    once and reach the rows of `stage_patterns`' groups."""
    fails = []
    for idx, (s, t) in enumerate(zip(stages, thread_map(n, P))):
        where = f"n={n} P={P} stage {idx}"
        seen = sorted(rec[2] for rec in t["threads"])
        if seen != list(range(s["q"])):
            fails.append(f"{where}: the threads' butterflies are not 0..{s['q'] - 1} once each")
            continue
        for th, m, i, read, tw, write in t["threads"]:
            if (read, tw, write) != s["rows"][i]:
                fails.append(f"{where}: thread {th} m={m} (butterfly {i}) reads {read} tw {tw} "
                             f"writes {write}, the stage's group {s['rows'][i]}")
                break
    return fails


def visualize(n: int, max_rows: int = 8, quiet: bool = False) -> bool:
    stages = stage_patterns(n)
    plan = [(s["r"], s["l"]) for s in stages]
    P = thread_width(n)
    tmap = thread_map(n, P)
    if not quiet:
        print(f"\nn={n}  plan={plan}  (time-major [n, b] and batch-major [b, n] alike: "
              f"rows are points of one transform)")
    for i, s in enumerate(stages):
        if quiet:
            break
        tw = ("twiddle-free (l=1)" if s["tw_offset"] < 0 else
              f"twiddle pack rows {s['tw_offset']}..."
              f"{s['tw_offset'] + (s['r'] - 1) * s['q'] - 1}")
        print(f"  stage {i}: R={s['r']:<3} l={s['l']:<5} q={s['q']:<5} "
              f"groups={s['g'] * s['l']:<6} {tw}")
        for read, twc, write in s["rows"][:max_rows]:
            print(f"    read {read} -> write {write}" + ("" if twc is None else f"  tw={twc}"))
        if len(s["rows"]) > max_rows:
            print(f"    ... {len(s['rows']) - max_rows} more groups")
        t = tmap[i]
        print(f"    CUDA stage at P={P}: {t['tpt']} threads a transform, "
              f"{t['m']} butterflies each")
        for th, m, bi, read, _, write in t["threads"][:max_rows]:
            print(f"      thread {th} m={m}: butterfly {bi} read {read} -> write {write}")
        if len(t["threads"]) > max_rows:
            print(f"      ... {len(t['threads']) - max_rows} more")
    fails = check_invariants(n, stages) + check_thread_map(n, P, stages)
    for f in fails:
        print(f"  FAIL: {f}")
    if not fails:
        print(f"n={n}: OK — {len(stages)} stages, every write unique, reads cover writes, "
              f"composed chain is a permutation, the CUDA thread map at P={P} covers "
              f"each butterfly once on the same rows")
    return not fails


def main(argv=None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    quiet = "--quiet" in args
    max_rows = 8
    if "--rows" in args:
        at = args.index("--rows")
        max_rows = int(args[at + 1])
        del args[at:at + 2]
    sizes = [int(a) for a in args if not a.startswith("--")] or [64, 2048]
    ok = True
    for n in sizes:
        ok &= visualize(n, max_rows=max_rows, quiet=quiet)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
