"""Dead-surface lint of the port: no module or public name may be unreachable.

The port's counterpart of `tools/lint_dead_surfaces.py` (after
tools/lint-wasm-dead-code.js of wat-fft), with its two rules over
`watfft_tpu_torch/`:
  1. every module (but `__init__` and `__main__`) is named in another file,
  2. every name in a module's `__all__` is named outside that module.
References count only from the port's own files: `watfft_tpu_torch/`,
`tests/test_torch_*.py`, `chip_smoke.py`, `scripts/` and
`examples/torch_*.py`. They never count from the JAX package or its tests,
whose identical names would hide dead port code.

    python -m watfft_tpu_torch.tools.lint_dead_surfaces [root] [--strict]

`root` is the checkout to lint (default: the one this module lies in).
`--strict` exits 1 on any finding; without it the lint only reports.
"""

from __future__ import annotations

import argparse
import ast
import sys
from pathlib import Path

__all__ = ["PACKAGE", "port_files", "find_dead", "main"]

PACKAGE = "watfft_tpu_torch"


def port_files(root: Path) -> tuple[list[Path], list[Path]]:
    """(the package's modules, every port file a reference may come from)."""
    package = sorted(p for p in (root / PACKAGE).rglob("*.py") if "__pycache__" not in p.parts)
    others = [*sorted((root / "tests").glob("test_torch_*.py")), root / "chip_smoke.py",
              *sorted((root / "scripts").rglob("*.py")),
              *sorted((root / "examples").glob("torch_*.py"))]
    return package, package + [p for p in others if p.is_file()]


def _exports(tree: ast.Module) -> list[str]:
    exported = []
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name) and node.targets[0].id == "__all__"
                and isinstance(node.value, (ast.List, ast.Tuple))):
            exported = [e.value for e in node.value.elts if isinstance(e, ast.Constant)]
    return exported


def find_dead(root) -> tuple[int, list[str]]:
    """The package's module count and the lint's findings under `root`."""
    root = Path(root)
    package, sources = port_files(root)
    text = {p: p.read_text() for p in sources}
    problems = []
    for p in package:
        rel = p.relative_to(root)
        if p.stem not in ("__init__", "__main__") and not any(
                p.stem in src for q, src in text.items() if q != p):
            problems.append(f"dead module: {rel} (never imported)")
        try:
            tree = ast.parse(text[p])
        except SyntaxError as exc:
            problems.append(f"syntax error in {rel}: {exc}")
            continue
        for name in _exports(tree):
            if not any(name in src for q, src in text.items() if q != p):
                problems.append(f"dead export: {rel}:__all__ -> {name}")
    return len(package), problems


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="lint_dead_surfaces", description=__doc__.splitlines()[0])
    p.add_argument("root", nargs="?", default=str(Path(__file__).resolve().parents[2]))
    p.add_argument("--strict", action="store_true", help="exit 1 on any finding")
    args = p.parse_args(argv)
    count, problems = find_dead(args.root)
    if not count:
        print(f"no {PACKAGE}/ under {args.root}")
        return 2
    if problems:
        print("\n".join(problems))
        return 1 if args.strict else 0
    print(f"OK: {count} modules, no dead surfaces")
    return 0


if __name__ == "__main__":
    sys.exit(main())
