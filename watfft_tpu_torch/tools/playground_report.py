"""Playground report: the spectrogram and spectrum analyzer of the port's
real FFT as one self-contained interactive HTML page.

The port's counterpart of `tools/playground_report.py` (the analog of the
reference playground of wat-fft, playground/src/spectrogram.js and
main.js): a signal (a synthesized chirp and tones, or a user's WAV file)
goes through the port's pipelines on the device, the STFT mel spectrogram
(`stft.spectrogram`, `stft.mel_filterbank`) and one Hann-windowed
2048-point spectrum (`rfft`), and the page embeds the DATA, not pictures,
and renders it with inline JS: hover readouts, dB-floor and log/linear
toggles, an in-page WAV analysis, no external resources, opens offline.
The JAX report's benchmark panel is left out: it embeds the saved TPU
headline results, which are not the port's.

    python -m watfft_tpu_torch analyze file.wav [--html out.html] [--cpu]
    python -m watfft_tpu_torch.tools.playground_report [out.html] [--cpu] [--wav file.wav]

Chart styling follows the JAX report's palette: sequential magnitude is
one blue ramp light->dark, single-series marks in slot-1 blue, recessive
grid and axes.
"""

from __future__ import annotations

import base64
import html as _html
import json
import os
import sys

import numpy as np
import torch

from ..utils.accuracy import to_host
from . import device_or_exit

# palette (the JAX report's; light surface)
SURFACE = "#fcfcfb"
PAGE = "#f9f9f7"
INK = "#0b0b0b"
INK2 = "#52514e"
MUTED = "#898781"
GRID = "#e1e0d9"
BASELINE = "#c3c2b7"
BLUE = "#2a78d6"
# sequential blue ramp 100 -> 700 (magnitude job: one hue, light -> dark)
BLUE_RAMP = ["#cde2fb", "#b7d3f6", "#9ec5f4", "#86b6ef", "#6da7ec", "#5598e7",
             "#3987e5", "#2a78d6", "#256abf", "#1c5cab", "#184f95", "#104281",
             "#0d366b"]

PROG = "python -m watfft_tpu_torch.tools.playground_report"
REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def synth_signal(sr: int = 16000, seconds: float = 2.0) -> np.ndarray:
    """Chirp + two tones + noise floor (the spectrogram demo's signal)."""
    t = np.arange(int(sr * seconds)) / sr
    chirp = np.sin(2 * np.pi * (300 + 1800 * t) * t)
    tone1 = 0.5 * np.sin(2 * np.pi * 2500 * t)
    tone2 = 0.35 * np.sin(2 * np.pi * 5200 * t) * (t > seconds / 2)
    noise = 0.02 * np.random.default_rng(0).standard_normal(t.shape)
    return (chirp + tone1 + tone2 + noise).astype(np.float32)


def load_wav(path: str, max_seconds: float = 30.0):
    """Decode a PCM WAV with the stdlib (no audio dependencies): 8/16/24/32-bit
    integer or 32-bit float frames, any channel count (mono-ized by
    averaging), cut to `max_seconds`. Returns (float32 signal in [-1, 1],
    sample_rate)."""
    import wave
    try:
        with wave.open(path, "rb") as w:
            sr = w.getframerate()
            nch = w.getnchannels()
            width = w.getsampwidth()
            nframes = min(w.getnframes(), int(max_seconds * sr))
            raw = w.readframes(nframes)
    except (wave.Error, EOFError) as e:
        raise ValueError(
            f"{path!r} is not a readable PCM WAV file ({e}); supported: "
            f"8/16/24/32-bit integer or 32-bit float frames") from e
    if width == 1:  # unsigned 8-bit
        sig = (np.frombuffer(raw, np.uint8).astype(np.float32) - 128.0) / 128.0
    elif width == 2:
        sig = np.frombuffer(raw, "<i2").astype(np.float32) / 32768.0
    elif width == 3:  # packed 24-bit
        b = np.frombuffer(raw, np.uint8).reshape(-1, 3)
        v = (b[:, 0].astype(np.int32) | (b[:, 1].astype(np.int32) << 8)
             | (b[:, 2].astype(np.int32) << 16))
        v = np.where(v >= 1 << 23, v - (1 << 24), v)
        sig = v.astype(np.float32) / float(1 << 23)
    elif width == 4:
        iv = np.frombuffer(raw, "<i4")
        fv = np.frombuffer(raw, "<f4")
        # wave reports sampwidth 4 for IEEE-float and 32-bit integer files
        # alike; floats land in [-1, 1], integers do not
        sig = (fv.astype(np.float32) if np.all(np.isfinite(fv))
               and np.abs(fv).max(initial=0.0) <= 4.0
               else iv.astype(np.float32) / 2147483648.0)
    else:
        raise ValueError(f"unsupported WAV sample width {width}")
    if nch > 1:
        sig = sig.reshape(-1, nch).mean(axis=1)
    return np.ascontiguousarray(sig, np.float32), sr


def spectrogram_data(sig, sr, device="cuda") -> dict:
    """Mel spectrogram through the port's STFT on `device`, quantized for
    embedding: dB values mapped to uint8 over [-90, 0] dB of the maximum,
    base64-encoded; the page dequantizes and applies its dB floor."""
    from .. import stft as S
    n_fft, hop, n_mels = 512, 128, 96
    p = to_host(S.spectrogram(torch.as_tensor(sig), n_fft=n_fft, hop=hop, log=False,
                              device=device))
    fb = S.mel_filterbank(n_mels, n_fft, sr)
    mel_db = 10 * np.log10((p @ fb.T).T + 1e-12)  # [mels, frames]
    mel_db -= mel_db.max()
    span = 90.0  # embed 90 dB of range; the page's floor toggle works within it
    q = np.clip((mel_db + span) / span, 0, 1)
    u8 = (q * 255).astype(np.uint8)
    return {
        "n_fft": n_fft, "hop": hop, "n_mels": n_mels,
        "frames": int(u8.shape[1]), "sr": sr,
        "span_db": span,
        "seconds": round(len(sig) / sr, 3),
        "data_b64": base64.b64encode(u8.tobytes()).decode("ascii"),
    }


SPECTRUM_N = 2048


def spectrum_db(sig, sr, device="cuda") -> tuple[np.ndarray, np.ndarray]:
    """(dB magnitude, bin frequencies in Hz) of one Hann-windowed
    SPECTRUM_N-point frame from the middle of sig, through the port's
    public `rfft` (the planner-dispatched kernel) on `device`."""
    from .. import api
    from .. import stft as S
    n = SPECTRUM_N
    frame = sig[len(sig) // 2: len(sig) // 2 + n] * S.get_window("hann", n)
    X = to_host(api.rfft(torch.as_tensor(frame.astype(np.float32)), device=device))
    mag_db = 20 * np.log10(np.abs(X).astype(np.float64) + 1e-9)
    return mag_db, np.arange(len(X)) * sr / n


def spectrum_data(sig, sr, device="cuda") -> dict:
    """Spectrum-analyzer snapshot (`spectrum_db`), rounded for embedding,
    with direct labels on the three loudest peaks 300 Hz apart."""
    mag_db, freqs = spectrum_db(sig, sr, device)
    order = np.argsort(mag_db)[::-1]
    picked = []
    for i in order:
        if all(abs(freqs[i] - freqs[j]) > 300 for j in picked):
            picked.append(int(i))
        if len(picked) == 3:
            break
    return {
        "n": SPECTRUM_N, "sr": sr,
        "db": [round(float(v), 2) for v in mag_db],
        "peaks": [{"hz": round(float(freqs[i])), "db": round(float(mag_db[i]), 1)}
                  for i in picked],
    }


def selftest_data() -> dict:
    """numpy-f64 rfft oracle for the page's on-load self-test of its JS
    pipeline (the page checks itself in the browser)."""
    rng = np.random.default_rng(42)
    x = rng.uniform(-1, 1, 64)
    X = np.fft.rfft(x)
    return {"x": [float(v) for v in x],
            "re": [float(v) for v in X.real],
            "im": [float(v) for v in X.imag],
            "scale": float(np.max(np.abs(X)))}


HTML = r"""<!doctype html>
<html lang="en"><head><meta charset="utf-8">
<meta name="viewport" content="width=device-width, initial-scale=1">
<title>watfft_tpu_torch playground</title>
<style>
  :root { color-scheme: light; }
  body { background: __PAGE__; color: __INK__; margin: 0;
         font-family: system-ui, -apple-system, "Segoe UI", sans-serif; }
  main { max-width: 880px; margin: 0 auto; padding: 24px 16px 64px; }
  h1 { font-size: 22px; margin: 8px 0 2px; }
  h2 { font-size: 16px; margin: 28px 0 6px; }
  p.sub { color: __INK2__; margin: 0 0 12px; font-size: 13px; }
  .card { background: __SURFACE__; border: 1px solid rgba(11,11,11,0.10);
          border-radius: 10px; padding: 14px; margin: 10px 0; }
  canvas, svg { max-width: 100%; display: block; }
  table { border-collapse: collapse; font-size: 12.5px; margin-top: 8px;
          font-variant-numeric: tabular-nums; }
  th { text-align: left; color: __INK2__; font-weight: 600; }
  th, td { padding: 3px 14px 3px 0; border-bottom: 1px solid __GRID__; }
  code { background: __GRID__; border-radius: 4px; padding: 1px 5px;
         font-size: 12px; }
  footer { color: __MUTED__; font-size: 12px; margin-top: 28px; }
  .controls { display: flex; gap: 8px; align-items: center;
              font-size: 12.5px; color: __INK2__; margin-bottom: 8px;
              flex-wrap: wrap; }
  .controls button { background: __PAGE__; border: 1px solid __BASELINE__;
              border-radius: 6px; padding: 2px 10px; font-size: 12.5px;
              color: __INK2__; cursor: pointer; }
  .controls button.on { background: __BLUE__; border-color: __BLUE__;
              color: #fff; }
  .readout { font-variant-numeric: tabular-nums; color: __INK2__;
             font-size: 12.5px; min-height: 1.2em; margin-top: 6px; }
</style></head><body><main>
<h1>watfft_tpu_torch playground</h1>
<p class="sub">Generated by <code>python -m watfft_tpu_torch analyze</code>
(<code>watfft_tpu_torch.tools.playground_report</code>) on device
<b>__DEVICE__</b> — the PyTorch/CUDA port's analog of the reference's browser
playground (spectrogram and spectrum analyzer modes; the benchmark panel
returns once the port has benchmark results of its own). All data is
embedded; every panel has hover readouts and scale toggles; the file opens
offline.</p>

<h2>Mel spectrogram</h2>
<p class="sub">__SIGDESC__,
through <code>watfft_tpu_torch.stft.spectrogram</code>. Hover for (time, mel bin,
dB); the floor buttons re-map the color ramp.</p>
<div class="card">
  <div class="controls">dB floor:
    <button data-floor="60">-60</button>
    <button data-floor="75" class="on">-75</button>
    <button data-floor="90">-90</button>
  </div>
  <canvas id="spec" width="840" height="300"></canvas>
  <div class="readout" id="spec-read">&nbsp;</div>
</div>

<h2>Spectrum analyzer</h2>
<p class="sub">One Hann-windowed 2048-point frame through the public
<code>watfft_tpu_torch.rfft</code> (the planner-dispatched kernel). Hover traces the
curve; toggle the frequency axis.</p>
<div class="card">
  <div class="controls">frequency axis:
    <button data-fx="lin" class="on">linear</button>
    <button data-fx="log">log</button>
  </div>
  <svg id="spectrum" width="840" height="280" viewBox="0 0 840 280"></svg>
  <div class="readout" id="spectrum-read">&nbsp;</div>
</div>

<h2>Analyze your own audio</h2>
<p class="sub">Drop (or pick) a PCM WAV file and the panels above re-render
from it — decoded and analyzed entirely in this page (no server, works
offline) by a JavaScript port of the same pipeline: pack-as-complex
half-size FFT + Hermitian post-process (the framework's real path), Hann
window, mel filterbank. The reference playground's live-input modes,
as a file-input analog.</p>
<div class="card">
  <div class="controls">
    <input type="file" id="wav-input" accept=".wav,audio/wav,audio/x-wav">
    <button id="wav-reset" style="display:none">back to embedded signal</button>
  </div>
  <div class="readout" id="wav-status">no file loaded — showing the embedded signal</div>
</div>

<footer>watfft_tpu_torch — the PyTorch and CUDA port of watfft_tpu.
Reference playground: playground/src in EmNudge/wat-fft.</footer>

<script>
const SPEC = __SPEC_JSON__;
const SPECTRUM = __SPECTRUM_JSON__;
const RAMP = __RAMP_JSON__;
const SELFTEST = __SELFTEST_JSON__;
const C = { ink: "__INK__", ink2: "__INK2__", muted: "__MUTED__",
            grid: "__GRID__", base: "__BASELINE__", blue: "__BLUE__" };

function lerpRamp(t) {  // t in [0,1] -> css color from the blue ramp
  const x = Math.max(0, Math.min(1, t)) * (RAMP.length - 1);
  const i = Math.floor(x), f = x - i;
  const a = RAMP[i], b = RAMP[Math.min(i + 1, RAMP.length - 1)];
  const pc = h => [1, 3, 5].map(k => parseInt(h.slice(k, k + 2), 16));
  const [r1, g1, b1] = pc(a), [r2, g2, b2] = pc(b);
  return `rgb(${Math.round(r1 + f * (r2 - r1))},${Math.round(g1 + f * (g2 - g1))},${Math.round(b1 + f * (b2 - b1))})`;
}

// ---- spectrogram: uint8 dB grid -> canvas, dB-floor toggle, hover ----
// state is swappable (window.__updateSpec) so the in-browser WAV analysis
// below can redraw the same panel with recomputed data
(function () {
  const raw = atob(SPEC.data_b64);
  const u80 = new Uint8Array(raw.length);
  for (let i = 0; i < raw.length; i++) u80[i] = raw.charCodeAt(i);
  let S = { u8: u80, mels: SPEC.n_mels, frames: SPEC.frames,
            span: SPEC.span_db, hop: SPEC.hop, sr: SPEC.sr };
  const cv = document.getElementById("spec");
  const ctx = cv.getContext("2d");
  let floor = 75;
  function draw() {
    const img = ctx.createImageData(S.frames, S.mels);
    for (let m = 0; m < S.mels; m++) {
      for (let f = 0; f < S.frames; f++) {
        const db = (S.u8[m * S.frames + f] / 255) * S.span - S.span;
        const t = Math.max(0, Math.min(1, (db + floor) / floor));
        const col = lerpRamp(t).match(/\d+/g).map(Number);
        const o = ((S.mels - 1 - m) * S.frames + f) * 4;
        img.data[o] = col[0]; img.data[o + 1] = col[1];
        img.data[o + 2] = col[2]; img.data[o + 3] = 255;
      }
    }
    const off = document.createElement("canvas");  // no OffscreenCanvas dep
    off.width = S.frames; off.height = S.mels;
    off.getContext("2d").putImageData(img, 0, 0);
    ctx.imageSmoothingEnabled = false;
    ctx.clearRect(0, 0, cv.width, cv.height);
    ctx.drawImage(off, 0, 0, S.frames, S.mels, 0, 0, cv.width, cv.height);
  }
  window.__updateSpec = d => { S = d; draw(); };
  draw();
  document.querySelectorAll("[data-floor]").forEach(b =>
    b.addEventListener("click", () => {
      document.querySelectorAll("[data-floor]").forEach(x => x.classList.remove("on"));
      b.classList.add("on"); floor = +b.dataset.floor; draw();
    }));
  const read = document.getElementById("spec-read");
  cv.addEventListener("mousemove", e => {
    const r = cv.getBoundingClientRect();
    const f = Math.floor((e.clientX - r.left) / r.width * S.frames);
    const m = S.mels - 1 - Math.floor((e.clientY - r.top) / r.height * S.mels);
    if (f < 0 || f >= S.frames || m < 0 || m >= S.mels) return;
    const db = ((S.u8[m * S.frames + f] / 255) * S.span - S.span).toFixed(1);
    const t = (f * S.hop / S.sr).toFixed(3);
    read.textContent = `t = ${t} s   mel bin ${m}   ${db} dB (rel max)`;
  });
  cv.addEventListener("mouseleave", () => read.innerHTML = "&nbsp;");
})();

// ---- spectrum: polyline + peak labels, lin/log freq axis, hover ----
// state is swappable (window.__updateSpectrum) for the WAV analysis below
(function () {
  const svg = document.getElementById("spectrum");
  let D = SPECTRUM;
  const W = 840, H = 280, L = 46, R = 10, T = 10, B = 30;
  const dbMin = -100;
  let mode = "lin";
  const fOf = i => i * D.sr / D.n;
  function xOf(i) {
    if (mode === "lin") return L + (fOf(i) / (D.sr / 2)) * (W - L - R);
    const lo = Math.log10(fOf(1)), hi = Math.log10(D.sr / 2);
    return L + (Math.log10(Math.max(fOf(i), fOf(1))) - lo) / (hi - lo) * (W - L - R);
  }
  let dbMax = 0;
  const yOf = v => T + (dbMax - v) / (dbMax - dbMin) * (H - T - B);
  function draw() {
    const db = D.db;
    dbMax = Math.ceil(Math.max(...db) / 10) * 10;
    let s = "";
    // recessive grid + axis labels
    for (let g = dbMax; g >= dbMin; g -= 20) {
      const y = yOf(g);
      s += `<line x1="${L}" y1="${y}" x2="${W - R}" y2="${y}" stroke="${C.grid}"/>`;
      s += `<text x="${L - 6}" y="${y + 4}" text-anchor="end" font-size="10" fill="${C.muted}">${g}</text>`;
    }
    const half = D.sr / 2;
    const ticks = (mode === "lin"
      ? [0, 0.25, 0.5, 0.75, 1].map(t => Math.round(t * half))
      : [100, 300, 1000, 3000, 10000].filter(f => f <= half));
    for (const f of ticks) {
      const i = Math.round(f * D.n / D.sr);
      const x = xOf(Math.max(i, 1));
      s += `<text x="${x}" y="${H - 10}" text-anchor="middle" font-size="10" fill="${C.muted}">${f >= 1000 ? (f / 1000) + "k" : f}</text>`;
    }
    s += `<text x="${L - 34}" y="${T + 8}" font-size="10" fill="${C.ink2}">dB</text>`;
    let pts = "";
    for (let i = 1; i < db.length; i++)
      pts += `${xOf(i).toFixed(1)},${yOf(Math.max(db[i], dbMin)).toFixed(1)} `;
    s += `<polyline points="${pts}" fill="none" stroke="${C.blue}" stroke-width="2"/>`;
    for (const p of D.peaks) {
      const i = Math.round(p.hz * D.n / D.sr);
      s += `<text x="${xOf(i) + 4}" y="${yOf(p.db) - 4}" font-size="10" fill="${C.ink2}">${p.hz} Hz</text>`;
    }
    s += `<rect id="spectrum-hit" x="${L}" y="${T}" width="${W - L - R}" height="${H - T - B}" fill="transparent"/>`;
    svg.innerHTML = s;
    hook();
  }
  window.__updateSpectrum = d => { D = d; draw(); };
  const read = document.getElementById("spectrum-read");
  function hook() {
    const hit = document.getElementById("spectrum-hit");
    hit.addEventListener("mousemove", e => {
      const r = svg.getBoundingClientRect();
      const px = (e.clientX - r.left) * (W / r.width);
      let best = 1, bd = 1e9;
      for (let i = 1; i < D.db.length; i++) {
        const d = Math.abs(xOf(i) - px);
        if (d < bd) { bd = d; best = i; }
      }
      read.textContent = `${Math.round(fOf(best))} Hz   ${D.db[best].toFixed(1)} dB`;
    });
    hit.addEventListener("mouseleave", () => read.innerHTML = "&nbsp;");
  }
  document.querySelectorAll("[data-fx]").forEach(b =>
    b.addEventListener("click", () => {
      document.querySelectorAll("[data-fx]").forEach(x => x.classList.remove("on"));
      b.classList.add("on"); mode = b.dataset.fx; draw();
    }));
  draw();
})();

// ---- in-browser analysis: WAV decode + JS port of the real-FFT pipeline ----
// Mirrors watfft_tpu_torch: jsRfft = pack-as-complex m-point complex core
// + Hermitian post (ops/rfft.hermitian_post_nb's formulas); hann =
// stft.get_window's periodic variant; framing/mel/dB match stft.py.
function jsFFT(re, im, inverse) {  // iterative radix-2, n power of two
  const n = re.length;
  for (let i = 1, j = 0; i < n; i++) {   // bit-reversal permutation
    let bit = n >> 1;
    for (; j & bit; bit >>= 1) j ^= bit;
    j ^= bit;
    if (i < j) {
      let t = re[i]; re[i] = re[j]; re[j] = t;
      t = im[i]; im[i] = im[j]; im[j] = t;
    }
  }
  for (let len = 2; len <= n; len <<= 1) {
    const ang = (inverse ? 2 : -2) * Math.PI / len;
    const wr = Math.cos(ang), wi = Math.sin(ang);
    const half = len >> 1;
    for (let i = 0; i < n; i += len) {
      let cr = 1, ci = 0;
      for (let k = 0; k < half; k++) {
        const ar = re[i + k], ai = im[i + k];
        const xr = re[i + k + half], xi = im[i + k + half];
        const br = xr * cr - xi * ci, bi = xr * ci + xi * cr;
        re[i + k] = ar + br; im[i + k] = ai + bi;
        re[i + k + half] = ar - br; im[i + k + half] = ai - bi;
        const t = cr * wr - ci * wi; ci = cr * wi + ci * wr; cr = t;
      }
    }
  }
  if (inverse) for (let i = 0; i < n; i++) { re[i] /= n; im[i] /= n; }
}
function jsRfft(x) {  // real [n] -> {re, im} each [n/2+1]
  const n = x.length, m = n >> 1;
  const zr = new Float64Array(m), zi = new Float64Array(m);
  for (let j = 0; j < m; j++) { zr[j] = x[2 * j]; zi[j] = x[2 * j + 1]; }
  jsFFT(zr, zi, false);
  const Xr = new Float64Array(m + 1), Xi = new Float64Array(m + 1);
  Xr[0] = zr[0] + zi[0]; Xr[m] = zr[0] - zi[0];
  for (let k = 1; k < m; k++) {
    const ar = zr[k], ai = zi[k], br = zr[m - k], bi = zi[m - k];
    const er = 0.5 * (ar + br), ei = 0.5 * (ai - bi);
    const or_ = 0.5 * (ai + bi), oi = -0.5 * (ar - br);
    const ang = -Math.PI * k / m, wr = Math.cos(ang), wi = Math.sin(ang);
    Xr[k] = er + wr * or_ - wi * oi;
    Xi[k] = ei + wr * oi + wi * or_;
  }
  return { re: Xr, im: Xi };
}
function jsHann(n) {
  const w = new Float64Array(n);
  for (let i = 0; i < n; i++) w[i] = 0.5 - 0.5 * Math.cos(2 * Math.PI * i / n);
  return w;
}
function jsMelBank(nMels, nFft, sr) {  // [nMels][nFft/2+1] triangles (htk mel)
  const h2m = f => 2595 * Math.log10(1 + f / 700);
  const m2h = m => 700 * (Math.pow(10, m / 2595) - 1);
  const mmax = h2m(sr / 2), bins = [];
  for (let i = 0; i < nMels + 2; i++)
    bins.push(Math.floor((nFft + 1) * m2h(mmax * i / (nMels + 1)) / sr));
  const fb = [];
  for (let i = 0; i < nMels; i++) {
    const row = new Float64Array(nFft / 2 + 1);
    const [a, b, c] = [bins[i], bins[i + 1], bins[i + 2]];
    for (let j = a; j < b; j++) row[j] = (j - a) / (b - a);
    for (let j = b; j < c; j++) row[j] = (c - j) / (c - b);
    fb.push(row);
  }
  return fb;
}
function parseWav(buf, maxSeconds) {  // -> {sig: Float64Array, sr}
  const dv = new DataView(buf);
  const tag = o => String.fromCharCode(dv.getUint8(o), dv.getUint8(o + 1),
                                       dv.getUint8(o + 2), dv.getUint8(o + 3));
  if (dv.byteLength < 44 || tag(0) !== "RIFF" || tag(8) !== "WAVE")
    throw new Error("not a RIFF/WAVE file");
  let off = 12, fmt = null, data = null;
  while (off + 8 <= dv.byteLength) {
    const id = tag(off), sz = dv.getUint32(off + 4, true);
    if (id === "fmt ")
      fmt = { code: dv.getUint16(off + 8, true), ch: dv.getUint16(off + 10, true),
              sr: dv.getUint32(off + 12, true), bits: dv.getUint16(off + 22, true) };
    else if (id === "data")
      data = { off: off + 8, sz: Math.min(sz, dv.byteLength - off - 8) };
    off += 8 + sz + (sz & 1);
  }
  if (!fmt || !data) throw new Error("missing fmt/data chunk");
  if (fmt.code !== 1 && fmt.code !== 3 && fmt.code !== 0xFFFE)
    throw new Error("unsupported WAV codec " + fmt.code);
  const bytes = fmt.bits / 8;
  let nfr = Math.floor(data.sz / (bytes * fmt.ch));
  nfr = Math.min(nfr, Math.floor(maxSeconds * fmt.sr));
  const sig = new Float64Array(nfr);
  for (let i = 0; i < nfr; i++) {
    let acc = 0;
    for (let c = 0; c < fmt.ch; c++) {
      const o = data.off + (i * fmt.ch + c) * bytes;
      let v;
      if (fmt.bits === 8) v = (dv.getUint8(o) - 128) / 128;
      else if (fmt.bits === 16) v = dv.getInt16(o, true) / 32768;
      else if (fmt.bits === 24) {
        let u = dv.getUint8(o) | (dv.getUint8(o + 1) << 8) | (dv.getUint8(o + 2) << 16);
        if (u >= 1 << 23) u -= 1 << 24;
        v = u / (1 << 23);
      } else if (fmt.bits === 32)
        v = (fmt.code === 3) ? dv.getFloat32(o, true)
                             : dv.getInt32(o, true) / 2147483648;
      else throw new Error("unsupported WAV bit depth " + fmt.bits);
      acc += v;
    }
    sig[i] = acc / fmt.ch;
  }
  return { sig, sr: fmt.sr };
}
function analyzeSignal(sig, sr) {  // -> {spec, spectrum} panel states
  // mel spectrogram: n_fft=512 hop=128 n_mels=96, span 90 dB (stft.py params)
  const nFft = 512, hop = 128, nMels = 96, span = 90;
  const win = jsHann(nFft);
  const frames = Math.max(0, Math.floor((sig.length - nFft) / hop) + 1);
  const nBins = nFft / 2 + 1;
  const fb = jsMelBank(nMels, nFft, sr);
  const mel = new Float64Array(nMels * frames);
  const fr = new Float64Array(nFft);
  for (let f = 0; f < frames; f++) {
    for (let i = 0; i < nFft; i++) fr[i] = sig[f * hop + i] * win[i];
    const X = jsRfft(fr);
    for (let mI = 0; mI < nMels; mI++) {
      let s = 0;
      const row = fb[mI];
      for (let j = 0; j < nBins; j++)
        if (row[j]) s += row[j] * (X.re[j] * X.re[j] + X.im[j] * X.im[j]);
      mel[mI * frames + f] = s;
    }
  }
  let mx = -Infinity;
  const melDb = new Float64Array(mel.length);
  for (let i = 0; i < mel.length; i++) {
    melDb[i] = 10 * Math.log10(mel[i] + 1e-12);
    if (melDb[i] > mx) mx = melDb[i];
  }
  const u8 = new Uint8Array(mel.length);
  for (let i = 0; i < mel.length; i++) {
    const q = Math.max(0, Math.min(1, (melDb[i] - mx + span) / span));
    u8[i] = Math.round(q * 255);
  }
  // spectrum: one Hann-windowed 2048-point frame from the middle
  const n2 = 2048, mid = Math.floor(sig.length / 2);
  const w2 = jsHann(n2), fr2 = new Float64Array(n2);
  for (let i = 0; i < n2; i++) fr2[i] = (sig[mid + i] || 0) * w2[i];
  const X2 = jsRfft(fr2);
  const db = [];
  for (let i = 0; i < X2.re.length; i++)
    db.push(20 * Math.log10(Math.hypot(X2.re[i], X2.im[i]) + 1e-9));
  const order = db.map((v, i) => i).sort((a, b) => db[b] - db[a]);
  const peaks = [];
  for (const i of order) {
    const hz = i * sr / n2;
    if (peaks.every(p => Math.abs(p.hz - hz) > 300))
      peaks.push({ hz: Math.round(hz), db: +db[i].toFixed(1) });
    if (peaks.length === 3) break;
  }
  return {
    spec: { u8, mels: nMels, frames, span, hop, sr },
    spectrum: { n: n2, sr, db, peaks },
  };
}
(function () {
  const input = document.getElementById("wav-input");
  const status = document.getElementById("wav-status");
  const reset = document.getElementById("wav-reset");
  // self-test on load: jsRfft vs a numpy oracle embedded at build time —
  // no JS engine exists in the repo's test image, so the page itself is
  // where the JS pipeline gets numerically checked (visible on failure)
  const st = SELFTEST;
  const stGot = jsRfft(Float64Array.from(st.x));
  let stErr = 0;
  for (let i = 0; i < st.re.length; i++)
    stErr = Math.max(stErr, Math.abs(stGot.re[i] - st.re[i]),
                     Math.abs(stGot.im[i] - st.im[i]));
  if (!(stErr < 1e-9 * st.scale)) {
    status.textContent = "WARNING: in-browser FFT self-test failed (err " +
      stErr + ") — the JS analysis pipeline is unreliable in this browser";
    input.disabled = true;
    return;
  }
  function run(file) {
    const rd = new FileReader();
    rd.onload = () => {
      try {
        const { sig, sr } = parseWav(rd.result, 30);
        if (sig.length < 4096)
          throw new Error("signal too short to analyze (" + sig.length +
                          " samples; need >= 4096)");
        const t0 = performance.now();
        const r = analyzeSignal(sig, sr);
        window.__updateSpec(r.spec);
        window.__updateSpectrum(r.spectrum);
        status.textContent = `${file.name}: ${(sig.length / sr).toFixed(1)}s ` +
          `at ${sr} Hz — ${r.spec.frames} frames analyzed in ` +
          `${(performance.now() - t0).toFixed(0)} ms (in-browser JS pipeline)`;
        reset.style.display = "";
      } catch (e) { status.textContent = "error: " + e.message; }
    };
    rd.readAsArrayBuffer(file);
  }
  input.addEventListener("change", () => {
    if (input.files.length) run(input.files[0]);
  });
  document.body.addEventListener("dragover", e => e.preventDefault());
  document.body.addEventListener("drop", e => {
    e.preventDefault();
    if (e.dataTransfer.files.length) run(e.dataTransfer.files[0]);
  });
  reset.addEventListener("click", () => location.reload());
})();

</script>
</main></body></html>
"""


SYNTH_DESC = ("Chirp (300&#8594;3900 Hz) + 2.5 kHz tone + gated 5.2 kHz "
              "tone")


def _device_label(device) -> str:
    device = torch.device(device)
    if device.type == "cuda":
        return f"cuda ({_html.escape(torch.cuda.get_device_name(device))})"
    return "cpu (the kernels' plain versions)"


def build_report(sig, sr: int, out: str, sig_desc: str = SYNTH_DESC, device="cuda") -> str:
    """Render the interactive report for (sig, sr) on `device`: the shared
    back end of the synthetic demo and the user-audio `analyze` path."""
    if len(sig) < 4096:
        raise ValueError(f"signal too short to analyze ({len(sig)} samples; "
                         f"need >= 4096)")
    page = HTML
    for k, v in (("__PAGE__", PAGE), ("__SURFACE__", SURFACE),
                 ("__INK__", INK), ("__INK2__", INK2), ("__MUTED__", MUTED),
                 ("__GRID__", GRID), ("__BASELINE__", BASELINE),
                 ("__BLUE__", BLUE), ("__DEVICE__", _device_label(device)),
                 ("__SIGDESC__", sig_desc),
                 ("__SPEC_JSON__", json.dumps(spectrogram_data(sig, sr, device))),
                 ("__SPECTRUM_JSON__", json.dumps(spectrum_data(sig, sr, device))),
                 ("__RAMP_JSON__", json.dumps(BLUE_RAMP)),
                 ("__SELFTEST_JSON__", json.dumps(selftest_data()))):
        page = page.replace(k, v)
    with open(out, "w") as f:
        f.write(page)
    print(f"wrote {out} ({os.path.getsize(out) // 1024} KB)")
    return out


def main(argv=None) -> str:
    """[out.html] [--cpu] [--wav file.wav]; returns the page's path (by
    default under the git-ignored `build/watfft_tpu_torch/`). Runs on the
    CUDA device unless --cpu is given."""
    argv = sys.argv[1:] if argv is None else argv
    args = [a for a in argv if not a.startswith("--")]
    device = device_or_exit("--cpu" in argv, PROG)
    wav = None
    if "--wav" in argv:
        wav = argv[argv.index("--wav") + 1]
        args = [a for a in args if a != wav]
    out = args[0] if args else os.path.join(REPO, "build", "watfft_tpu_torch",
                                            "playground_report.html")
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    if wav:
        sig, sr = load_wav(wav)
        desc = (f"<code>{_html.escape(os.path.basename(wav))}</code> "
                f"({len(sig)/sr:.1f}s at {sr} Hz, mono-ized)")
        return build_report(sig, sr, out, desc, device)
    sr = 16000
    return build_report(synth_signal(sr), sr, out, device=device)


if __name__ == "__main__":
    main()
