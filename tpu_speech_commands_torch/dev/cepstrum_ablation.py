#!/usr/bin/env python3
"""The cepstrum kernel (csrc/cepstrum_wgmma.cu) against its first design
(csrc/cepstrum.cu), and the trimmed DCT region of the register and wide FFT
bodies (csrc/register_fft.cuh), each against what it replaces, in turns on
the card; and the sweep `fft_plan.cepstrum_mode`'s threshold comes from.

    python -m tpu_speech_commands_torch.dev.cepstrum_ablation [--batch 8192]
        [--iters 10] [--parts trim radix2 split_dup sweep alone cuts]

Parts (every config at B windows of f32 audio, gain 1, hop 512; the audio
is `speech_audio`'s, the example clips at random gains and a little noise):

  trim       the fused register body at n_fft 1024 with its DCT region of
             the n_mfcc - 1 columns the output uses, against the whole
             n_filt x n_filt table (`_full_dct=True`) at TRIM_CASES, in
             turns trimmed, full, full, trimmed;
  radix2     at n_fft 1024 with 240 filters (its 230 KB table once left the
             register body no room): the register body in its mode from
             the config against the radix-2 body (`_radix2=True`), in
             turns new, radix-2, radix-2, new;
  split_dup  at n_fft = window = 4352 with SPLIT_DUP_COEFFS filters and
             coefficients: route ct's wide body in its mode from the config
             (log-mel mode and the cepstrum kernel) against the CT split's
             (F, T) instantiation (`per_piece_mel=True`), in turns new,
             split-dup, split-dup, new;
  sweep      the fused epilogue (`_cepstrum=False`, where its block fits)
             against log-mel mode and the cepstrum kernel (`_cepstrum=True`)
             over SWEEP_GRID at n_fft 1024, 768 and 4352, in turns fused,
             +cep, +cep, fused;
  alone      the cepstrum kernel alone against its first design
             (`_simt=True`) at ALONE_CASES, on the plain log-mel rows of the
             same audio, in turns wgmma, simt, simt, wgmma, each first held
             to `cepstrum_plain` within FEAT_ATOL / FEAT_RTOL, beside the
             plain version, the kernel's bound (`kernel_bound`) and
             torch.matmul of the rows and the extended table (cuBLAS, TF32
             off: a yardstick the port never calls);
  cuts       where the kernel's time goes at ALONE_CASES: the shipped
             kernel against its cuts (CUTS, csrc/cepstrum_wgmma.cu's
             TSC_CEPW_CUT, each built beside the shipped library), in turns
             in the order listed, then reversed; a cut's output is not the
             function.

Each run is first held to `check_conditioned`: within FEAT_ATOL /
FEAT_RTOL of the float64 features (`exact_features`) plus the slack the
f32 rounding of each filter's power carries through the log and the DCT,
and so is the plain version (the plain chain, or route ct's CT plain
version).  From 80 filters at n_fft 1024 a filter covers one bin; in a
quiet frame that bin's power can be 1e-15 of the frame's, and the log of
its f32 rounding moves a coefficient by up to 0.04 in the plain chain
itself at B = 8192: no two f32 chains hold the bare bound to each other
there.  Each line prints both
layouts' blocks and warps an SM (`fft_plan.fft_layout`), the plain version's
time and the function's bound (`mode_bound`: the real FFT, the packed
filterbank and 2 n_filt (n_mfcc - 1) a frame for the DCT at the f32 peak,
against the kept frames' audio read once and the features written once;
chip_smoke.py's `cepstrum_mode_bound` counts the same).  The last line is a
JSON object of every time.
"""
from __future__ import annotations

import argparse
import functools
import glob
import json
import math
import os

import numpy as np
import torch

from ..data.wav import load_wav
from ..device import resolve_device
from ..frontend.dsp import Frontend, add_deltas, decode_audio, frame_signal
from ..frontend.filterbanks import (LOG_EPS, dct_t_matrix, dft_matrices,
                                    filterbank_matrix)
from ..ops import _build, cepstrum_plan, ct_kernel, fft_plan, frontend_kernel
from ..params import ListenerParams
from . import FEAT_ATOL, FEAT_RTOL, card_line

# (n_filt, n_mfcc) at n_fft 1024: the trim against the whole table, the
# default config first
TRIM_CASES = ((20, 20), (40, 13), (64, 20), (80, 40), (128, 20), (128, 40))
# filters and coefficients at n_fft 4352 (n_filt = n_mfcc)
SPLIT_DUP_COEFFS = (300, 512, 600)
# (n_fft, n_filt, n_mfcc) of the kernel alone: the most coefficients route
# ct's A/B takes, and the 240-filter scorer's
ALONE_CASES = ((4352, 600, 600), (1024, 240, 20))
# the kernel's cuts: name -> TSC_CEPW_CUT (one product a k8 step in place of
# three; no row copies; no stores; all three)
CUTS = {"one_product": 1, "no_row_copies": 2, "no_stores": 3, "all_three": 4}
# n_fft: (n_filt, n_mfcc) pairs of the threshold's sweep
SWEEP_GRID = {
    1024: ((20, 20), (40, 13), (64, 20), (64, 40), (80, 40), (128, 20),
           (128, 40), (128, 64), (128, 128), (240, 20), (256, 64)),
    768: ((230, 20),),
    4352: ((40, 20), (80, 40), (128, 40), (128, 128), (300, 20), (300, 60),
           (300, 120)),
}
PEAK_F32, PEAK_BYTES = 67e12, 3.35e12
# f32-accurate products on the tensor cores: three TF32 products each
PEAK_3XTF32 = 495e12 / 3
EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "example")


@functools.lru_cache(maxsize=4)
def speech_audio(batch: int, n_samples: int, seed: int, dev) -> torch.Tensor:
    """(batch, n_samples) f32 on dev: the eight example/*.wav clips, each
    left-padded or cut to its last n_samples samples, at gains drawn from
    [0.3, 1.5] plus noise of 0.003, from a numpy seed (as chip_smoke.py's
    test audio).  Kept for the next call with the same arguments (a batch
    of 8192 takes seconds on the host); callers only read it."""
    clips = np.stack([np.pad(c[-n_samples:], (n_samples - len(c[-n_samples:]),
                                              0))
                      for c in (load_wav(path, 16000) for path in sorted(
                          glob.glob(os.path.join(EXAMPLES, "*.wav"))))])
    rng = np.random.default_rng(seed)
    rows = clips[np.arange(batch) % len(clips)]
    gains = rng.uniform(0.3, 1.5, (batch, 1)).astype(np.float32)
    noise = 0.003 * rng.standard_normal(rows.shape).astype(np.float32)
    return torch.tensor(np.clip(rows * gains + noise, -1.0, 32767 / 32768),
                        dtype=torch.float32, device=dev)


def config(n_fft: int, n_filt: int, n_mfcc: int) -> ListenerParams:
    """Hop 512; n_fft = window where route ct takes it (n_fft not a power
    of two), else the default window."""
    kw = {} if n_fft & (n_fft - 1) == 0 else {"window_t": n_fft / 16000}
    return ListenerParams(n_fft=n_fft, n_filt=n_filt, n_mfcc=n_mfcc, **kw)


def mode_bound(p: ListenerParams, batch: int) -> tuple[float, str]:
    """(ms, "operations" | "bytes"): the frontend function's least time at
    config p on `batch` windows of f32 audio, the larger of its operations
    (a real FFT of n_fft points, 2.5 n log2 n; 4 a bin; 2 a packed
    filterbank weight: at the f32 peak; 2 n_filt (n_mfcc - 1) for the DCT
    at the 3xTF32 rate, as the cepstrum kernel runs it) and its bytes (the
    kept frames' span of audio read once, the features written once); no
    log-mel round trip."""
    frames = batch * p.n_features
    packed = len(frontend_kernel.pack_filterbank(
        filterbank_matrix(p, "mfcc").T)[0])
    ops = frames * (2.5 * p.n_fft * math.log2(p.n_fft) + 4 * p.n_fft_bins
                    + 2 * packed)
    dct = frames * 2.0 * p.n_filt * (p.n_mfcc - 1)
    span = (p.n_features - 1) * p.hop_samples + min(p.window_samples, p.n_fft)
    nbytes = 4.0 * batch * span + 4.0 * frames * p.feature_size
    ops_ms = (ops / PEAK_F32 + dct / PEAK_3XTF32) * 1e3
    bytes_ms = nbytes / PEAK_BYTES * 1e3
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms
                                   else "bytes")


def kernel_bound(batch: int, n_feat: int, n_filt: int,
                 n_mfcc: int) -> tuple[float, str]:
    """(ms, "operations" | "bytes"): the cepstrum kernel's least time on
    `batch` windows of n_feat frames: 2 n_filt (n_mfcc - 1) operations a
    frame at the 3xTF32 rate, against the (B, T, n_filt + 1) f32 log-mel
    rows read once and the f32 features written once (chip_smoke.py's
    `cepstrum_bound` counts the same)."""
    frames = batch * n_feat
    ops_ms = frames * 2.0 * n_filt * (n_mfcc - 1) / PEAK_3XTF32 * 1e3
    bytes_ms = 4.0 * frames * (n_filt + 1 + n_mfcc) / PEAK_BYTES * 1e3
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms
                                   else "bytes")


# f32's machine epsilon, and the factor on the rounding model in
# `exact_features`' slack: a first-order estimate, not a worst case; at
# 80 and 240 filters (n_fft 1024, B = 8192 speech windows) the plain f32
# chain and an f32 FFT on the CPU need at most 0.45 of it
EPS_F32, SLACK_FACTOR = 2.0 ** -23, 2.0


def _exact_terms(p: ListenerParams, audio: torch.Tensor, gain,
                 feature_type: str, fast_math: bool):
    """(filter sums, frame energies, the f32 rounding's move of each log
    filter sum, the log energy's) in float64 (`exact_features`)."""
    x = decode_audio(audio, gain)
    frames = frame_signal(x, p.window_samples,
                          p.hop_samples)[..., -p.n_features:, :]
    if fast_math:
        # the bf16 frames and DFT matrix the fast_math kernels multiply, then
        # exact sums; f32 accumulation of the window's products moves a
        # bin's amplitude by about 2 eps sqrt(window) of the frame's
        cos, sin = (torch.tensor(m, dtype=torch.float32, device=x.device)
                    .to(torch.bfloat16).double()
                    for m in dft_matrices(p.window_samples, p.n_fft))
        frames = frames.to(torch.bfloat16).double()
        re, im = frames @ cos, frames @ sin
        power = (re ** 2 + im ** 2) / p.n_fft
        del re, im
        step = 2.0 * EPS_F32 * math.sqrt(min(p.window_samples, p.n_fft))
    else:
        spec = torch.fft.rfft(frames.double(), n=p.n_fft)
        power = (spec.real ** 2 + spec.imag ** 2) / p.n_fft
        del spec
        step = 2.0 * EPS_F32 * math.log2(p.n_fft)
    del frames
    filt = torch.tensor(filterbank_matrix(p, feature_type),
                        dtype=torch.float64, device=x.device)
    mel = power @ filt
    total = power.sum(-1, keepdim=True)
    moved = step * torch.sqrt(total / p.n_fft) * (power.sqrt() @ filt)
    d_log = torch.clamp(moved / torch.clamp(mel, min=LOG_EPS), max=72.0)
    return mel, total, d_log, step


def exact_features(p: ListenerParams, audio: torch.Tensor, gain=None,
                   feature_type: str = "mfcc", fast_math: bool = False):
    """(features, slack), float64 on audio's device.  features: the
    frontend's function in float64, from the f32 decoded audio the kernels
    see: the kept frames' rfft of n_fft points (with fast_math: the bf16
    frames times the bf16 DFT matrix), the power, the f32 filterbank and
    DCT tables' values, safe_log, the energy column and the deltas -> (B,
    n_features, feature_size).  slack: how far f32 rounding can move each
    feature.  An f32 FFT moves bin k's power p_k by about 2 eps log2(n_fft)
    sqrt(p_k E / n_fft) (E the frame's power, the transform's error spread
    over its bins; an f32 sum of the window's products, 2 eps sqrt(window)
    in its place), so a filter's log moves by d_m = 2 eps log2(n_fft)
    sqrt(E / n_fft) sum_k w_mk sqrt(p_k) / mel_m (at most the log's range,
    72), coefficient i by sum_m |dct_mi| d_m, the energy by 2 eps
    log2(n_fft); slack is SLACK_FACTOR times that, a delta the sum of its
    two frames'.  Negligible where a filter's power is a fair share of the
    frame's, it is what lets a single-bin filter's power of 1e-15 of the
    frame's move a coefficient by 0.04."""
    mel, total, d_log, step = _exact_terms(p, audio, gain, feature_type,
                                           fast_math)
    dct = torch.tensor(dct_t_matrix(p.n_filt), dtype=torch.float64,
                       device=mel.device)
    logs = torch.log(torch.clamp(mel, min=LOG_EPS))
    energy = torch.log(torch.clamp(total, min=LOG_EPS))
    feats = torch.cat([energy, (logs @ dct)[..., 1:p.n_mfcc]], -1)
    slack = SLACK_FACTOR * torch.cat(
        [torch.full_like(energy, step), (d_log @ dct.abs())[..., 1:p.n_mfcc]],
        -1)
    if p.use_delta:
        feats = add_deltas(feats)
        prev = torch.cat([torch.zeros_like(slack[..., :1, :]),
                          slack[..., :-1, :]], -2)
        first = torch.ones_like(slack)
        first[..., 0, :] = 0.0
        slack = torch.cat([slack, (slack + prev) * first], -1)
    return feats, slack


def exact_logmel(p: ListenerParams, audio: torch.Tensor, gain=None,
                 feature_type: str = "mfcc", fast_math: bool = False):
    """(rows, slack), float64 on audio's device: the (B, n_features, n_filt
    + 1) log-mel rows of log-mel mode (each kept frame's log filter sums,
    then its log energy) computed as `exact_features` computes the
    features, and how far f32 rounding can move each (SLACK_FACTOR times
    d_m, the log energy's 2 eps log2(n_fft))."""
    mel, total, d_log, step = _exact_terms(p, audio, gain, feature_type,
                                           fast_math)
    rows = torch.cat([torch.log(torch.clamp(mel, min=LOG_EPS)),
                      torch.log(torch.clamp(total, min=LOG_EPS))], -1)
    slack = SLACK_FACTOR * torch.cat([d_log, torch.full_like(total, step)],
                                     -1)
    return rows, slack


def check_conditioned(label: str, got: torch.Tensor, plain: torch.Tensor,
                      exact: torch.Tensor, slack: torch.Tensor,
                      atol: float = FEAT_ATOL,
                      rtol: float = FEAT_RTOL) -> float:
    """max|got - plain|; RuntimeError where `got` is not finite, or where
    it or the plain version is further from `exact` (float64) than atol +
    rtol |exact| + slack (`exact_features`): the feature bound, widened
    only where f32 rounding through the log of a filter's small power
    moves any f32 chain."""
    got, plain = got.double(), plain.double()
    if got.shape != exact.shape or plain.shape != exact.shape:
        raise RuntimeError(f"{label}: shapes {tuple(got.shape)}, "
                           f"{tuple(plain.shape)}, {tuple(exact.shape)}")
    if not torch.isfinite(got).all():
        raise RuntimeError(f"{label}: output is not finite")
    bound = atol + rtol * exact.abs() + slack
    for name, t in (("kernel", got), ("plain version", plain)):
        excess = ((t - exact).abs() - bound).max()
        if excess > 0:
            raise RuntimeError(
                f"{label}: the {name} is {float(excess):.2e} past the bound "
                f"(max|{name} - exact| {float((t - exact).abs().max()):.2e})")
    return float((got - plain).abs().max())


def event_ms(fn, iters: int) -> float:
    """ms a call of fn over `iters` calls between two CUDA events, after
    one warm-up call."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


class Route:
    """Config p's kernels on `dev`: `launch(audio, gain, **flags)` through
    its route's wrapper (`mfcc_frontend_cuda` or `ct_frontend_cuda`, the
    A/B flags passed on), `plain(audio)` its plain version, and the
    layouts of its register or wide block."""

    def __init__(self, p: ListenerParams, dev):
        self.p = p
        if frontend_kernel.frontend_route(p) == "ct":
            self.consts = ct_kernel.CtConstants(p, "mfcc", dev)
            self.launch = lambda audio, gain, **kw: ct_kernel.ct_frontend_cuda(
                audio, gain, self.consts, p, **kw)
            self.plain = lambda audio: ct_kernel.ct_frontend_plain(
                audio, None, self.consts, p)
        else:
            self.consts = frontend_kernel.KernelConstants(p, "mfcc", dev)
            chain = Frontend(p, "mfcc", dev)
            self.launch = lambda audio, gain, **kw: \
                frontend_kernel.mfcc_frontend_cuda(audio, gain, self.consts,
                                                   p, **kw)
            self.plain = chain

    def layout(self, **kw) -> str:
        """'<blocks> x <warps> an SM, <bytes> B' of the block with these
        `layout_for` flags ('does not fit' past SMEM_OPTIN)."""
        lay = self.consts.layout_for(self.p, **kw)
        if lay.smem_bytes > fft_plan.SMEM_OPTIN:
            return f"{lay.smem_bytes} B, does not fit"
        return (f"{lay.blocks_per_sm} x {lay.warps} warps an SM, "
                f"{lay.smem_bytes} B")


def in_turns(label: str, runs: dict, plain, exact, iters: int) -> dict:
    """Each run held to its plain version and the float64 features
    (`check_conditioned`), then timed in turns a, b, b, a: name -> [ms,
    ms]."""
    for name, run in runs.items():
        check_conditioned(f"{label} {name}", run(), plain, *exact)
    names = list(runs)
    times = {name: [] for name in names}
    for name in names + names[::-1]:
        times[name].append(event_ms(runs[name], iters))
    return times


def _line(label, times, extra, plain_ms, bound) -> str:
    parts = "; ".join(f"{name} {ms[0]:.4f}, {ms[1]:.4f} ms ({extra[name]})"
                      for name, ms in times.items())
    return (f"{label}: {parts}; plain {plain_ms:.4f} ms; bound "
            f"{bound[0]:.4f} ms ({bound[1]})")


def run_part(part: str, batch: int, iters: int, dev) -> list:
    """The rows of one part: dicts of the config, each run's two times and
    layout, the plain version's time and the bound."""
    gain = torch.ones(1, dtype=torch.float32, device=dev)
    cases = {
        "trim": [(1024, f, m) for f, m in TRIM_CASES],
        "radix2": [(1024, 240, 20)],
        "split_dup": [(4352, n, n) for n in SPLIT_DUP_COEFFS],
        "sweep": [(n, f, m) for n, pairs in SWEEP_GRID.items()
                  for f, m in pairs],
    }[part]
    rows = []
    for n_fft, n_filt, n_mfcc in cases:
        p = config(n_fft, n_filt, n_mfcc)
        r = Route(p, dev)
        audio = speech_audio(batch, p.max_samples, 0, dev)
        own = "+cep" if r.consts.cepstrum else "fused"
        if part == "trim":
            runs = {"trimmed": lambda: r.launch(audio, gain, _cepstrum=False),
                    "full": lambda: r.launch(audio, gain, _cepstrum=False,
                                             _full_dct=True)}
            extra = {"trimmed": r.layout(), "full": r.layout(full_dct=True)}
        elif part == "radix2":
            runs = {f"new ({own})": lambda: r.launch(audio, gain),
                    "radix-2": lambda: r.launch(audio, gain, _radix2=True)}
            extra = {f"new ({own})": r.layout(cepstrum=r.consts.cepstrum),
                     "radix-2": "one warp a frame"}
        elif part == "split_dup":
            rows_dup = ct_kernel.split_rows(p, per_piece_mel=True)
            runs = {f"new ({own})": lambda: r.launch(audio, gain),
                    "split-dup": lambda: r.launch(audio, gain,
                                                  per_piece_mel=True)}
            extra = {f"new ({own})": r.layout(cepstrum=r.consts.cepstrum),
                     "split-dup": f"{rows_dup} rows a block"}
        else:
            runs, extra = {}, {}
            if r.consts.layout_for(p).smem_bytes <= fft_plan.SMEM_OPTIN:
                runs["fused"] = lambda: r.launch(audio, gain, _cepstrum=False)
                extra["fused"] = r.layout()
            runs["+cep"] = lambda: r.launch(audio, gain, _cepstrum=True)
            extra["+cep"] = r.layout(cepstrum=True)
        plain, exact = r.plain(audio), exact_features(p, audio)
        label = (f"{part} n_fft {n_fft} n_filt {n_filt} n_mfcc {n_mfcc} "
                 f"(config: {own})")
        times = in_turns(label, runs, plain, exact, iters)
        del plain, exact
        plain_ms = event_ms(lambda: r.plain(audio), 1)
        bound = mode_bound(p, batch)
        line = _line(label, times, extra, plain_ms, bound)
        row = {"part": part, "n_fft": n_fft, "n_filt": n_filt,
               "n_mfcc": n_mfcc, "config_mode": own, "ms": times,
               "layout": extra, "plain_ms": plain_ms, "bound_ms": bound[0],
               "bound_by": bound[1]}
        if part in ("split_dup", "sweep"):
            # the cepstrum kernel alone, on the plain log-mel rows
            logmel = cepstrum_plan.logmel_plain(Frontend(p, "mfcc", dev),
                                                audio)
            row["cepstrum_alone_ms"] = event_ms(
                lambda: frontend_kernel.cepstrum_cuda(
                    logmel, r.consts.cep_table, p.n_mfcc), iters)
            gflop = 2e-9 * batch * p.n_features * p.n_filt * (p.n_mfcc - 1)
            line += (f"; the cepstrum kernel alone "
                     f"{row['cepstrum_alone_ms']:.4f} ms ({gflop:.1f} GFLOP, "
                     f"{gflop / row['cepstrum_alone_ms']:.1f} TFLOP/s)")
            del logmel
        print(line, flush=True)
        rows.append(row)
        del audio, r
    return rows


def run_alone(batch: int, iters: int, dev) -> list:
    """The kernel alone against its first design at ALONE_CASES (the part
    "alone"): a dict a case of both designs' times in turns, their largest
    distance from the plain version, the plain version's and torch.matmul's
    times and the bound."""
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("the yardstick runs with TF32 off")
    rows = []
    for n_fft, n_filt, n_mfcc in ALONE_CASES:
        p = config(n_fft, n_filt, n_mfcc)
        audio = speech_audio(batch, p.max_samples, 0, dev)
        logmel = cepstrum_plan.logmel_plain(Frontend(p, "mfcc", dev), audio)
        del audio
        tables = cepstrum_plan.cep_tables(dct_t_matrix(n_filt), n_mfcc, dev)
        dct = torch.tensor(dct_t_matrix(n_filt), device=dev)
        ext = tables.ext[:n_filt + 1, :n_mfcc]
        runs = {"wgmma": lambda: frontend_kernel.cepstrum_cuda(
                    logmel, tables, n_mfcc),
                "simt": lambda: frontend_kernel.cepstrum_cuda(
                    logmel, tables, n_mfcc, _simt=True),
                "matmul": lambda: torch.matmul(logmel, ext)}
        want = cepstrum_plan.cepstrum_plain(logmel, dct, n_mfcc)
        label = f"alone n_fft {n_fft} {n_filt} x {n_mfcc}"
        errs = {}
        for name, run in runs.items():
            diff = (run() - want).abs()
            errs[name] = float(diff.max())
            excess = float((diff - FEAT_ATOL - FEAT_RTOL * want.abs()).max())
            if excess > 0:
                raise RuntimeError(f"{label} {name}: {excess:.2e} past the "
                                   f"feature bound")
        del want
        times = {"wgmma": [], "simt": []}
        for name in ("wgmma", "simt", "simt", "wgmma"):
            times[name].append(event_ms(runs[name], iters))
        matmul_ms = event_ms(runs["matmul"], iters)
        plain_ms = event_ms(lambda: cepstrum_plan.cepstrum_plain(
            logmel, dct, n_mfcc), 1)
        bound = kernel_bound(batch, p.n_features, n_filt, n_mfcc)
        gflop = 2e-9 * batch * p.n_features * n_filt * (n_mfcc - 1)
        print(f"{label} ({batch * p.n_features} rows, {gflop:.2f} GFLOP): "
              + "; ".join(f"{name} {ms[0]:.4f}, {ms[1]:.4f} ms "
                          f"({gflop / ms[0]:.1f} TFLOP/s, "
                          f"{ms[0] / bound[0]:.2f}x the bound)"
                          for name, ms in times.items())
              + f"; simt / wgmma {sum(times['simt']) / sum(times['wgmma']):.2f}x"
              f"; torch.matmul (cuBLAS, TF32 off) {matmul_ms:.4f} ms; plain "
              f"{plain_ms:.4f} ms; bound {bound[0]:.4f} ms ({bound[1]}); "
              f"max_abs_err wgmma {errs['wgmma']:.2e}, simt "
              f"{errs['simt']:.2e}", flush=True)
        rows.append({"part": "alone", "n_fft": n_fft, "n_filt": n_filt,
                     "n_mfcc": n_mfcc, "rows": batch * p.n_features,
                     "ms": times, "matmul_ms": matmul_ms,
                     "plain_ms": plain_ms, "bound_ms": bound[0],
                     "bound_by": bound[1], "max_abs_err": errs})
        del logmel, tables, runs
    return rows


def run_cuts(batch: int, iters: int, dev) -> list:
    """The shipped kernel against its cuts at ALONE_CASES (the part
    "cuts"): a dict a case of each variant's two times."""
    from .ct_ablation import build

    logs = {}
    libs = build(dict.fromkeys(CUTS, (_build.CSRC_DIR
                                      / "cepstrum_wgmma.cu").read_text()),
                 "cepstrum", logs,
                 {name: (f"-DTSC_CEPW_CUT={cut}",) for name, cut in CUTS.items()})
    libs["shipped"] = _build.load_library()
    names = ["shipped", *CUTS]
    shipped = _build.load_library
    rows = []
    try:
        for n_fft, n_filt, n_mfcc in ALONE_CASES:
            p = config(n_fft, n_filt, n_mfcc)
            audio = speech_audio(batch, p.max_samples, 0, dev)
            logmel = cepstrum_plan.logmel_plain(Frontend(p, "mfcc", dev),
                                                audio)
            del audio
            tables = cepstrum_plan.cep_tables(dct_t_matrix(n_filt), n_mfcc,
                                              dev)

            def run(name):
                _build.load_library = lambda lib=libs[name]: lib
                return frontend_kernel.cepstrum_cuda(logmel, tables, n_mfcc)

            times = {name: [] for name in names}
            for name in names + names[::-1]:
                times[name].append(event_ms(lambda: run(name), iters))
            print(f"cuts n_fft {n_fft} {n_filt} x {n_mfcc}: " + "; ".join(
                f"{name} {ms[0]:.4f}, {ms[1]:.4f} ms"
                for name, ms in times.items()), flush=True)
            rows.append({"part": "cuts", "n_fft": n_fft, "n_filt": n_filt,
                         "n_mfcc": n_mfcc, "ms": times})
            del logmel, tables
    finally:
        _build.load_library = shipped
    return rows


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=8192)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--parts", nargs="+",
                    choices=("trim", "radix2", "split_dup", "sweep", "alone",
                             "cuts"),
                    default=["trim", "radix2", "split_dup", "sweep", "alone",
                             "cuts"])
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    print(card, flush=True)
    rows = []
    for part in args.parts:
        run = {"alone": run_alone, "cuts": run_cuts}.get(part)
        rows += (run(args.batch, args.iters, dev) if run else
                 run_part(part, args.batch, args.iters, dev))
    print(json.dumps({"cepstrum_ablation": rows, "batch": args.batch,
                      "card": card}), flush=True)
    return rows


if __name__ == "__main__":
    main()
