#!/usr/bin/env python3
"""Log-mel mode of the register and wide FFT bodies (csrc/register_fft.cuh)
measured apart: its tail against the first one, its stage cuts, the +cep
frontend with each tail, and the fast_math kernel's log-mel mode
(csrc/dft_wgmma.cu) against its fused epilogue, in turns on the card.

    python -m tpu_speech_commands_torch.dev.logmel_ablation [--batch 8192]
        [--iters 20] [--parts alone cuts frontend dft dft_cuts]
        [--tails rows partial_sums]

Parts (B windows of f32 speech audio, `cepstrum_ablation.speech_audio`,
gain 1, hop 512; CASES: n_fft 4352 with 300, 512 and 600 filters and
coefficients on route ct's wide body, n_fft 1024 with 240 filters on route
fft's register body):

  alone     the body's log-mel launch alone (`logmel_launch`,
            no cepstrum kernel), its tail ("rows") against its first tail
            (`_partial_sums=True`) in turns rows, partial_sums,
            partial_sums, rows, device times from CUDA graphs
            (`graph_ms`), beside the same body fused at 20 filters and 20
            coefficients at the same n_fft (the whole fused kernel), the
            body's bound (`logmel_bound`) and the layouts' blocks an SM;
            each tail's rows first held to the float64 rows
            (`cepstrum_ablation.exact_logmel`) at B_CHECK windows, and to
            each other;
  cuts      where the log-mel launch's time goes: each tail cut by
            register_fft.cuh's TSC_LOGMEL_STOP after the power row, the
            filterbank walk and the filter sums' logs (CUTS; dev builds of
            csrc/mfcc_frontend.cu and of 4352's csrc/wide_fft_frontend
            unit, never the shipped library), beside the shipped launch,
            in turns in the order listed, then reversed; a cut's output is
            not the function;
  frontend  the +cep frontend end to end (the body in log-mel mode, then
            the cepstrum kernel) with each tail, in turns, CUDA events,
            beside the plain version and `cepstrum_ablation.mode_bound`;
  dft       the fast_math kernel at DFT_CASES: fused (`_cepstrum=False`)
            against log-mel mode and the cepstrum kernel
            (`_cepstrum=True`), and against log-mel mode's first design
            with the cepstrum kernel (`_shared_sums=True`), in turns, each
            first held to the float64 fast_math features
            (`exact_features(fast_math=True)`), beside `dft_mode_bound`,
            with each mode's windows a block; the log-mel launch alone
            (`dft_logmel_cuda`, CUDA graphs), the mode's design against
            its first design in turns rows, shared_sums, shared_sums,
            rows, each held to the float64 rows, beside the plain rows and
            `dft_logmel_bound`;
  dft_cuts  where the fast_math kernel's log-mel launch spends its time
            (DFT_CUT_CASES): the shipped launch (finished filters stored as
            they stand, logged in one pass over the block's rows after the
            walk) beside dev builds of csrc/dft_wgmma.cu (DFT_VARIANTS,
            TSC_DFT_LOGMEL_FINISH: the owner lane logging where its slot
            releases a filter, with logf or the SFU's __logf, or appending
            it to its warp's ring whose 32 lanes log and store 32 at a
            time, each held to the float64 rows; and two cuts whose output
            is not the function: no log at all, TSC_DFT_CUT=6, and the
            epilogue without its stores and shared-memory adds,
            TSC_DFT_CUT=3), in turns in the order listed, then reversed,
            CUDA graphs.

`--tails` times only the tails named (the parts alone, cuts and frontend;
each run twice where one is named, else in turns).  The last line is a JSON
object of every row.
"""
from __future__ import annotations

import argparse
import json
import math

import torch

from ..device import resolve_device
from ..frontend.dsp import Frontend
from ..frontend.filterbanks import filterbank_matrix
from ..ops import _build, cepstrum_plan, ct_kernel, fft_plan, frontend_kernel
from . import FEAT_ATOL, FEAT_RTOL, card_line, graph_ms
from .cepstrum_ablation import (PEAK_3XTF32, PEAK_BYTES, PEAK_F32,
                                check_conditioned, config, event_ms,
                                exact_features, exact_logmel, mode_bound,
                                speech_audio)
from .ct_ablation import build

# (n_fft, n_filt, n_mfcc): the configs whose log-mel mode is measured
CASES = ((4352, 300, 300), (4352, 512, 512), (4352, 600, 600),
         (1024, 240, 20))
# the fused reference at each n_fft: 20 filters and coefficients
FUSED_REF = (20, 20)
# the windows the rows are checked at (a multiple of no tile)
B_CHECK = 1000
# the tails: name -> `_partial_sums`
TAILS = {"rows": False, "partial_sums": True}
# the cuts: name -> TSC_LOGMEL_STOP (register_fft.cuh's Stop: kPower,
# kMel, kLog), the stage each ends after
CUTS = {"power_row": 3, "walk": 4, "sums_and_logs": 5}
# (n_filt, n_mfcc) of the fast_math kernel's modes at n_fft 1024: where its
# fused block holds 4 windows, as its log-mel block does (32 x 20, 40 x 13,
# 48 x 20, 64 x 20: the sweep `frontend_kernel.DFT_CEP_MIN_PRODUCTS` is
# fitted to), and where it holds fewer (80-512 filters)
DFT_CASES = ((32, 20), (40, 13), (48, 20), (64, 20), (80, 20), (96, 20),
             (128, 20), (160, 20), (240, 20), (400, 20), (512, 20))
# log-mel mode's designs: name -> `_shared_sums`
DFT_DESIGNS = {"rows": False, "shared_sums": True}
# the part dft_cuts: name -> (nvcc -D switches, held to the float64 rows)
DFT_VARIANTS = {
    "logs_at_release": (("-DTSC_DFT_LOGMEL_FINISH=1",), True),
    "sfu_logs_at_release": (("-DTSC_DFT_LOGMEL_FINISH=2",), True),
    "warp_rings": (("-DTSC_DFT_LOGMEL_FINISH=3",), True),
    "no_log": (("-DTSC_DFT_CUT=6",), False),
    "no_stores": (("-DTSC_DFT_CUT=3",), False)}
DFT_CUT_CASES = ((32, 20), (96, 20), (240, 20), (400, 20), (512, 20))
PEAK_BF16 = 989e12


def logmel_bound(p, batch: int) -> tuple[float, str]:
    """(ms, "operations" | "bytes"): the log-mel launch's least time, the
    larger of its operations (a real FFT of n_fft points, 2.5 n log2 n; 4 a
    bin; 2 a packed filterbank weight; at the f32 peak) and its bytes (the
    kept frames' span of audio read once, the (B, T, n_filt + 1) f32 rows
    written once)."""
    frames = batch * p.n_features
    packed = len(frontend_kernel.pack_filterbank(
        filterbank_matrix(p, "mfcc").T)[0])
    ops = frames * (2.5 * p.n_fft * math.log2(p.n_fft) + 4 * p.n_fft_bins
                    + 2 * packed)
    span = (p.n_features - 1) * p.hop_samples + min(p.window_samples, p.n_fft)
    nbytes = 4.0 * batch * span + 4.0 * frames * (p.n_filt + 1)
    ops_ms, bytes_ms = ops / PEAK_F32 * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms
                                   else "bytes")


def dft_mode_bound(p, batch: int) -> tuple[float, str]:
    """(ms, "operations" | "bytes"): the fast_math function's least time:
    the DFT's products over the nonzero columns (2 x window x 2 n_bins a
    frame) at the bf16 peak, the packed filterbank (2 a weight) at the f32
    peak and the DCT (2 n_filt (n_mfcc - 1) a frame) at the 3xTF32 rate,
    against the kept frames' audio read once and the features written
    once."""
    frames = batch * p.n_features
    k = min(p.window_samples, p.n_fft)
    packed = len(frontend_kernel.pack_filterbank(
        filterbank_matrix(p, "mfcc").T)[0])
    ops_ms = (frames * 2.0 * k * 2 * p.n_fft_bins / PEAK_BF16
              + frames * 2.0 * packed / PEAK_F32
              + frames * 2.0 * p.n_filt * (p.n_mfcc - 1) / PEAK_3XTF32) * 1e3
    span = (p.n_features - 1) * p.hop_samples + k
    bytes_ms = (4.0 * batch * span + 4.0 * frames * p.feature_size) \
        / PEAK_BYTES * 1e3
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms
                                   else "bytes")


def dft_logmel_bound(p, batch: int) -> tuple[float, str]:
    """(ms, "operations" | "bytes"): the fast_math kernel's log-mel mode
    alone: `dft_mode_bound` without the DCT, the (B, T, n_filt + 1) f32
    rows written in place of the features."""
    frames = batch * p.n_features
    k = min(p.window_samples, p.n_fft)
    packed = len(frontend_kernel.pack_filterbank(
        filterbank_matrix(p, "mfcc").T)[0])
    ops_ms = (frames * 2.0 * k * 2 * p.n_fft_bins / PEAK_BF16
              + frames * 2.0 * packed / PEAK_F32) * 1e3
    span = (p.n_features - 1) * p.hop_samples + k
    bytes_ms = (4.0 * batch * span + 4.0 * frames * (p.n_filt + 1)) \
        / PEAK_BYTES * 1e3
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms
                                   else "bytes")


def constants(p, dev):
    """Config p's register or wide body constants (route ct or fft)."""
    if frontend_kernel.frontend_route(p) == "ct":
        return ct_kernel.CtConstants(p, "mfcc", dev)
    return frontend_kernel.KernelConstants(p, "mfcc", dev)


def frontend_launch(p, consts):
    """fn(audio, gain, **flags) -> features: config p's route wrapper."""
    if isinstance(consts, ct_kernel.CtConstants):
        return lambda audio, gain, **kw: ct_kernel.ct_frontend_cuda(
            audio, gain, consts, p, **kw)
    return lambda audio, gain, **kw: frontend_kernel.mfcc_frontend_cuda(
        audio, gain, consts, p, **kw)


def logmel_launch(p, consts):
    """fn(audio, gain, **flags) -> rows: config p's route's log-mel mode
    alone (`ct_kernel.ct_logmel_cuda`, `frontend_kernel.fft_logmel_cuda`)."""
    launch = (ct_kernel.ct_logmel_cuda
              if isinstance(consts, ct_kernel.CtConstants)
              else frontend_kernel.fft_logmel_cuda)
    return lambda audio, gain, **kw: launch(audio, gain, consts, p, **kw)


def layout_line(consts, p, **kw) -> str:
    lay = consts.layout_for(p, **kw)
    return (f"{lay.blocks_per_sm} x {lay.warps} warps an SM, "
            f"{lay.smem_bytes} B")


def check_tails(p, consts, dev) -> dict:
    """Each tail's rows at B_CHECK windows held to the float64 rows within
    FEAT_ATOL / FEAT_RTOL plus the rounding slack (`check_conditioned`,
    the plain rows too); the tails' largest distance from the plain rows
    and from each other."""
    audio = speech_audio(B_CHECK, p.max_samples, 1, dev)
    gain = torch.ones(1, dtype=torch.float32, device=dev)
    plain = cepstrum_plan.logmel_plain(Frontend(p, "mfcc", dev), audio)
    exact = exact_logmel(p, audio)
    launch = logmel_launch(p, consts)
    rows = {name: launch(audio, gain, _partial_sums=flag)
            for name, flag in TAILS.items()}
    label = f"log-mel rows n_fft {p.n_fft} {p.n_filt} x {p.n_mfcc}"
    errs = {name: check_conditioned(f"{label} {name}", got, plain, *exact)
            for name, got in rows.items()}
    errs["between_tails"] = float((rows["rows"] - rows["partial_sums"])
                                  .abs().max())
    return errs


def _turns(names: list) -> list:
    """The order of an A/B in turns, a, b, b, a (one name: twice)."""
    return names + names[::-1] if len(names) > 1 else names * 2


def run_alone(batch: int, iters: int, dev, tails=tuple(TAILS)) -> list:
    """The part "alone": a dict a case."""
    gain = torch.ones(1, dtype=torch.float32, device=dev)
    out = []
    for n_fft, n_filt, n_mfcc in CASES:
        p = config(n_fft, n_filt, n_mfcc)
        consts = constants(p, dev)
        errs = check_tails(p, consts, dev)
        p20 = config(n_fft, *FUSED_REF)
        c20 = constants(p20, dev)
        if c20.cepstrum or c20.body != consts.body:
            raise AssertionError(f"the {FUSED_REF} reference at {n_fft} is "
                                 f"not the {consts.body} body fused")
        audio = speech_audio(batch, p.max_samples, 0, dev)
        fused = frontend_launch(p20, c20)
        launch = logmel_launch(p, consts)
        runs = {name: (lambda flag=TAILS[name]: launch(
                    audio, gain, _partial_sums=flag))
                for name in tails}
        times = {name: [] for name in runs}
        for name in _turns(list(runs)):
            times[name].append(graph_ms(runs[name], iters))
        fused_ms = graph_ms(lambda: fused(audio, gain), iters)
        plain_ms = event_ms(lambda: cepstrum_plan.logmel_plain(
            Frontend(p, "mfcc", dev), audio), 1)
        bound = logmel_bound(p, batch)
        layouts = {"rows": layout_line(consts, p, cepstrum=True),
                   "partial_sums": layout_line(consts, p, cepstrum=True,
                                               partial_sums=True),
                   "fused_20": layout_line(c20, p20)}
        print(f"alone n_fft {n_fft} {n_filt} x {n_mfcc} ({consts.body}): "
              + "; ".join(f"{name} {ms[0]:.4f}, {ms[1]:.4f} ms "
                          f"({ms[0] / bound[0]:.2f}x the bound; "
                          f"{layouts[name]})" for name, ms in times.items())
              + (f"; partial_sums / rows "
                 f"{sum(times['partial_sums']) / sum(times['rows']):.3f}x"
                 if len(times) > 1 else "")
              + f"; fused at {FUSED_REF[0]} x {FUSED_REF[1]} {fused_ms:.4f} ms "
              f"({layouts['fused_20']}); plain {plain_ms:.4f} ms; bound "
              f"{bound[0]:.4f} ms ({bound[1]}); max_abs_err {errs}",
              flush=True)
        out.append({"part": "alone", "n_fft": n_fft, "n_filt": n_filt,
                    "n_mfcc": n_mfcc, "body": consts.body, "ms": times,
                    "fused_20_ms": fused_ms, "plain_ms": plain_ms,
                    "bound_ms": bound[0], "bound_by": bound[1],
                    "layout": layouts, "max_abs_err": errs})
        del audio, runs, consts, c20
    return out


def cut_sources() -> tuple[dict, dict]:
    """(name -> source, name -> nvcc flags) of the cut builds: csrc/
    mfcc_frontend.cu (n_fft 1024's register body) and 4352's wide unit,
    each at every TSC_LOGMEL_STOP of CUTS."""
    units = {"fft": "mfcc_frontend.cu",
             "ct": f"wide_fft_frontend_{fft_plan.wide_unit(4352)}.cu"}
    sources, flags = {}, {}
    for route, unit in units.items():
        text = (_build.CSRC_DIR / unit).read_text()
        for cut, stop in CUTS.items():
            sources[f"{route}_{cut}"] = text
            flags[f"{route}_{cut}"] = (f"-DTSC_LOGMEL_STOP={stop}",)
    return sources, flags


def run_cuts(batch: int, iters: int, dev, tails=tuple(TAILS)) -> list:
    """The part "cuts": a dict a case and tail of each variant's times."""
    sources, flags = cut_sources()
    logs = {}
    libs = build(sources, "logmel", logs, flags)
    shipped = _build.load_library
    gain = torch.ones(1, dtype=torch.float32, device=dev)
    out = []
    try:
        for n_fft, n_filt, n_mfcc in CASES:
            p = config(n_fft, n_filt, n_mfcc)
            consts = constants(p, dev)
            route = "ct" if isinstance(consts, ct_kernel.CtConstants) else "fft"
            launch = logmel_launch(p, consts)
            audio = speech_audio(batch, p.max_samples, 0, dev)
            names = ["shipped", *CUTS]
            for tail in tails:
                def run(name, flag=TAILS[tail]):
                    lib = shipped() if name == "shipped" else \
                        libs[f"{route}_{name}"]
                    _build.load_library = lambda lib=lib: lib
                    return launch(audio, gain, _partial_sums=flag)

                times = {name: [] for name in names}
                for name in names + names[::-1]:
                    times[name].append(graph_ms(lambda n=name: run(n), iters))
                    _build.load_library = shipped
                print(f"cuts n_fft {n_fft} {n_filt} x {n_mfcc} {tail}: "
                      + "; ".join(f"{name} {ms[0]:.4f}, {ms[1]:.4f} ms"
                                  for name, ms in times.items()), flush=True)
                out.append({"part": "cuts", "n_fft": n_fft, "n_filt": n_filt,
                            "n_mfcc": n_mfcc, "tail": tail, "ms": times})
            del audio, consts
    finally:
        _build.load_library = shipped
    for name, log in logs.items():
        spills = [ln.strip() for ln in log.splitlines()
                  if "spill" in ln and "0 bytes spill" not in ln]
        if spills:
            print(f"cut build {name}: {spills[:4]}", flush=True)
    return out


def run_frontend(batch: int, iters: int, dev, tails=tuple(TAILS),
                 cases=CASES) -> list:
    """The part "frontend": the +cep frontend with each tail, in turns, at
    `cases` ((n_fft, n_filt, n_mfcc))."""
    gain = torch.ones(1, dtype=torch.float32, device=dev)
    out = []
    for n_fft, n_filt, n_mfcc in cases:
        p = config(n_fft, n_filt, n_mfcc)
        consts = constants(p, dev)
        if not consts.cepstrum:
            raise AssertionError(f"{n_fft} x {n_filt} x {n_mfcc} is not +cep")
        launch = frontend_launch(p, consts)
        audio = speech_audio(batch, p.max_samples, 0, dev)
        runs = {name: (lambda flag=TAILS[name]: launch(audio, gain,
                                                        _partial_sums=flag))
                for name in tails}
        times = {name: [] for name in runs}
        for name in _turns(list(runs)):
            times[name].append(event_ms(runs[name], iters))
        plain = (Frontend(p, "mfcc", dev) if isinstance(
            consts, frontend_kernel.KernelConstants) else
            (lambda a: ct_kernel.ct_frontend_plain(a, None, consts, p)))
        plain_ms = event_ms(lambda: plain(audio), 1)
        bound = mode_bound(p, batch)
        print(f"frontend +cep n_fft {n_fft} {n_filt} x {n_mfcc}: "
              + "; ".join(f"{name} {ms[0]:.4f}, {ms[1]:.4f} ms"
                          for name, ms in times.items())
              + f"; plain {plain_ms:.4f} ms; bound {bound[0]:.4f} ms "
              f"({bound[1]})", flush=True)
        out.append({"part": "frontend", "n_fft": n_fft, "n_filt": n_filt,
                    "n_mfcc": n_mfcc, "ms": times, "plain_ms": plain_ms,
                    "bound_ms": bound[0], "bound_by": bound[1]})
        del audio, consts, runs
    return out


def run_dft(batch: int, iters: int, dev, tails=(), cases=DFT_CASES) -> list:
    """The part "dft": the fast_math kernel fused against log-mel mode (in
    either design), and log-mel mode's launch alone in either design, at
    `cases` ((n_filt, n_mfcc) at n_fft 1024)."""
    gain = torch.ones(1, dtype=torch.float32, device=dev)
    out = []
    for n_filt, n_mfcc in cases:
        p = config(1024, n_filt, n_mfcc)
        consts = frontend_kernel.DftConstants(p, "mfcc", dev)
        # mode name -> (_cepstrum, _shared_sums)
        modes = {"fused": (False, False), "+cep": (True, False),
                 "+cep_shared_sums": (True, True)}
        layouts = {"fused": consts.layouts[False],
                   "+cep": consts.layouts[True],
                   "+cep_shared_sums": consts.shared_sums_layout}
        runs = {}
        for name, (cep, shared) in modes.items():
            if layouts[name].smem_bytes <= frontend_kernel.DFT_SMEM_MAX:
                runs[name] = (lambda a, cep=cep, shared=shared:
                              frontend_kernel.dft_frontend_bf16_cuda(
                                  a, gain, consts, p, _cepstrum=cep,
                                  _shared_sums=shared))
        alone = {name: (lambda a, flag=flag: frontend_kernel.dft_logmel_cuda(
            a, gain, consts, p, _shared_sums=flag))
            for name, flag in DFT_DESIGNS.items()}
        check = speech_audio(B_CHECK, p.max_samples, 1, dev)
        plain = Frontend(p, "mfcc", dev, fast_math=True)(check)
        exact = exact_features(p, check, fast_math=True)
        label = f"fast_math 1024 {n_filt} x {n_mfcc}"
        errs = {name: check_conditioned(f"{label} {name}", run(check), plain,
                                        *exact, FEAT_ATOL, FEAT_RTOL)
                for name, run in runs.items()}
        fm_chain = Frontend(p, "mfcc", dev, fast_math=True)
        plain_rows = cepstrum_plan.logmel_plain(fm_chain, check)
        exact_rows = exact_logmel(p, check, fast_math=True)
        for name, run in alone.items():
            errs[f"logmel_{name}"] = check_conditioned(
                f"{label} log-mel rows ({name})", run(check), plain_rows,
                *exact_rows)
        del check, plain, exact, plain_rows, exact_rows
        audio = speech_audio(batch, p.max_samples, 0, dev)
        names = list(runs)
        times = {name: [] for name in names}
        for name in names + names[::-1]:
            times[name].append(event_ms(lambda n=name: runs[n](audio), iters))
        rows_ms = {name: [] for name in alone}
        for name in _turns(list(alone)):
            rows_ms[name].append(graph_ms(lambda n=name: alone[n](audio),
                                          iters))
        rows_plain_ms = event_ms(lambda: cepstrum_plan.logmel_plain(
            fm_chain, audio), 1)
        bound = dft_mode_bound(p, batch)
        rows_bound = dft_logmel_bound(p, batch)
        own = "+cep" if consts.cepstrum else "fused"
        wpb = {name: layouts[name].wpb for name in names}
        print(f"{label} (config: {own}): " + "; ".join(
            f"{name} {ms[0]:.4f}, {ms[1]:.4f} ms ({wpb[name]} windows a "
            f"block)" for name, ms in times.items())
            + f"; bound {bound[0]:.4f} ms ({bound[1]}); log-mel mode alone "
            + ", ".join(f"{name} {ms[0]:.4f}, {ms[1]:.4f}"
                        for name, ms in rows_ms.items())
            + f" ms (device times; plain {rows_plain_ms:.4f} ms, bound "
            f"{rows_bound[0]:.4f} ms, {rows_bound[1]}); max_abs_err {errs}",
            flush=True)
        out.append({"part": "dft", "n_fft": 1024, "n_filt": n_filt,
                    "n_mfcc": n_mfcc, "config_mode": own, "ms": times,
                    "windows_per_block": wpb, "bound_ms": bound[0],
                    "bound_by": bound[1], "logmel_ms": rows_ms["rows"][0],
                    "logmel_shared_sums_ms": rows_ms["shared_sums"][0],
                    "logmel_turns": rows_ms,
                    "logmel_plain_ms": rows_plain_ms,
                    "logmel_bound_ms": rows_bound[0],
                    "logmel_bound_by": rows_bound[1], "max_abs_err": errs})
        del audio, consts, runs, alone
    return out


def run_dft_cuts(batch: int, iters: int, dev, tails=(),
                 cases=DFT_CUT_CASES) -> list:
    """The part "dft_cuts": the log-mel launch alone, shipped and in each
    dev build of DFT_VARIANTS, at `cases` ((n_filt, n_mfcc) at n_fft
    1024)."""
    source = (_build.CSRC_DIR / "dft_wgmma.cu").read_text()
    logs = {}
    libs = build({name: source for name in DFT_VARIANTS}, "dft_logmel", logs,
                 {name: flags for name, (flags, _) in DFT_VARIANTS.items()})
    for name, log in logs.items():
        spills = [ln.strip() for ln in log.splitlines()
                  if "spill" in ln and "0 bytes spill" not in ln]
        if spills:
            print(f"dft cut build {name}: {spills[:4]}", flush=True)
    shipped = _build.load_library
    gain = torch.ones(1, dtype=torch.float32, device=dev)
    out = []
    try:
        for n_filt, n_mfcc in cases:
            p = config(1024, n_filt, n_mfcc)
            consts = frontend_kernel.DftConstants(p, "mfcc", dev)

            def run(name, audio):
                lib = shipped() if name == "shipped" else libs[name]
                _build.load_library = lambda lib=lib: lib
                try:
                    return frontend_kernel.dft_logmel_cuda(audio, gain,
                                                           consts, p)
                finally:
                    _build.load_library = shipped

            check = speech_audio(B_CHECK, p.max_samples, 1, dev)
            fm_chain = Frontend(p, "mfcc", dev, fast_math=True)
            plain = cepstrum_plan.logmel_plain(fm_chain, check)
            exact = exact_logmel(p, check, fast_math=True)
            errs = {name: check_conditioned(
                f"fast_math 1024 {n_filt} x {n_mfcc} log-mel rows {name}",
                run(name, check), plain, *exact)
                for name in ["shipped", *DFT_VARIANTS]
                if name == "shipped" or DFT_VARIANTS[name][1]}
            del check, plain, exact
            audio = speech_audio(batch, p.max_samples, 0, dev)
            names = ["shipped", *DFT_VARIANTS]
            times = {name: [] for name in names}
            for name in names + names[::-1]:
                times[name].append(graph_ms(lambda n=name: run(n, audio),
                                            iters))
            print(f"dft cuts 1024 {n_filt} x {n_mfcc}: "
                  + "; ".join(f"{name} {ms[0]:.4f}, {ms[1]:.4f} ms"
                              for name, ms in times.items())
                  + f" (device times); max_abs_err {errs}", flush=True)
            out.append({"part": "dft_cuts", "n_fft": 1024, "n_filt": n_filt,
                        "n_mfcc": n_mfcc, "ms": times, "max_abs_err": errs})
            del audio, consts
    finally:
        _build.load_library = shipped
    return out


PARTS = {"alone": run_alone, "cuts": run_cuts, "frontend": run_frontend,
         "dft": run_dft, "dft_cuts": run_dft_cuts}


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=8192)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--parts", nargs="+", choices=tuple(PARTS),
                    default=list(PARTS))
    ap.add_argument("--tails", nargs="+", choices=tuple(TAILS),
                    default=list(TAILS))
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    print(card, flush=True)
    rows = []
    for part in args.parts:
        rows += PARTS[part](args.batch, args.iters, dev, tuple(args.tails))
    print(json.dumps({"logmel_ablation": rows, "batch": args.batch,
                      "card": card}), flush=True)
    return rows


if __name__ == "__main__":
    main()
