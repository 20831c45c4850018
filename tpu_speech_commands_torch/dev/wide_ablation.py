#!/usr/bin/env python3
"""What the launch bounds of the wide register FFT are worth, and, for
route fft's wide body, its other plan at n_fft 8192.

Route ct (`--route ct`, the default; csrc/wide_fft_frontend_*.cu,
csrc/wide_fft.cuh): each unit as shipped (each plan's blocks an SM, 2, 3 or
4, from fft_plan.WIDE_PLANS) and with every plan at 2 (255 registers a
thread, 8 warps an SM) and at 4 (128 registers, 16 warps), held to the
plain version and timed in turns on the card (at 3, 168 registers, the
shipped unit where a plan asks for 3).

Route fft (`--route fft`; csrc/mfcc_wide_frontend.cu, the FFT kernel's wide
body at n_fft 8192 and 16384, fft_plan.FFT_WIDE_PLANS): the unit built with
its plans at 2, 3 and 4 blocks an SM, and with the 8192 plan as V = 32
values a lane on 128 lanes (one frame a block of 4 warps, as shipped) or V
= 64 on 64 lanes (two frames a block: twice the registers, barriers over
two warps), held to the plain chain and timed in turns beside the shipped
library.

    python -m tpu_speech_commands_torch.dev.wide_ablation [--batch 8192]
        [--iters 20] [--sizes 4352 10240 ...]
    python -m tpu_speech_commands_torch.dev.wide_ablation --route fft

Variants (text substitutions in a copy of each unit's plan table):

  two_block_bounds   __launch_bounds__(128, 2) for every plan (route ct)
  four_block_bounds  __launch_bounds__(128, 4) for every plan (route ct)
  v<V>_b<B>          route fft: the 8192 plan at V values a lane, every
                     plan's launch bounds at B blocks an SM (16384 is
                     timed on the V = 64 builds only: its plan is one)

Every run's features are held to its plain version (`ct_frontend_plain`,
route fft's plain chain) at FEAT_ATOL / FEAT_RTOL after its warm-up launch
(RuntimeError if one differs).  Times: CUDA events over `--iters` launches
of the route's kernel on B windows of f32 audio, gain 1, at n_fft = window
= each size (hop 512; route fft's 16384 at window 12800, 7 frames), the
shipped library and each variant in that order, then reversed.  The
`-Xptxas -v` lines (registers, spills) of each variant's f32 -> f32 kernels
are printed.
"""
from __future__ import annotations

import argparse
import copy
import re

import torch

from ..device import resolve_device
from ..frontend.filterbanks import filterbank_matrix
from ..ops import _build, ct_kernel, fft_plan, frontend_kernel
from ..params import ListenerParams
from . import card_line, check_features, device_audio
from .ct_ablation import build, inlined_source

# name: the blocks an SM every plan's launch bounds ask for
VARIANTS = {"two_block_bounds": 2, "four_block_bounds": 4}
# the A/B sizes of chip_smoke.py phase 5 and plans that spill at 168 or
# 128 registers (--sizes: WIDE_PLANS' n_fft for the sweep the table is from)
SIZES = (4352, 10240, 15872, 7680, 13824, 15616)
_ROW = re.compile(r"X\((\d+), (\d+), (\d+),")
# route fft: the 8192 plan's values a lane (32: 128 lanes, the shipped
# plan; 64: 64 lanes) x the launch bounds' blocks an SM, and each size's
# window
FFT_VALUES, FFT_BLOCKS = (32, 64), (2, 3, 4)
FFT_WINDOWS = {8192: 0.512, 16384: 0.8}


def variant_sources(units) -> dict:
    """(variant, unit) -> the unit's source with every plan's blocks set to
    the variant's (its headers inlined); ValueError where a unit's table
    does not read as WIDE_PLANS' rows."""
    out = {}
    for u in units:
        src = inlined_source(f"wide_fft_frontend_{u}.cu")
        rows = _ROW.findall(src)
        if len(rows) != sum(fft_plan.wide_unit(n) == u
                            for n in fft_plan.WIDE_PLANS):
            raise ValueError(f"wide_fft_frontend_{u}.cu: its plan table "
                             "moved")
        for name, blocks in VARIANTS.items():
            out[name, u] = _ROW.sub(rf"X(\1, \2, {blocks},", src)
    return out


def fft_variant_sources() -> dict:
    """"v<V>_b<B>" -> csrc/mfcc_wide_frontend.cu (its header inlined) with
    the 8192 plan at V values a lane and every plan at B blocks an SM;
    ValueError where its table does not read as FFT_WIDE_PLANS' rows."""
    src = inlined_source("mfcc_wide_frontend.cu")
    rows = {2 * int(n): (int(v), int(b))
            for n, v, b in _ROW.findall(src)}
    if rows != {n: (v, b) for n, (v, _, b, _) in
                fft_plan.FFT_WIDE_PLANS.items()}:
        raise ValueError("mfcc_wide_frontend.cu: its plan table moved")
    out = {}
    for values in FFT_VALUES:
        for blocks in FFT_BLOCKS:
            text = _ROW.sub(rf"X(\1, \2, {blocks},", src)
            out[f"v{values}_b{blocks}"] = re.sub(
                r"X\(4096, \d+,", f"X(4096, {values},", text)
    return out


def fft_constants(p: ListenerParams, values: int, dev):
    """Route fft's constants at config `p` with n_fft's plan at `values` a
    lane (its radices, blocks and warps as shipped): a copy of the shipped
    KernelConstants with the plan, the packed filterbank's lanes and the
    layout replaced."""
    consts = frontend_kernel.KernelConstants(p, "mfcc", dev)
    shipped = fft_plan.FFT_WIDE_PLANS[p.n_fft]
    if values == shipped[0]:
        return consts
    other = copy.copy(consts)
    plan = fft_plan.build_plan(p.n_fft, values, *shipped[1:])
    other.stage_register(plan, fft_plan.filterbank_plan(
        filterbank_matrix(p, "mfcc").T, plan.lanes), p, dev)
    return other


def _ptxas(log: str, n: int) -> str:
    """The registers and spills of the f32 -> f32 kernel of plan n (n_fft /
    2) in an nvcc log."""
    lines = log.splitlines()
    for i, line in enumerate(lines):
        if (re.search(rf"register_fft_kernelIffN\S*RegisterPlanILi{n}E", line)
                and "Compiling entry" in line):
            return "; ".join(ln.split(":", 1)[-1].strip()
                             for ln in lines[i + 1:i + 4]
                             if "registers" in ln or "spill" in ln)
    return "not found"


def _time(label: str, launch, want, iters: int) -> float:
    """ms a launch over `iters`, after one held to `want`."""
    check_features(label, launch(), want)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        launch()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def fft_main(args, dev) -> dict:
    """Route fft's sweep: every v<V>_b<B> build of csrc/mfcc_wide_frontend.cu
    beside the shipped library, in turns, at n_fft 8192 and 16384 (16384's
    plan is one in every build: timed on the builds of the shipped V)."""
    logs = {}
    built = build(fft_variant_sources(), "fft_wide", logs)
    for name in built:
        for n_fft in FFT_WINDOWS:
            print(f"fft wide n_fft {n_fft} {name}: "
                  + _ptxas(logs[name], n_fft // 2), flush=True)
    gain = torch.ones(1, dtype=torch.float32, device=dev)
    shipped = _build.load_library
    times = {}
    try:
        for n_fft, window_t in FFT_WINDOWS.items():
            p = ListenerParams(n_fft=n_fft, window_t=window_t)
            audio = device_audio(args.batch, p.max_samples, 0, dev)
            values = fft_plan.FFT_WIDE_PLANS[n_fft][0]
            consts = {v: fft_constants(p, v, dev) for v in FFT_VALUES
                      if n_fft == 8192 or v == values}
            want = frontend_kernel.MfccFrontend(p, "mfcc", dev).plain(audio)
            runs = [("base", shipped(), consts[values])] + [
                (name, lib, consts[int(name[1:].split("_")[0])])
                for name, lib in built.items()
                if int(name[1:].split("_")[0]) in consts]
            for name, lib, c in runs + runs[::-1]:
                _build.load_library = lambda lib=lib: lib
                times.setdefault((n_fft, name), []).append(_time(
                    f"fft wide n_fft {n_fft} {name}",
                    lambda c=c: frontend_kernel.mfcc_frontend_cuda(
                        audio, gain, c, p), want, args.iters))
            del audio, want
    finally:
        _build.load_library = shipped
    for (n_fft, name), ms in times.items():
        print(f"fft wide n_fft {n_fft:5d} {name:8s} "
              + ", ".join(f"{t:.4f}" for t in ms)
              + f" ms  (B = {args.batch}, {card_line()})", flush=True)
    return times


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--route", choices=("ct", "fft"), default="ct")
    ap.add_argument("--batch", type=int, default=8192)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--sizes", type=int, nargs="+", default=list(SIZES))
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    print(card_line(), flush=True)
    if args.route == "fft":
        return fft_main(args, dev)
    units = sorted({fft_plan.wide_unit(n) for n in args.sizes})
    logs = {}
    sources = variant_sources(units)
    built = build({f"{name}_{u}": src for (name, u), src in sources.items()},
                  "wide", logs)
    for n_fft in args.sizes:
        for name in VARIANTS:
            print(f"wide n_fft {n_fft} {name}: "
                  + _ptxas(logs[f"{name}_{fft_plan.wide_unit(n_fft)}"],
                           n_fft // 2), flush=True)
    gain = torch.ones(1, dtype=torch.float32, device=dev)
    shipped = _build.load_library
    times = {}
    try:
        for n_fft in args.sizes:
            p = ListenerParams(n_fft=n_fft, window_t=n_fft / 16000)
            audio = device_audio(args.batch, p.max_samples, 0, dev)
            consts = ct_kernel.CtConstants(p, "mfcc", dev)
            want = ct_kernel.ct_frontend_plain(audio, None, consts, p)
            u = fft_plan.wide_unit(n_fft)
            libs = {"base": shipped(),
                    **{name: built[f"{name}_{u}"] for name in VARIANTS}}
            for name in list(libs) + list(libs)[::-1]:
                _build.load_library = lambda lib=libs[name]: lib
                times.setdefault((n_fft, name), []).append(_time(
                    f"wide n_fft {n_fft} {name}",
                    lambda: ct_kernel.ct_frontend_cuda(audio, gain, consts, p),
                    want, args.iters))
            del audio, want
    finally:
        _build.load_library = shipped
    for (n_fft, name), ms in times.items():
        print(f"wide n_fft {n_fft:5d} {name:18s} "
              + ", ".join(f"{t:.4f}" for t in ms)
              + f" ms  (B = {args.batch}, {card_line()})", flush=True)
    return times


if __name__ == "__main__":
    main()
