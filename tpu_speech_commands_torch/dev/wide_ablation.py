#!/usr/bin/env python3
"""What the launch bounds of route ct's wide register FFT
(csrc/wide_fft_frontend_*.cu, csrc/wide_fft.cuh) are worth: each unit as
shipped (each plan's blocks an SM, 2, 3 or 4, from fft_plan.WIDE_PLANS)
and with every plan at 2 (255 registers a thread, 8 warps an SM) and at 4
(128 registers, 16 warps), held to the plain version and timed in turns on
the card (at 3, 168 registers, the shipped unit where a plan asks for 3).

    python -m tpu_speech_commands_torch.dev.wide_ablation [--batch 8192]
        [--iters 20] [--sizes 4352 10240 ...]

Variants (text substitutions in a copy of each unit's plan table):

  two_block_bounds   __launch_bounds__(128, 2) for every plan
  four_block_bounds  __launch_bounds__(128, 4) for every plan

Every run's features are held to `ct_frontend_plain` at FEAT_ATOL /
FEAT_RTOL after its warm-up launch (RuntimeError if one differs).  Times:
CUDA events over `--iters` launches of route ct's kernel on B windows of
f32 audio, gain 1, at n_fft = window = each size (hop 512), the shipped
library and each variant in that order, then reversed.  The `-Xptxas -v`
lines (registers, spills) of each variant's f32 -> f32 kernels are printed.
"""
from __future__ import annotations

import argparse
import re

import torch

from ..device import resolve_device
from ..ops import _build, ct_kernel, fft_plan
from ..params import ListenerParams
from . import card_line, check_features, device_audio
from .ct_ablation import build, inlined_source

# name: the blocks an SM every plan's launch bounds ask for
VARIANTS = {"two_block_bounds": 2, "four_block_bounds": 4}
# the A/B sizes of chip_smoke.py phase 5 and plans that spill at 168 or
# 128 registers (--sizes: WIDE_PLANS' n_fft for the sweep the table is from)
SIZES = (4352, 10240, 15872, 7680, 13824, 15616)
_ROW = re.compile(r"X\((\d+), (\d+), (\d+),")


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


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=8192)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--sizes", type=int, nargs="+", default=list(SIZES))
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    print(card_line(), flush=True)
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

                def launch():
                    return ct_kernel.ct_frontend_cuda(audio, gain, consts, p)

                check_features(f"wide n_fft {n_fft} {name}", launch(), want)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(args.iters):
                    launch()
                end.record()
                end.synchronize()
                times.setdefault((n_fft, name), []).append(
                    start.elapsed_time(end) / args.iters)
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
