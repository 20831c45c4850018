#!/usr/bin/env python3
"""What the design choices of the fast_math frontend's wgmma kernel
(csrc/dft_wgmma.cu) are worth: the kernel with one choice undone at a time,
each chosen at compile time by a -D switch, built beside the shipped
library, held to the plain version and timed in turns on the card.

    python -m tpu_speech_commands_torch.dev.dft_ablation [--batch 8192]
        [--iters 20] [--variants base,ring_2,...] [--configs]

Variants:

  base             the shipped kernel
  multicast        clusters of two blocks sharing each B stage by TMA
                   multicast (TSC_DFT_CLUSTER=2): half the L2 stream, the
                   pair coupled stage by stage
  ring_3, ring_2   a ring of 3 or 2 B stages, not 5 (TSC_DFT_STAGES)
  power_tile       the epilogue through a shared power tile and the packed
                   filterbank, one thread a (row, filter), as the first
                   design does (TSC_DFT_POWER_TILE; the tile leaves room for
                   3 stages: compare with ring_3)
  serial_epilogue  both warpgroups meet at a barrier after each chunk's
                   epilogue, so no epilogue overlaps the other's products
  early_release    each stage released right after its own products, none
                   in flight across it (TSC_DFT_EARLY_RELEASE)
  b_stream         a cut: the B stream alone (no audio staging, products,
                   epilogue or store), the ring's own floor
  no_epilogue      a cut: no epilogue; ptxas then drops the products too
                   (their accumulators are never read), so this measures the
                   staging, the B stream and the tail
  no_smem_adds     a cut: the epilogue without its shared-memory adds (the
                   filter sums are formed and dropped)
  staging_only     a cut: the audio staging and the tail, no products
  no_staging       a cut: everything but the audio staging
  multicast_b_stream  the B-stream cut of the multicast variant
  mma_sync         csrc/dft_frontend.cu, the first design (mma.sync, a
                   2-stage cp.async ring, a power tile), the A/B baseline

Every variant but the cuts is held to the plain version (`Frontend(
fast_math=True)`) at FEAT_ATOL / FEAT_RTOL after its warm-up launch
(RuntimeError if one differs); a cut's output is not the function.  With
--configs the base variant (with --configs all, every variant held to
it) is first held to it at the six configs of tests/test_torch_fast_math.py,
f32 and int16 in, f32 and bf16 out, at B 1, 13 and 1000.  Times: CUDA events over `--iters` launches at the default
config on B windows of f32 audio, gain 1, every variant in the order
listed, then reversed.  nvcc's -Xptxas -v lines of each variant are
printed first.
"""
from __future__ import annotations

import argparse
import re
import time

import numpy as np
import torch

from ..device import resolve_device
from ..ops import _build, frontend_kernel
from ..ops.frontend_kernel import DftConstants, MfccFrontend
from ..params import ListenerParams
from . import FEAT_ATOL, FEAT_RTOL, card_line, check_features, device_audio
from .ct_ablation import build

BF16_STEP = 2.0 ** -7
# name: (source in csrc/, nvcc -D switches, held to the plain version)
VARIANTS = {
    "base": ("dft_wgmma.cu", (), True),
    "multicast": ("dft_wgmma.cu", ("-DTSC_DFT_CLUSTER=2",), True),
    "ring_3": ("dft_wgmma.cu", ("-DTSC_DFT_STAGES=3",), True),
    "ring_2": ("dft_wgmma.cu", ("-DTSC_DFT_STAGES=2",), True),
    "power_tile": ("dft_wgmma.cu", ("-DTSC_DFT_POWER_TILE=1",), True),
    "serial_epilogue": ("dft_wgmma.cu", ("-DTSC_DFT_SERIAL_EPILOGUE=1",), True),
    "early_release": ("dft_wgmma.cu", ("-DTSC_DFT_EARLY_RELEASE=1",), True),
    "b_stream": ("dft_wgmma.cu", ("-DTSC_DFT_CUT=1",), False),
    "no_epilogue": ("dft_wgmma.cu", ("-DTSC_DFT_CUT=2",), False),
    "no_smem_adds": ("dft_wgmma.cu", ("-DTSC_DFT_CUT=3",), False),
    "staging_only": ("dft_wgmma.cu", ("-DTSC_DFT_CUT=4",), False),
    "no_staging": ("dft_wgmma.cu", ("-DTSC_DFT_CUT=5",), False),
    "multicast_b_stream": ("dft_wgmma.cu", ("-DTSC_DFT_CLUSTER=2", "-DTSC_DFT_CUT=1"),
                           False),
    "mma_sync": ("dft_frontend.cu", (), True),
}
# the configs of tests/test_torch_fast_math.py: (ListenerParams kwargs,
# feature type)
CONFIGS = {
    "mfcc": ({}, "mfcc"),
    "bark": ({}, "bark"),
    "use_delta": ({"use_delta": True}, "mfcc"),
    "window_t=0.05": ({"window_t": 0.05}, "mfcc"),
    "odd_hop": ({"hop_t": 0.03}, "mfcc"),
    "alt_512": ({"window_t": 0.025, "hop_t": 0.01, "n_fft": 512,
                 "n_filt": 26, "n_mfcc": 13}, "mfcc"),
}


def launcher(name: str, consts: DftConstants, p: ListenerParams,
             out_dtype=torch.float32):
    """fn(audio, gain) -> features through variant `name`'s entry point
    (the library in use is the variant's)."""
    return lambda audio, gain: frontend_kernel.dft_frontend_bf16_cuda(
        audio, gain, consts, p, out_dtype, _mma_sync=name == "mma_sync")


def check_configs(name: str, dev) -> float:
    """Variant `name` against the plain version at every config, dtype pair
    and batch of the module docstring; the largest f32 error."""
    rng = np.random.default_rng(5)
    worst = 0.0
    for label, (kw, feature_type) in CONFIGS.items():
        p = ListenerParams(**kw)
        consts = DftConstants(p, feature_type, dev)
        plain = MfccFrontend(p, feature_type, dev, fast_math=True).plain
        gain = torch.full((1,), 0.8, dtype=torch.float32, device=dev)
        for batch in (1, 13, 1000):
            x = 0.3 * rng.standard_normal((batch, 16000)).astype(np.float32)
            for in_dtype in ("float32", "int16"):
                a = x if in_dtype == "float32" else np.clip(
                    np.round(x * 32768), -32768, 32767).astype(np.int16)
                audio = torch.tensor(a, device=dev)
                want = plain(audio, gain)
                for out_dtype in (torch.float32, torch.bfloat16):
                    got = launcher(name, consts, p, out_dtype)(audio, gain)
                    bf16 = BF16_STEP if out_dtype == torch.bfloat16 else 0.0
                    err = check_features(
                        f"{name} {label} B {batch} {in_dtype} -> "
                        f"{str(out_dtype)[6:]}", got, want.to(out_dtype),
                        FEAT_ATOL, FEAT_RTOL + bf16)
                    if out_dtype == torch.float32:
                        worst = max(worst, err)
    return worst


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=8192)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--configs", nargs="?", const="base", default=None,
                    help="hold base (or with 'all', every variant) to the "
                    "plain version at every config first")
    args = ap.parse_args(argv)
    names = args.variants.split(",")
    dev = resolve_device("cuda")
    card = card_line()
    print(card, flush=True)
    logs = {}
    t0 = time.perf_counter()
    libs = build({n: (_build.CSRC_DIR / VARIANTS[n][0]).read_text()
                  for n in names}, "dft", logs,
                 {n: VARIANTS[n][1] for n in names})
    print(f"  built {len(libs)} variants in {time.perf_counter() - t0:.1f} s",
          flush=True)
    for name in names:
        notes, seen = {}, set()
        for line in logs[name].splitlines():
            if ("registers" in line or "spill" in line) and line not in seen:
                seen.add(line)  # each distinct line once
                print(f"  {name}: {line.strip()}", flush=True)
            code = re.search(r"\((C\d+)\) ([^']*)", line)
            if code:  # ptxas's notes on wgmma and setmaxnreg, once each
                notes.setdefault(code.group(1), [0, code.group(2)])[0] += 1
        for code, (count, text) in notes.items():
            print(f"  {name}: {count} x ({code}) {text.strip()}", flush=True)
    p = ListenerParams()
    consts = DftConstants(p, "mfcc", dev)
    audio = device_audio(args.batch, p.max_samples, 0, dev)
    gain = torch.ones(1, dtype=torch.float32, device=dev)
    want = MfccFrontend(p, "mfcc", dev, fast_math=True).plain(audio, gain)
    shipped = _build.load_library
    times = {}
    try:
        for name in names:
            _build.load_library = lambda lib=libs[name]: lib
            if args.configs and name == "base" or args.configs == "all" and \
                    VARIANTS[name][2]:
                err = check_configs(name, dev)
                print(f"  {name}: every config, dtype and batch within the "
                      f"bound of the plain version (f32 max|delta| "
                      f"{err:.2e})", flush=True)
        for name in names + names[::-1]:
            _build.load_library = lambda lib=libs[name]: lib
            run = launcher(name, consts, p)
            got = run(audio, gain)  # warm-up
            if VARIANTS[name][2]:
                check_features(f"{name} B {args.batch}", got, want)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(args.iters):
                run(audio, gain)
            end.record()
            end.synchronize()
            times.setdefault(name, []).append(start.elapsed_time(end) / args.iters)
    finally:
        _build.load_library = shipped
    for name, ms in times.items():
        held = "held to plain" if VARIANTS[name][2] else "a cut"
        print(f"dft_frontend {name:16s} " + ", ".join(f"{t:.4f}" for t in ms)
              + f" ms ({held}; B = {args.batch}, default config, {card})",
              flush=True)
    return times


if __name__ == "__main__":
    main()
