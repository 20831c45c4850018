#!/usr/bin/env python3
"""What the design choices of route ct's mixed-radix register FFT
(csrc/mixed_fft_frontend.cu, with csrc/register_fft.cuh inlined) are worth:
the kernel with one choice undone at a time, each built beside the shipped
library, held to the plain version and timed in turns on the card.

    python -m tpu_speech_commands_torch.dev.mixed_ablation [--batch 8192]
        [--iters 20] [--sweep]

Variants (text substitutions in a copy of the source):

  one_block_bounds  __launch_bounds__ of one block an SM for every plan (255
                    registers a thread, no spills)
  two_block_bounds  of two blocks an SM for every plan (128 registers)
  linear_exchange   no XOR swizzle in the exchanges between passes (only
                    the bank conflicts change)
  warps=W           the shipped library with W warps a block, not the
                    plan's (fft_plan.MIXED_PLANS)

Every run's features are held to `ct_frontend_plain` at FEAT_ATOL /
FEAT_RTOL after its warm-up launch (RuntimeError if one differs).  Times:
CUDA events over `--iters` launches of route ct's kernel on B
windows of f32 audio, gain 1, every run in the order listed, then reversed:
at n_fft = window = 768 and 3840 (hop 512) and 1536 and 2816 (hop 256), the
shipped kernel, each variant at the shipped block size and the shipped
library at the other block sizes; with --sweep, at every n_fft of the plan
(hop 512), both launch bounds at 2, 4 and 8 warps a block.
"""
from __future__ import annotations

import argparse

import torch

from ..device import resolve_device
from ..ops import _build, ct_kernel, fft_plan
from ..params import ListenerParams
from . import card_line, check_features, device_audio
from .ct_ablation import build, inlined_source

_BOUNDS = "static constexpr int kMinBlocks = B_;"
VARIANTS = {  # name: (text, replacement, how often the text occurs)
    "one_block_bounds": (_BOUNDS, "static constexpr int kMinBlocks = 1;", 1),
    "two_block_bounds": (_BOUNDS, "static constexpr int kMinBlocks = 2;", 1),
    "linear_exchange": ("return i ^ ((i >> 4) & 15);", "return i;", 1),
}
CONFIGS = {768: 0.032, 1536: 0.016, 2816: 0.016, 3840: 0.032}  # n_fft: hop_t
WARPS = (2, 4, 8)


def variant_sources() -> dict:
    """name -> the kernel source with that variant ("base": as shipped);
    ValueError if a variant's text is not in the source as often as it
    should be."""
    src = inlined_source("mixed_fft_frontend.cu")
    out = {"base": src}
    for name, (old, new, count) in VARIANTS.items():
        if src.count(old) != count:
            raise ValueError(f"variant {name}: its text is not in "
                             f"mixed_fft_frontend.cu {count} times")
        out[name] = src.replace(old, new)
    return out


def _runs(consts, p, sweep: bool):
    """(label, library name, layout) of each run at config `p`."""
    def layout(w):
        lay = fft_plan.fft_layout(consts.plan, consts.fb, p.n_filt, p.n_mfcc,
                                  p.n_features, w)
        return lay if lay.warps == w else None

    chosen = consts.layout
    if sweep:
        return [(f"{lib} warps={w}", lib, layout(w))
                for lib in ("one_block_bounds", "two_block_bounds")
                for w in WARPS if layout(w)]
    return ([(f"base, {chosen.warps} warps", "base", chosen)]
            + [(name, name, chosen) for name in VARIANTS]
            + [(f"warps={w}", "base", layout(w)) for w in WARPS
               if w != chosen.warps and layout(w)])


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=8192)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--sweep", action="store_true")
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    print(card_line(), flush=True)
    libs = build(variant_sources(), "mixed")
    gain = torch.ones(1, dtype=torch.float32, device=dev)
    configs = (dict.fromkeys(sorted(fft_plan.MIXED_PLANS), 0.032) if args.sweep
               else CONFIGS)
    shipped = _build.load_library
    times = {}
    try:
        for n_fft, hop_t in configs.items():
            p = ListenerParams(n_fft=n_fft, window_t=n_fft / 16000, hop_t=hop_t)
            audio = device_audio(args.batch, p.max_samples, 0, dev)
            consts = ct_kernel.CtConstants(p, "mfcc", dev)
            runs = _runs(consts, p, args.sweep)
            want = ct_kernel.ct_frontend_plain(audio, None, consts, p)
            for label, lib, lay in runs + runs[::-1]:
                _build.load_library = lambda lib=libs[lib]: lib
                consts.layout = lay

                def launch():
                    return ct_kernel.ct_frontend_cuda(audio, gain, consts, p)

                check_features(f"mixed n_fft {n_fft} {label}", launch(), want)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(args.iters):
                    launch()
                end.record()
                end.synchronize()
                times.setdefault((n_fft, label), []).append(
                    start.elapsed_time(end) / args.iters)
            del audio, want
    finally:
        _build.load_library = shipped
    for (n_fft, label), ms in times.items():
        print(f"mixed n_fft {n_fft:4d} {label:28s} "
              + ", ".join(f"{t:.4f}" for t in ms)
              + f" ms  (B = {args.batch}, {card_line()})", flush=True)
    return times


if __name__ == "__main__":
    main()
