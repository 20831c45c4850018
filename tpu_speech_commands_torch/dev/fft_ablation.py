#!/usr/bin/env python3
"""Where the FFT kernel's register body spends its time, and what its
design choices are worth: csrc/mfcc_frontend.cu (with csrc/register_fft.cuh,
the body it shares with route ct's kernel, inlined) with one part cut out or
one choice undone at a time, each built beside the shipped library and
timed in turns on the card.

    python -m tpu_speech_commands_torch.dev.fft_ablation [--batch 8192]
        [--iters 20]

Variants (each a text substitution in a copy of the source; a cut's output
is wrong, only its time is read):

  no_filterbank      cut: no filter sums (partial sums stay unwritten)
  nested_filterbank  the filterbank as a loop over a lane's segments with
                     an inner loop over each (the warp steps once a
                     segment of every lane, not once a weight)
  guarded_loads      every pair load behind its window test, as a frame
                     that reaches past the window takes them
  six_warps          6 warps a block (30 frames: no idle frame slot; 5
                     blocks, 30 warps an SM at 64 registers, not 32)

Times: CUDA events over `--iters` launches of the shipped entry at the
default config (B windows of f32 audio, gain 1), every variant in the order
base, variants, then reversed.
"""
from __future__ import annotations

import argparse

import torch

from ..device import resolve_device
from ..ops import _build, frontend_kernel
from ..params import ListenerParams
from . import card_line, device_audio
from .ct_ablation import build, inlined_source

VARIANTS = {
    "no_filterbank": ("      if (s < s_end) {\n        int k = segs[3 * s]",
                      "      if (false) {\n        int k = segs[3 * s]"),
    "nested_filterbank": (
        """      if (s < s_end) {
        int k = segs[3 * s], o = segs[3 * s + 1], left = segs[3 * s + 2];
        float acc = 0.0f;
        for (;;) {
          acc = fmaf(prow[k++], s_w[o++], acc);
          if (--left == 0) {
            partial[s] = acc;
            acc = 0.0f;
            if (++s == s_end) break;
            k = segs[3 * s];
            left = segs[3 * s + 2];
          }
        }
      }""",
        """      for (; s < s_end; ++s) {
        const int k0 = segs[3 * s], o0 = segs[3 * s + 1], cnt = segs[3 * s + 2];
        float acc = 0.0f;
        for (int i = 0; i < cnt; ++i) acc += prow[k0 + i] * s_w[o0 + i];
        partial[s] = acc;
      }"""),
    "guarded_loads": (
        "if (active && vec && 2 * (l + L * (V / R0 - 1) + (R0 - 1) * (N / R0)) + 1 < w_eff) {",
        "if (false) {"),
    "six_warps": ("constexpr int kMaxThreads = 256;",
                  "constexpr int kMaxThreads = 192;"),
}


def variant_sources() -> dict:
    """name -> the kernel source with that variant ("base": as shipped);
    ValueError if a variant's text is not in the source exactly once."""
    src = inlined_source("mfcc_frontend.cu")
    out = {"base": src}
    for name, (old, new) in VARIANTS.items():
        if src.count(old) != 1:
            raise ValueError(f"variant {name}: its text is not in "
                             "mfcc_frontend.cu once")
        out[name] = src.replace(old, new)
    six = "int B = (V == 16 ? 4 :"
    if out["six_warps"].count(six) != 1:
        raise ValueError("variant six_warps: the launch bounds moved")
    out["six_warps"] = out["six_warps"].replace(
        six, "int B = (V == 16 ? 5 :")
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=8192)
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    print(card_line(), flush=True)
    libs = build(variant_sources(), "fft")
    p = ListenerParams()
    audio = device_audio(args.batch, p.max_samples, 0, dev)
    consts = frontend_kernel.KernelConstants(p, "mfcc", dev)
    gain = torch.ones(1, dtype=torch.float32, device=dev)
    shipped = _build.load_library
    times = {}
    try:
        for name in list(libs) + list(libs)[::-1]:
            _build.load_library = lambda lib=libs[name]: lib
            frontend_kernel.mfcc_frontend_cuda(audio, gain, consts, p)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(args.iters):
                frontend_kernel.mfcc_frontend_cuda(audio, gain, consts, p)
            end.record()
            end.synchronize()
            times.setdefault(name, []).append(start.elapsed_time(end) / args.iters)
    finally:
        _build.load_library = shipped
    for name, ms in times.items():
        print(f"register body {name:17s} " + ", ".join(f"{t:.4f}" for t in ms)
              + f" ms  (B = {args.batch}, {card_line()})", flush=True)
    return times


if __name__ == "__main__":
    main()
