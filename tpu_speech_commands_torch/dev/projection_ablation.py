#!/usr/bin/env python3
"""What each design step of the RNN classifiers' input projection is worth:
csrc/rnn_projection.cu with one step undone at a time, each variant built
beside the shipped library and timed in turns on the card, as
`dev/gru_ablation.py` does for the GRU's tile.

    python -m tpu_speech_commands_torch.dev.projection_ablation
        [--batch 8192] [--frames 23] [--iters 20]

Variants (text substitutions in a copy of the source; every one computes
the shipped kernel's function, and each run is first held to
`rnn_projection.exact_projection`'s bound of the float64 XW):

  one_block        f32 mode: one block an SM on the cp.async ring of 4
                   stages, not two on a ring of 2
  copy4            4-byte cp.async for every row (and one block an SM),
                   not the widest copy the rows' alignment allows
  registers        the rows staged through registers (a ring of two), each
                   stage converted and stored after the products, not by
                   cp.async
  convert_at_load  the same, each value converted as its load arrives, so
                   every stage waits for its loads before its products
                   (the first design)

Times: device time from CUDA graphs (`graph_ms`) of `rnn_projection_cuda`
on numpy-seeded (B, frames, D) features, a seeded kernel and bias and 48
units, at D 300 (the GRU's N 144 and the LSTM's 192), 600 and 80 (N 144),
f32 and bf16 (features in the mode's dtype), every variant in the order
shipped, variants, then reversed.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ..device import resolve_device
from ..ops import rnn_projection
from . import card_line
from .ct_ablation import build
from .gru_ablation import edited_sources, time_variants

TWO_BLOCKS = "constexpr int kTwoBlockNtw = 12;"
COPY = "  const int vec = copy_bytes(x, x_bf16 ? 2 : 4, D);"
HELD = "    InT held[PER];  // raw: converted only when staged, after the products"
LOAD = ("        held[i] = zero<InT>();\n"
        "        if (src[i] && k < D) held[i] = __ldg(src[i] + k);")
STORE = "a[(r0 + STEP * i) * P + kc] = staged<S>(to_float(held[i]));"

CHOICES = {
    "one_block": [(TWO_BLOCKS, "constexpr int kTwoBlockNtw = 0;")],
    "copy4": [(TWO_BLOCKS, "constexpr int kTwoBlockNtw = 0;"),
              (COPY, COPY.replace("D);", "D) >= 4 ? 4 : 0;"))],
    "registers": [(COPY, "  const int vec = 0;")],
    "convert_at_load": [
        (COPY, "  const int vec = 0;"), (HELD, "    S held[PER];"),
        (LOAD, "        held[i] = staged<S>(src[i] && k < D ? "
               "to_float(__ldg(src[i] + k)) : 0.0f);"),
        (STORE, "a[(r0 + STEP * i) * P + kc] = held[i];")],
}
# (D, gates) of 48 units: the GRU and the LSTM at 300 features, and 600, 80
CASES = ((300, 3), (300, 4), (600, 3), (80, 3))


def variant_sources() -> dict:
    """name -> the kernel source with that step undone ("base": as
    shipped)."""
    return edited_sources("rnn_projection.cu", CHOICES)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=8192)
    ap.add_argument("--frames", type=int, default=23)
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    card = card_line()
    print(card, flush=True)
    libs = build(variant_sources(), "projection")
    rng = np.random.default_rng(0)
    out = {}
    for d_in, gates in CASES:
        x32 = torch.tensor(rng.standard_normal((args.batch, args.frames, d_in)),
                           dtype=torch.float32, device=dev)
        kernel = torch.tensor(rng.standard_normal((d_in, gates * 48))
                              / np.sqrt(d_in), dtype=torch.float32, device=dev)
        bias = torch.tensor(rng.standard_normal(gates * 48),
                            dtype=torch.float32, device=dev)

        def run_for(dtype):
            x = x32.to(dtype)
            pack = rnn_projection.pack_projection(kernel, bias, 48, dtype)
            return lambda: rnn_projection.rnn_projection_cuda(x, pack)

        times, outs = time_variants(libs, run_for, args.iters)
        for (dtype, name), ms in times.items():
            exact, bound = rnn_projection.exact_projection(
                x32.to(dtype), kernel, bias, 48, dtype)
            if not ((outs[dtype, name].double() - exact).abs() <= bound).all():
                raise AssertionError(f"{name} at D {d_in}, {dtype}: outside "
                                     "the f32 sum's bound")
            out[d_in, gates * 48, str(dtype)[6:], name] = ms
            print(f"rnn_projection D {d_in} N {gates * 48} "
                  f"{str(dtype)[6:]:8s} {name:16s} "
                  + ", ".join(f"{t:.4f}" for t in ms)
                  + f" ms (device time)  (B = {args.batch}, {args.frames} "
                  f"frames, {card})", flush=True)
    return out


if __name__ == "__main__":
    main()
