#!/usr/bin/env python3
"""The RNN classifiers' input projection, part by part: its kernel
(csrc/rnn_projection_wgmma.cu) against its first design
(csrc/rnn_projection.cu, `_mma_sync=True`) in turns, the kernel's stage
cuts, and the first design's steps undone, each variant built beside the
shipped library and timed in turns on the card, as `dev/gru_ablation.py`
does for the GRU's tile.

    python -m tpu_speech_commands_torch.dev.projection_ablation
        [--parts designs cuts variants steps] [--batch 8192] [--frames 23]
        [--iters 20]

Parts:

  designs  the kernel and its first design on the shipped library, in
           the order first, kernel, kernel, first; each output first held
           to `rnn_projection.exact_projection`'s bound of the float64 XW
  cuts     the kernel with one part taken out by its compile-time switch
           (a cut's output is not the function, and is not checked):
             no_products    TSC_PJW_CUT 1: the consumers wait for each stage
                            and release it, no wgmma
             no_stores      2: no XW stores
             no_w_stream    3: no W stream (the stages' W slices keep what
                            they hold)
             no_row_copies  4: no row copies
           and no_cluster (TSC_PJW_CLUSTER 1: each block streams all of W's
           slices itself, no multicast; held to the bound)
  variants the kernel with one plan choice changed (text substitutions in
           a copy of its source; each computes the function and is held to
           the bound):
             tile128        tiles of 128 rows at every N (one m64 tile a
                            consumer warpgroup): twice the stages a ring
                            holds, half the XW a tile stores at its end
             tile128_s8     the same with a ring of up to 8 stages
             bf16_streamed  bf16 W streamed with the rows (by the cluster)
                            where it would be resident
  steps    the first design with one step undone (text substitutions in a
           copy of its source, run with `_mma_sync=True`; each computes its
           function and is held to the bound):
             one_block        f32 mode: one block an SM on the cp.async ring
                              of 4 stages, not two on a ring of 2
             copy4            4-byte cp.async for every row (and one block
                              an SM), not the widest copy the rows'
                              alignment allows
             registers        the rows staged through registers (a ring of
                              two), each stage converted and stored after
                              the products, not by cp.async
             convert_at_load  the same, each value converted as its load
                              arrives, so every stage waits for its loads
                              before its products (its first staging)

Times: device time from CUDA graphs (`graph_ms`) of `rnn_projection_cuda`
on numpy-seeded (B, frames, D) features, a seeded kernel and bias and 48
units, at D 300 (the GRU's N 144 and the LSTM's 192), 600, 150 and 80 (N 144),
f32 and bf16 (features in the mode's dtype).
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ..device import resolve_device
from ..ops import rnn_projection
from . import card_line, graph_ms
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
# the kernel's cuts: name -> TSC_PJW_CUT (None: the cluster variant)
CUTS = {"no_products": 1, "no_stores": 2, "no_w_stream": 3,
        "no_row_copies": 4, "no_cluster": None}
CUT = "#define TSC_PJW_CUT 0\n"
M64 = "constexpr int m64_tiles(int N) { return N <= kWideN ? 2 : 1; }"
STAGES = "#define TSC_PJW_MAX_STAGES 6 "
KEEP = "const bool keep = resident >= kResidentStages;"
VARIANTS = {
    "tile128": [(M64, "constexpr int m64_tiles(int N) { return 1; }")],
    "tile128_s8": [(M64, "constexpr int m64_tiles(int N) { return 1; }"),
                   (STAGES, "#define TSC_PJW_MAX_STAGES 8 ")],
    "bf16_streamed": [(KEEP, "const bool keep = false;")],
}
CLUSTER = "#define TSC_PJW_CLUSTER 2 "
# (D, gates) of 48 units: the GRU and the LSTM at 300 features, and 600, 150, 80
CASES = ((300, 3), (300, 4), (600, 3), (150, 3), (80, 3))
PARTS = ("designs", "cuts", "variants", "steps")


def variant_sources() -> dict:
    """name -> the first design's source with that step undone ("base": as
    shipped)."""
    return edited_sources("rnn_projection.cu", CHOICES)


def cut_sources() -> dict:
    """name -> the kernel's source with that cut ("base": as shipped)."""
    return edited_sources("rnn_projection_wgmma.cu", {
        name: [(CLUSTER, "#define TSC_PJW_CLUSTER 1 ")] if n is None
        else [(CUT, f"#define TSC_PJW_CUT {n}\n")]
        for name, n in CUTS.items()})


def plan_sources() -> dict:
    """name -> the kernel's source with that plan choice changed ("base":
    as shipped)."""
    return edited_sources("rnn_projection_wgmma.cu", VARIANTS)


def _check(got, x, kernel, bias, dtype, what):
    exact, bound = rnn_projection.exact_projection(x, kernel, bias, 48, dtype)
    if not ((got.double() - exact).abs() <= bound).all():
        raise AssertionError(f"{what}: outside the f32 sum's bound")


def _line(d_in, gates, dtype, name, ms, batch, frames, card):
    print(f"rnn_projection D {d_in} N {gates * 48} {str(dtype)[6:]:8s} "
          f"{name:16s} " + ", ".join(f"{t:.4f}" for t in ms)
          + f" ms (device time)  (B = {batch}, {frames} frames, {card})",
          flush=True)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parts", nargs="+", choices=PARTS, default=["designs"])
    ap.add_argument("--batch", type=int, default=8192)
    ap.add_argument("--frames", type=int, default=23)
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    card = card_line()
    print(card, flush=True)
    libs = {}
    if "cuts" in args.parts:
        libs["cuts"] = build(cut_sources(), "projection_cuts")
    if "variants" in args.parts:
        libs["variants"] = build(plan_sources(), "projection_variants")
    if "steps" in args.parts:
        libs["steps"] = build(variant_sources(), "projection")
    rng = np.random.default_rng(0)
    out = {}
    for d_in, gates in CASES:
        x32 = torch.tensor(rng.standard_normal((args.batch, args.frames, d_in)),
                           dtype=torch.float32, device=dev)
        kernel = torch.tensor(rng.standard_normal((d_in, gates * 48))
                              / np.sqrt(d_in), dtype=torch.float32, device=dev)
        bias = torch.tensor(rng.standard_normal(gates * 48),
                            dtype=torch.float32, device=dev)

        def run_for(dtype, mma_sync=False):
            x = x32.to(dtype)
            pack = rnn_projection.pack_projection(kernel, bias, 48, dtype)
            return lambda: rnn_projection.rnn_projection_cuda(
                x, pack, _mma_sync=mma_sync)

        if "designs" in args.parts:
            for dtype in (torch.float32, torch.bfloat16):
                runs = {"mma_sync": run_for(dtype, True),
                        "wgmma": run_for(dtype)}
                for name, run in runs.items():
                    _check(run(), x32.to(dtype), kernel, bias, dtype,
                           f"{name} at D {d_in}, {dtype}")
                times = {}
                for name in ("mma_sync", "wgmma", "wgmma", "mma_sync"):
                    times.setdefault(name, []).append(
                        graph_ms(runs[name], args.iters))
                for name, ms in times.items():
                    out["designs", d_in, gates * 48, str(dtype)[6:], name] = ms
                    _line(d_in, gates, dtype, name, ms, args.batch,
                          args.frames, card)
        for part, mma_sync in (("cuts", False), ("variants", False),
                               ("steps", True)):
            if part not in args.parts:
                continue
            times, outs = time_variants(
                libs[part], lambda dt: run_for(dt, mma_sync), args.iters)
            for (dtype, name), ms in times.items():
                if part != "cuts" or name in ("base", "no_cluster"):
                    _check(outs[dtype, name], x32.to(dtype), kernel, bias,
                           dtype, f"{part} {name} at D {d_in}, {dtype}")
                out[part, d_in, gates * 48, str(dtype)[6:], name] = ms
                _line(d_in, gates, dtype, name, ms, args.batch, args.frames,
                      card)
    return out


if __name__ == "__main__":
    main()
