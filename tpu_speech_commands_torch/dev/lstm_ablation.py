#!/usr/bin/env python3
"""What each design choice of the LSTM tile kernel is worth: csrc/
lstm_classifier.cu with one choice undone (or one other choice made) at a
time, each variant built beside the shipped library and timed in turns on
the card, as `dev/gru_ablation.py` does for the GRU.

    python -m tpu_speech_commands_torch.dev.lstm_ablation [--batch 8192]
        [--iters 20]
    python -m tpu_speech_commands_torch.dev.lstm_ablation --features 300
        [--frames 23] [--batch 8192] [--iters 20]

Variants (text substitutions in a copy of the source; every one computes
the shipped kernel's function, and its logits are printed against the
shipped kernel's):

  true_divide     each sigmoid's reciprocal by the true divide 1.0f / d,
                  whose range check and branch end a basic block at every
                  division
  no_pipeline     bf16: group j's products issued just before its own gate
                  math, not before group j - 1's
  no_min_blocks   __launch_bounds__ without its minimum of one block an SM
  f32_all_rows    f32: the input rows run to D_p (32 at D 20), not to D
                  rounded to 4
  f32_two_passes  f32: two passes over k a step, half the units each (48
                  accumulators, not 96 at U 48)
  all_undone      true_divide, no_pipeline, no_min_blocks and f32_all_rows
                  together

Cuts (their logits are not the kernel's; only their time is read):

  no_gate_math    the gate math of both modes replaced by h = (i + f + c +
                  o) / 4: what the products, loads and stores take alone
  one_weight      f32: every lane reads the same weight float2 (t = 0's),
                  one shared-memory address a load where the kernel has
                  four: what the weight loads' addresses cost

Times: device time from CUDA graphs (`graph_ms`) of `lstm_layer_cuda` on a
seeded 48-unit layer over (B, 30, 20) features, f32 and bf16 (bf16
features), every variant in the order base, variants, then reversed.

`--features D` (above gru_plan.CAP_D) times the projected route's parts
instead (`gru_ablation.time_projected`: the projection alone, the
recurrence alone, both, and the SIMT kernel where its block fits).
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ..device import resolve_device
from ..models.rnn import SimpleLSTM
from ..ops import rnn_kernel
from ..ops.lstm_plan import pack_lstm_weights
from . import card_line
from .ct_ablation import build
from .gru_ablation import edited_sources, time_projected, time_variants

RCP = ("    si[e] = rcp_rn(di[e]);\n"
       "    sf[e] = rcp_rn(df[e]);\n"
       "    so[e] = rcp_rn(dq[e]);\n")
BOUNDS = "__global__ void __launch_bounds__(kMaxWarps * 32, 1)"
PIPELINE = """      products<KBX, KBH, NU>(acc[0], xa, ha, s_b, s_bias, 0, t4);
#pragma unroll
      for (int j = 0; j < NU; ++j) {
        if (j + 1 < NU)
          products<KBX, KBH, NU>(acc[(j + 1) & 1], xa, ha, s_b, s_bias, j + 1, t4);
"""
ROWS_F32 = "        for (int k = 0; k < dx; ++k) {"
PASSES = "  constexpr int kPass = NU <= 6 ? NU : NU / 2;"

CHOICES = {
    "true_divide": [(RCP, RCP.replace("rcp_rn(", "1.0f / ("))],
    "no_pipeline": [(PIPELINE, """#pragma unroll
      for (int j = 0; j < NU; ++j) {
        products<KBX, KBH, NU>(acc[j & 1], xa, ha, s_b, s_bias, j, t4);
""")],
    "no_min_blocks": [(BOUNDS, BOUNDS.replace(", 1)", ")"))],
    "f32_all_rows": [(ROWS_F32, ROWS_F32.replace("< dx", "< DP"))],
    "f32_two_passes": [(PASSES, "  constexpr int kPass = NU / 2;")],
}
CHOICES["all_undone"] = [edit for name in ("true_divide", "no_pipeline",
                                           "no_min_blocks", "f32_all_rows")
                         for edit in CHOICES[name]]
GATE_F32 = """          gate(h[j0 + jj], c[j0 + jj], acc[0][jj], acc[1][jj], acc[2][jj],
               acc[3][jj]);"""
GATE_BF16 = "        gate(hj[0], c[j], a[0], a[1], a[2], a[3]);"
STAND_IN = ("for (int e = 0; e < 4; ++e) {0}[e] = 0.25f * ({1}[e] + {2}[e] + "
            "{3}[e] + {4}[e]);")
CUTS = {
    "no_gate_math": [
        (GATE_F32, "          " + STAND_IN.format(
            "h[j0 + jj]", "acc[0][jj]", "acc[1][jj]", "acc[2][jj]", "acc[3][jj]")),
        (GATE_BF16, "        " + STAND_IN.format(
            "hj[0]", "a[0]", "a[1]", "a[2]", "a[3]"))],
    "one_weight": [("reinterpret_cast<const float2*>(s_w) + t4;",
                    "reinterpret_cast<const float2*>(s_w);")],
}


def variant_sources() -> dict:
    """name -> the kernel source with that choice made, or that part cut
    ("base": as shipped)."""
    return edited_sources("lstm_classifier.cu", {**CHOICES, **CUTS})


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=8192)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--features", type=int, default=None,
                    help="time the projected route's parts at this feature "
                         "size (above gru_plan.CAP_D) instead of the variants")
    ap.add_argument("--frames", type=int, default=23,
                    help="frames a window with --features")
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    card = card_line()
    print(card, flush=True)
    if args.features is not None:
        return time_projected("lstm", args.batch, args.features, args.frames,
                              args.iters, dev, card)
    libs = build(variant_sources(), "lstm")
    model = SimpleLSTM(5, 20, 48)
    rng = np.random.default_rng(0)
    with torch.no_grad():
        for prm in model.parameters():
            prm.copy_(torch.tensor(0.1 * rng.standard_normal(tuple(prm.shape)),
                                   dtype=torch.float32))
    model = model.to(dev).eval()
    cell, head = model.backbone.lstm_unit_0, model.score_predict
    x32 = torch.tensor(rng.standard_normal((args.batch, 30, 20)),
                       dtype=torch.float32, device=dev)

    def run_for(dtype):
        x = x32.to(dtype)
        pack = pack_lstm_weights(cell.kernel, cell.recurrent_kernel, cell.bias,
                                 dtype)
        return lambda: rnn_kernel.lstm_layer_cuda(
            x, cell.kernel, cell.recurrent_kernel, cell.bias, head.kernel,
            head.bias, dtype, pack)

    times, outs = time_variants(libs, run_for, args.iters)
    for (dtype, name), ms in times.items():
        diff = float((outs[dtype, name] - outs[dtype, "base"]).abs().max())
        what = ("a cut" if name in CUTS else
                f"logits vs base {diff:.1e}")
        print(f"lstm_classifier {str(dtype)[6:]:8s} {name:14s} "
              + ", ".join(f"{t:.4f}" for t in ms)
              + f" ms (device time; {what})  (B = {args.batch}, 48 units, "
              f"30 x 20, {card})", flush=True)
    return times


if __name__ == "__main__":
    main()
