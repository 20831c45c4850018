#!/usr/bin/env python3
"""What each design choice of the GRU tile kernel is worth: csrc/
gru_classifier.cu with one choice undone at a time, each variant built
beside the shipped library and timed in turns on the card.

    python -m tpu_speech_commands_torch.dev.gru_ablation [--batch 8192]
        [--iters 20]

Variants (text substitutions in a copy of the source; every one computes
the shipped kernel's function, and its logits are printed against the
shipped kernel's):

  true_divide    each sigmoid's reciprocal by the true divide 1.0f / d,
                 whose range check and branch end a basic block at every
                 division (the first tile version's gate math)
  branch_free    rcp_sigmoid for every element, no branch at all (the
                 subnormal tail's rounding by selects, every time)
  warp_vote      the rare-tail branch taken on a warp vote (__any_sync),
                 warp-uniform, not on each lane's own flag
  no_pipeline    bf16: group j's products issued just before its own gate
                 math, not before group j - 1's
  no_min_blocks  __launch_bounds__ without its minimum of one block an SM
  f32_all_rows   f32: the input rows run to D_p (32 at D 20), not to D
                 rounded to 4
  all_undone     true_divide, no_pipeline, no_min_blocks and f32_all_rows
                 together: the first tile version but for its seq_out
                 stores

Times: device time from CUDA graphs (`graph_ms`: a bf16 launch is shorter
than its host work) of `gru_layer_cuda` on a seeded 48-unit layer over
(B, 30, 20) features, f32 and bf16 (bf16 features), every variant in the
order base, variants, then reversed.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ..device import resolve_device
from ..models.rnn import SimpleGRU
from ..ops import _build, rnn_kernel
from ..ops.gru_plan import pack_gru_weights
from . import card_line, graph_ms
from .ct_ablation import build

RCP = ("    sz[e] = rcp_rn(dz[e]);\n"
       "    sr[e] = rcp_rn(dr[e]);\n")
TAIL = "  if (!in_range) {"
BOUNDS = "__global__ void __launch_bounds__(kMaxWarps * 32, 1)"
PIPELINE = """      products<KBX, KBH, NU>(acc[0], xa, ha, s_b, s_bias, 0, t4);
#pragma unroll
      for (int j = 0; j < NU; ++j) {
        if (j + 1 < NU)
          products<KBX, KBH, NU>(acc[(j + 1) & 1], xa, ha, s_b, s_bias, j + 1, t4);
"""
ROWS_F32 = "        for (int k = 0; k < dx; ++k) {"

CHOICES = {
    "true_divide": [(RCP, RCP.replace("rcp_rn(", "1.0f / ("))],
    "branch_free": [(RCP, RCP.replace("rcp_rn(", "rcp_sigmoid(")),
                    (TAIL, "  if (false) {")],
    "warp_vote": [(TAIL, "  if (__any_sync(0xffffffffu, !in_range)) {")],
    "no_pipeline": [(PIPELINE, """#pragma unroll
      for (int j = 0; j < NU; ++j) {
        products<KBX, KBH, NU>(acc[j & 1], xa, ha, s_b, s_bias, j, t4);
""")],
    "no_min_blocks": [(BOUNDS, BOUNDS.replace(", 1)", ")"))],
    "f32_all_rows": [(ROWS_F32, ROWS_F32.replace("< dx", "< DP"))],
}
CHOICES["all_undone"] = [edit for name in ("true_divide", "no_pipeline",
                                           "no_min_blocks", "f32_all_rows")
                         for edit in CHOICES[name]]


def edited_sources(filename: str, choices: dict) -> dict:
    """name -> csrc/`filename` with that choice's edits made ("base": as
    shipped); ValueError if a text an edit replaces is not in the source
    exactly once."""
    src = (_build.CSRC_DIR / filename).read_text()
    out = {"base": src}
    for name, edits in choices.items():
        variant = src
        for old, new in edits:
            if src.count(old) != 1:
                raise ValueError(f"variant {name}: its text is not in "
                                 f"{filename} once")
            variant = variant.replace(old, new)
        out[name] = variant
    return out


def variant_sources() -> dict:
    """name -> the kernel source with that choice undone ("base": as
    shipped)."""
    return edited_sources("gru_classifier.cu", CHOICES)


def time_variants(libs: dict, run_for, iters: int):
    """Device times (`graph_ms`) and outputs of run_for(dtype)() with each
    library in turn standing in for the shipped one, f32 then bf16, in the
    order base, variants, then reversed: ({(dtype, name): [ms, ms]},
    {(dtype, name): output})."""
    shipped = _build.load_library
    times, outs = {}, {}
    try:
        for dtype in (torch.float32, torch.bfloat16):
            run = run_for(dtype)
            for name in list(libs) + list(libs)[::-1]:
                _build.load_library = lambda lib=libs[name]: lib
                times.setdefault((dtype, name), []).append(graph_ms(run, iters))
                outs[dtype, name] = run()
    finally:
        _build.load_library = shipped
    return times, outs


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=8192)
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    card = card_line()
    print(card, flush=True)
    libs = build(variant_sources(), "gru")
    model = SimpleGRU(5, 20, 48)
    rng = np.random.default_rng(0)
    with torch.no_grad():
        for prm in model.parameters():
            prm.copy_(torch.tensor(0.1 * rng.standard_normal(tuple(prm.shape)),
                                   dtype=torch.float32))
    model = model.to(dev).eval()
    cell, head = model.backbone.gru_unit_0, model.score_predict
    x32 = torch.tensor(rng.standard_normal((args.batch, 30, 20)),
                       dtype=torch.float32, device=dev)

    def run_for(dtype):
        x = x32.to(dtype)
        pack = pack_gru_weights(cell.kernel, cell.recurrent_kernel,
                                cell.bias_input, cell.bias_recurrent, dtype)
        return lambda: rnn_kernel.gru_layer_cuda(
            x, cell.kernel, cell.recurrent_kernel, cell.bias_input,
            cell.bias_recurrent, head.kernel, head.bias, dtype, pack)

    times, outs = time_variants(libs, run_for, args.iters)
    for (dtype, name), ms in times.items():
        diff = float((outs[dtype, name] - outs[dtype, "base"]).abs().max())
        print(f"gru_classifier {str(dtype)[6:]:8s} {name:14s} "
              + ", ".join(f"{t:.4f}" for t in ms)
              + f" ms (device time; logits vs base {diff:.1e})  (B = "
              f"{args.batch}, 48 units, 30 x 20, {card})", flush=True)
    return times


if __name__ == "__main__":
    main()
