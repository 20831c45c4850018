#!/usr/bin/env python3
"""Where the CNN classifier kernels spend their time: csrc/cnn_classifier.cu
with one part cut out at a time, each built beside the shipped library and
timed in turns on the card.  The SIMT kernel (`tsc_cnn_classifier_simt`)
with the conv weights of block 4, of block 3 or of every block read from a
small slab that stays in L1 instead of from L2; the tiled implicit GEMM
(`tsc_cnn_classifier`) stopped after stage 1, 2, 3 or 4, or without its
stage 1.

    python -m tpu_speech_commands_torch.dev.cnn_ablation [--batch 8192]
        [--iters 20]

Cuts (each a few text substitutions in a copy of the source; the kernel's
output is wrong without the part, only its time is read).  In `conv_stage`
every (window, position) warp reads its stage's whole (3, 3, cin, cout)
weight tensor; a cut points those reads at rows 0-7 of the tap's kernel (8 x
cout weights, L1-resident), so the loads, their count and the FMAs stay and
only the L2 stream goes.  The choice is made at compile time (a template
flag of `conv_stage`, set for the one stage by the kernel's stage loop), so
the inner loop of every other stage is the shipped one:

  block4_l1   block 4 (cout 128): 295 KB of f32 weights a warp
  block3_l1   block 3 (cout 64): 74 KB
  all_l1      every block

and of the GEMM kernel (its logits are wrong, the launch runs the rest):

  gemm_upto_stage1 .. gemm_upto_stage4   no product after that stage
                                         (stage 1 alone: the input load,
                                         stage 1 and the head)
  gemm_no_stage1                         no stage 1
  gemm_input_only                        no stage 1 and no product: the
                                         input load, the weight ring's
                                         first chunks and the head
  gemm_no_epilogues                      bf16: the products' MMAs without
                                         their epilogues (no pool, no
                                         store)

and the shipped GEMM kernel at other tiles than the plan's (the most that
fit, capped by `cnn_plan.MAX_TILE`): 16, 12, 9, 8, 6 and 4 windows where
they fit, with the f32 cap lifted (`gemm_tile<T>`).

Times: CUDA events over `--iters` launches of `tsc_cnn_classifier_simt`
(`cnn_classifier_cuda(..., _simt=True)`) on simple_cnn at 30 x 20 (weights
from a seed, f32 features), f32 and bf16, every variant in the order base,
cuts, then reversed; the GEMM cuts and the shipped tsc_cnn_classifier
(`gemm`) through `cnn_classifier_cuda` in the same turns.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ..device import resolve_device
from ..models.cnn import SimpleCNN
from ..ops import _build, cnn_kernel, cnn_plan
from . import card_line
from .ct_ablation import build

LOAD = "const float4 wv = load4(wt + (size_t)ci * s.cout);"
SLAB = "w + 4 * g + (ci & 7) * s.cout"
TEMPLATE = ("template <typename WT, int NQ, bool kRound>\n"
            "__device__ void conv_stage(")
DISPATCH = """    if (s.pool)
      conv_stage<WT, 4, kBf16>(s, in, in_pitch, out, out_pitch, nb);
    else
      conv_stage<WT, 1, kBf16>(s, in, in_pitch, out, out_pitch, nb);
"""


def _slab_at(stage: int) -> list[tuple[str, str]]:
    """Stage `stage` (0-based) of the SIMT kernel reads the slab, by a
    template flag; every other stage (and the block-1 kernel) as shipped."""
    flagged = DISPATCH.replace("kBf16>", "kBf16, true>")
    return [
        (TEMPLATE, TEMPLATE.replace("bool kRound>", "bool kRound,\n"
                                    "          bool kSlab = false>")),
        (LOAD, "const float4 wv = load4(kSlab ? " + SLAB +
         " : wt + (size_t)ci * s.cout);"),
        (DISPATCH,
         flagged.replace("if (s.pool)", f"if (k == {stage} && s.pool)")
         .replace("    else\n", f"    else if (k == {stage})\n")
         + DISPATCH.replace("    if (s.pool)", "    else if (s.pool)")),
    ]


CUTS = {
    "block4_l1": _slab_at(3),
    "block3_l1": _slab_at(2),
    "all_l1": [(LOAD, "const float4 wv = load4(" + SLAB + ");")],
}
PRODUCTS = [f"  run_product<{p}>(a, ring, A, B, zero, nb);" for p in range(4)]
PRODUCTS = [line + comment for line, comment in zip(PRODUCTS, (
    "  // stage 2\n", "  // stage 3\n", "  // stage 4\n", "  // the dense layer\n"))]
GEMM_CUTS = {
    **{f"gemm_upto_stage{n + 1}": [("".join(PRODUCTS), "".join(PRODUCTS[:n]))]
       for n in range(4)},
    "gemm_no_stage1": [("  stage1<CT>(a, A, B, nb);", "")],
    "gemm_input_only": [("  stage1<CT>(a, A, B, nb);\n\n" + "".join(PRODUCTS),
                         "")],
    "gemm_no_epilogues": [(
        "    if (!active) continue;  // warp-uniform: the shuffles below see all lanes",
        "    continue;")],
}


def variant_sources() -> dict:
    """name -> the kernel source with that cut ("base": as shipped);
    ValueError if a text a cut replaces is not in the source exactly once."""
    src = (_build.CSRC_DIR / "cnn_classifier.cu").read_text()
    out = {"base": src}
    for name, edits in {**CUTS, **GEMM_CUTS}.items():
        cut = src
        for old, new in edits:
            if src.count(old) != 1:
                raise ValueError(f"cut {name}: its text is not in "
                                 "cnn_classifier.cu once")
            cut = cut.replace(old, new)
        out[name] = cut
    return out


def random_simple_cnn(seed: int, device) -> SimpleCNN:
    """simple_cnn at 30 x 20, 5 classes, weights and BatchNorm statistics
    from a numpy seed."""
    model = SimpleCNN(5, 30, 20)
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, t in model.state_dict().items():
            if name.endswith("bn.var"):
                val = rng.uniform(0.5, 2.0, t.shape)
            elif name.endswith("bn.scale"):
                val = rng.normal(1.0, 0.6, t.shape)
            else:
                fan_in = int(np.prod(t.shape[:-1])) if t.ndim > 1 else 10
                val = rng.standard_normal(t.shape) / np.sqrt(fan_in)
            t.copy_(torch.tensor(val, dtype=torch.float32))
    return model.to(device).eval()


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=8192)
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    card = card_line()
    print(card, flush=True)
    libs = build(variant_sources(), "cnn")
    model = random_simple_cnn(0, dev)
    x = torch.tensor(4.0 * np.random.default_rng(1).standard_normal(
        (args.batch, 30, 20)), dtype=torch.float32, device=dev)
    shipped = _build.load_library
    times = {}

    def timed(fn) -> float:
        fn()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / args.iters

    try:
        for dtype in (torch.float32, torch.bfloat16):
            consts = cnn_kernel.CNNClassifier(model, dtype).consts
            for name in list(libs) + list(libs)[::-1]:
                _build.load_library = lambda lib=libs[name]: lib
                if name not in GEMM_CUTS:
                    times.setdefault((dtype, name), []).append(timed(
                        lambda: cnn_kernel.cnn_classifier_cuda(x, consts,
                                                               _simt=True)))
                if name not in CUTS:
                    times.setdefault((dtype, "gemm" if name == "base" else name),
                                     []).append(timed(
                        lambda: cnn_kernel.cnn_classifier_cuda(x, consts)))
        _build.load_library = lambda lib=libs["base"]: lib
        for dtype in (torch.float32, torch.bfloat16):
            consts = cnn_kernel.CNNClassifier(model, dtype).consts
            picked = consts.plan
            cap = cnn_plan.MAX_TILE[dtype]
            cnn_plan.MAX_TILE[dtype] = cnn_plan.MAX_TILE[torch.bfloat16]
            most = cnn_plan.make_plan(consts.lowered.stages, 128, dtype).tile
            plans = {t: cnn_plan.make_plan(consts.lowered.stages, 128, dtype, t)
                     for t in (16, 12, 9, 8, 6, 4) if t <= most}
            cnn_plan.MAX_TILE[dtype] = cap
            tiles = sorted(plans, reverse=True)
            for tile in tiles + tiles[::-1]:
                plan = plans[tile]
                consts._plan = plan
                name = f"gemm_tile{tile}" + (" (plan)" if tile == picked.tile
                                             else "")
                times.setdefault((dtype, name), []).append(timed(
                    lambda: cnn_kernel.cnn_classifier_cuda(x, consts)))
    finally:
        _build.load_library = shipped
    for (dtype, name), ms in times.items():
        print(f"cnn_classifier {str(dtype)[6:]:8s} "
              f"{name if name.startswith('gemm') else 'simt ' + name:20s} "
              + ", ".join(f"{t:.4f}" for t in ms)
              + f" ms  (B = {args.batch}, simple_cnn 30 x 20, {card})",
              flush=True)
    return times


if __name__ == "__main__":
    main()
