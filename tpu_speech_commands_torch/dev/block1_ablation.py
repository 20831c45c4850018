#!/usr/bin/env python3
"""What the design choices of the CNN block-1 kernel (csrc/cnn_block1.cu)
are worth: the kernel with one choice undone at a time, each chosen at
compile time by a -D switch, built beside the shipped library, held to the
plain version and timed in turns on the card.

    python -m tpu_speech_commands_torch.dev.block1_ablation [--batch 8192]
        [--iters 20] [--variants base,no_ring,...]

Variants:

  base          the shipped kernel
  no_ring       a ring of one stage: a tile is loaded only when the last
                one is released (TSC_B1_STAGES=1), synchronous staging
  ring_2        a ring of two stages, not three
  store_scalar  16 scalar 4-byte stores an item, straight to device memory
                (TSC_B1_STORE=0), as the first design stored
  store_vector  4 streaming 16-byte stores an item, a lane's 64 bytes, at
                a 64-byte stride across the warp (TSC_B1_STORE=1)
  store_bulk    the warp's buffer written out by a bulk copy, shared ->
                global, two buffers a warp (TSC_B1_STORE=3)
  items_1       a lane a pooled position (TSC_B1_ITEMS=1), not two: each
                weight load serves one item
  mma           bf16 mode on the tensor cores (TSC_B1_MMA=1): mma.sync
                m16n8k16, K = 9 taps padded to 16, N = 16 channels; the
                f32 mode is the base kernel's, so it is timed in bf16 only
  tile_4        at most 4 windows a tile (TSC_B1_TILE=4), not 8
  tile_16       at most 16 windows a tile
  blocks_1      launch bounds for 1 block an SM (TSC_B1_BLOCKS=1), not 2
  blocks_3      launch bounds for 3 blocks an SM
  load_store    a cut: the loads and stores alone, each item's output the
                sum of its patch (TSC_B1_CUT=1), against the K7 load floor
  simt          tsc_cnn_block1_simt from the shipped library, the first
                design (`cnn_block1_cuda(..., _simt=True)`)

Every variant but the cut is held to the plain version (`cnn_block1_plain`)
after its warm-up launch: f32 to atol / rtol 1e-5, bf16 to atol 5e-2
(RuntimeError if one differs).  Times: device times (`graph_ms`, the calls
replayed from a CUDA graph: the kernel is shorter than its wrapper's host
work) at B windows of 30 x 20 f32 features, simple_cnn's block 1 from a
seed, f32 and bf16 compute, every variant in the order listed, then
reversed.  Beside them: the bound (bytes and operations), and the K7 load
floor (`load_rowsum` over (B, 16000) f32 audio) as a rate, against the
cut's.  nvcc's -Xptxas -v lines of each variant are printed first.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..device import resolve_device
from ..ops import _build, cnn_kernel, load_kernel
from ..ops.cnn_lowering import lower_block1
from . import card_line, device_audio, graph_ms
from .cnn_ablation import random_simple_cnn
from .ct_ablation import build

# name: (nvcc -D switches, held to the plain version)
VARIANTS = {
    "base": ((), True),
    "no_ring": (("-DTSC_B1_STAGES=1",), True),
    "ring_2": (("-DTSC_B1_STAGES=2",), True),
    "store_scalar": (("-DTSC_B1_STORE=0",), True),
    "store_vector": (("-DTSC_B1_STORE=1",), True),
    "store_bulk": (("-DTSC_B1_STORE=3",), True),
    "items_1": (("-DTSC_B1_ITEMS=1",), True),
    "mma": (("-DTSC_B1_MMA=1",), True),
    "tile_4": (("-DTSC_B1_TILE=4",), True),
    "tile_16": (("-DTSC_B1_TILE=16",), True),
    "blocks_1": (("-DTSC_B1_BLOCKS=1",), True),
    "blocks_3": (("-DTSC_B1_BLOCKS=3",), True),
    "load_store": (("-DTSC_B1_CUT=1",), False),
    "simt": None,  # the shipped library's tsc_cnn_block1_simt
}
BF16_ONLY = ("mma",)
PEAK_F32, PEAK_BYTES = 67e12, 3.35e12


def bound(batch: int, h: int, w: int, elem: int) -> tuple[float, float]:
    """(bytes ms, operations ms) of block 1 at this batch: each input read
    and each output written once; 2 FLOP a tap, channel and conv position
    the pool keeps (f32 peak; bf16 mode runs its FMAs in f32 too)."""
    hp, wp = h // 2, w // 2
    nbytes = batch * (h * w * elem + hp * wp * 16 * 4)
    flops = 2.0 * batch * hp * wp * 4 * 9 * 16
    return nbytes / PEAK_BYTES * 1e3, flops / PEAK_F32 * 1e3


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=8192)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--variants", default=",".join(VARIANTS))
    args = ap.parse_args(argv)
    names = args.variants.split(",")
    dev = resolve_device("cuda")
    card = card_line()
    print(card, flush=True)
    built = [n for n in names if VARIANTS[n] is not None]
    logs = {}
    t0 = time.perf_counter()
    src = (_build.CSRC_DIR / "cnn_block1.cu").read_text()
    libs = build({n: src for n in built}, "block1", logs,
                 {n: VARIANTS[n][0] for n in built})
    print(f"  built {len(libs)} variants in {time.perf_counter() - t0:.1f} s",
          flush=True)
    for name in built:
        seen = set()
        for line in logs[name].splitlines():
            if ("registers" in line or "spill" in line) and line not in seen:
                seen.add(line)
                print(f"  {name}: {line.strip()}", flush=True)
    model = random_simple_cnn(0, dev)
    x = torch.tensor(4.0 * np.random.default_rng(1).standard_normal(
        (args.batch, 30, 20)), dtype=torch.float32, device=dev)
    shipped = _build.load_library
    times = {}
    try:
        for dtype in (torch.float32, torch.bfloat16):
            stage = cnn_kernel.StageTensors(
                lower_block1(model.variables(), False, 30, 20), dev, dtype)
            want = cnn_kernel.cnn_block1_plain(stage, x)
            runs = [n for n in names
                    if dtype == torch.bfloat16 or n not in BF16_ONLY]
            for name in runs + runs[::-1]:
                simt = VARIANTS[name] is None
                _build.load_library = shipped if simt else (
                    lambda lib=libs[name]: lib)

                def run(simt=simt):
                    return cnn_kernel.cnn_block1_cuda(x, stage, _simt=simt)

                got = run()
                torch.cuda.synchronize()
                if simt or VARIANTS[name][1]:
                    err = float((got - want).abs().max())
                    if not torch.isfinite(got).all():
                        raise RuntimeError(f"{name}: not finite")
                    if dtype == torch.float32:
                        ok = torch.allclose(got, want, rtol=1e-5, atol=1e-5)
                    else:
                        ok = err <= 5e-2
                    if not ok:
                        raise RuntimeError(f"{name} {dtype}: max|delta| "
                                           f"{err:.2e} against the plain version")
                times.setdefault((dtype, name), []).append(
                    graph_ms(run, args.iters))
    finally:
        _build.load_library = shipped
    audio = device_audio(args.batch, 16000, 0, dev)
    gain = torch.ones(1, dtype=torch.float32, device=dev)
    floor_ms = graph_ms(lambda: load_kernel.load_rowsum_cuda(audio, gain),
                        args.iters)
    floor_rate = audio.numel() * 4 / floor_ms / 1e9  # TB/s
    bytes_ms, ops_ms = bound(args.batch, 30, 20, 4)
    print(f"block1 bound at B = {args.batch}, 30 x 20 f32 features: bytes "
          f"{bytes_ms:.4f} ms, operations {ops_ms:.4f} ms (f32)  ({card})",
          flush=True)
    nbytes = bytes_ms * 1e-3 * PEAK_BYTES
    for (dtype, name), ms in times.items():
        held = "a cut" if VARIANTS[name] and not VARIANTS[name][1] else \
            "held to plain"
        rate = f"; {nbytes / ms[0] / 1e9:.3f} TB/s" if name in (
            "base", "load_store") else ""
        print(f"block1 {str(dtype)[6:]:8s} {name:13s} "
              + ", ".join(f"{t:.4f}" for t in ms)
              + f" ms ({held}{rate}; B = {args.batch}, 30 x 20, f32 "
              f"features, device times, {card})", flush=True)
    print(f"K7 load floor (load_rowsum, ({args.batch}, 16000) f32): "
          f"{floor_ms:.4f} ms = {floor_rate:.3f} TB/s  ({card})", flush=True)
    return {"times": times, "floor_ms": floor_ms, "card": card}


if __name__ == "__main__":
    main()
