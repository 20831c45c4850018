#!/usr/bin/env python3
"""Stage-omission profile of the frontend kernels on the card (counterpart
of `tools/dev/r3_omission.py`): the CT split kernel and the FFT kernel, each
cut after every stage (`ops/omission_kernel.py`), streamed and with a
constant block.

    python -m tpu_speech_commands_torch.dev.r3_omission [--batch 8192]
        [--iters 32] [--outer 3]

For each kernel (ct, fft) and each of streamed and constant-block, every cut
is first held to `truncated_plain` on the card on the first 64 rows
(RuntimeError outside `TOLERANCES`), then timed with `best_rate`: `--iters`
launches between CUDA events with the gains 1 + 1e-9 i (a device tensor made
once), every output summed into an on-device checksum, the best of
`--outer`.  It prints each stage's M windows/s, ns a window and the delta
from the stage before, beside the card's name and power limit.  The
constant block (16 windows, 1 MB of f32 audio) stays in L2 on the card: the
compute-only profile reads no device memory, but it still reads.
"""
from __future__ import annotations

import argparse

import torch

from ..device import resolve_device
from ..ops.omission_kernel import (KERNELS, TruncatedConstants, truncated,
                                   truncated_plain)
from ..params import ListenerParams
from . import FEAT_ATOL, FEAT_RTOL, best_rate, card_line, check_features, device_audio
from .r3_experiments import gains

CHECK_ROWS = 64
# Each cut against the plain version, with the reason:
# - load .. mel: f32 sums of up to 30 x 8 audio terms, or of 30 x 513 powers,
#   in another order (~1e-6 relative; the energy lane reaches ~1e4);
# - log, full: the per-frame f32 feature bound (FEAT_ATOL, FEAT_RTOL; the
#   log magnifies the error of a small mel energy) summed over 30 frames.
_SUMS = (1e-3, 1e-4)
TOLERANCES = {**dict.fromkeys(("load", "framing", "butterfly", "power", "mel"),
                              _SUMS),
              "log": (30 * FEAT_ATOL, FEAT_RTOL),
              "full": (30 * FEAT_ATOL, FEAT_RTOL)}


def cut(consts: TruncatedConstants, p: ListenerParams, kernel: str,
        stage: str, constant_block: bool):
    """fn(audio, gain) -> (B, 128): kernel `kernel` cut after `stage` (the
    plain version for CPU tensors)."""
    return lambda audio, gain=None: truncated(audio, gain, consts, p, stage,
                                              kernel, constant_block)


def check_cut(label: str, fn, audio: torch.Tensor, consts: TruncatedConstants,
              p: ListenerParams, stage: str, constant_block: bool,
              gain=None) -> float:
    """max|fn - truncated_plain| on `audio`; RuntimeError outside the stage's
    bound."""
    want = truncated_plain(audio, gain, p, stage, constant_block, consts.ct)
    return check_features(label, fn(audio, gain), want, *TOLERANCES[stage])


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=8192)
    ap.add_argument("--iters", type=int, default=32)
    ap.add_argument("--outer", type=int, default=3)
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    card = card_line()
    print(card, flush=True)
    p = ListenerParams()
    consts = TruncatedConstants(p, dev)
    audio = device_audio(args.batch, p.max_samples, 0, dev)
    g = gains(args.iters, dev)
    rates = {}
    with torch.inference_mode():
        for kernel, stages in KERNELS.items():
            for const in (False, True):
                label = ("compute-only (constant block)" if const
                         else "streamed")
                print(f"-- {kernel} kernel, {label}, B = {args.batch} --",
                      flush=True)
                prev_ns = None
                for stage in stages:
                    fn = cut(consts, p, kernel, stage, const)
                    check_cut(f"{kernel} {stage} {label}", fn,
                              audio[:CHECK_ROWS], consts, p, stage, const)
                    r = best_rate(fn, audio, g, args.outer)
                    rates[(kernel, stage, const)] = r
                    ns = 1e9 / r
                    delta = ("" if prev_ns is None
                             else f"  ({ns - prev_ns:+.1f} ns/win)")
                    print(f"{stage:>10}: {r / 1e6:7.3f} M w/s = {ns:6.1f} "
                          f"ns/win{delta}", flush=True)
                    prev_ns = ns
    print(f"({card})", flush=True)
    return rates


if __name__ == "__main__":
    main()
