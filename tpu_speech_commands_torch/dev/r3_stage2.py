#!/usr/bin/env python3
"""The CT frontend's stage-2 arrangements on the card (counterpart of
`tools/dev/r3_stage2.py`).

    python -m tpu_speech_commands_torch.dev.r3_stage2 [--batch 8192]
        [--iters 30]

Variants, each (B, 16000) float32 audio at the default config -> (30, B,
20) time-major features, from the CT split kernel (csrc/ct_frontend.cu):

  perres  the (F, F) instantiation: one 128-column product per residue
  paired  the (T, F) instantiation: the conjugate residues s and n2 - s
          share one read of the T rows, one 256-column product
  ppmel   the (T, T) instantiation: paired, and the filterbank on the
          unfolded squares of each pair (no power tile)

Each variant's max|delta| against the production frontend, the FFT kernel
(MfccFrontend, batch-major, transposed here), is printed on the first 64
rows; RuntimeError above atol 2e-3 + rtol 1e-3 (the port's f32 feature
bound; the variants are the same math in another summation order).  Times
are CUDA events over `--iters` launches at gains 1 + i / 1000, a device
tensor made once.
"""
from __future__ import annotations

import argparse

import torch

from ..device import resolve_device
from ..ops.frontend_kernel import MfccFrontend
from ..params import pr
from . import best_rate, card_line, check_features, ct_variant, device_audio

N_CHECK = 64
MODES = {"perres": (False, False), "paired": (True, False),
         "ppmel": (True, True)}  # mode -> (paired, per_piece_mel)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=8192)
    ap.add_argument("--iters", type=int, default=30)
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    card = card_line()
    p = pr.replace()
    audio = device_audio(args.batch, p.max_samples, 0, dev)
    gains = 1.0 + torch.arange(args.iters, dtype=torch.float32, device=dev) / 1e3
    rates = {}
    with torch.inference_mode():
        ref = MfccFrontend(p, "mfcc", dev)(audio[:N_CHECK]).transpose(0, 1)
        for mode, (paired, per_piece) in MODES.items():
            fn = ct_variant(p, dev, paired, per_piece, time_major=True)
            d = check_features(mode, fn(audio[:N_CHECK]), ref)
            print(f"{mode}: parity max|d| = {d:.2e}", flush=True)
            rates[mode] = best_rate(fn, audio, gains)
            print(f"{mode:>7}: {rates[mode] / 1e6:6.3f} M w/s = "
                  f"{1e9 / rates[mode]:6.1f} ns/win", flush=True)
    print(f"({card})", flush=True)
    return rates


if __name__ == "__main__":
    main()
