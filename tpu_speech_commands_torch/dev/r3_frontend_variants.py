#!/usr/bin/env python3
"""The CT frontend's mel layouts on the card (counterpart of
`tools/dev/r3_frontend_variants.py`).

    python -m tpu_speech_commands_torch.dev.r3_frontend_variants
        [--batch 8192] [--iters 30]

Variants, each (B, 16000) float32 audio at the default config -> (B, 30,
20) batch-major features, from the CT split kernel (csrc/ct_frontend.cu):

  mel=concat  the (F, F) instantiation: each residue's |X|^2 folded into a
              (rows, n_fft / 2 + 1) power tile, one filterbank pass after
  mel=dup     the (F, T) instantiation: the filterbank on each residue's
              unfolded squares against duplicated rows, no power tile

The JAX script's framing='reshape' differs from 'concat' only in how the
TPU's vregs hold the frames; on this card both are the same launch, so it
is printed once and not timed twice.  Each variant's max|delta| against the
production frontend, the FFT kernel (MfccFrontend), is printed on the first
64 rows; RuntimeError above atol 2e-3 + rtol 1e-3 (f32 sums in another
order, magnified by the log: the port's f32 feature bound).  Times are CUDA
events over `--iters` launches, the gain of launch i being 1 + i / 1000, a
device tensor made once, with an on-device checksum checked finite.
"""
from __future__ import annotations

import argparse

import torch

from ..device import resolve_device
from ..ops.frontend_kernel import MfccFrontend
from ..params import pr
from . import best_rate, card_line, check_features, ct_variant, device_audio

N_CHECK = 64
MELS = {"concat": False, "dup": True}  # mel -> per_piece_mel


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
    prod = MfccFrontend(p, "mfcc", dev)
    with torch.inference_mode():
        ref = prod(audio[:N_CHECK])
        rates = {"production": best_rate(prod, audio, gains)}
        print(f"production frontend (FFT kernel): "
              f"{rates['production'] / 1e6:.3f} M windows/s", flush=True)
        for mel, per_piece in MELS.items():
            fn = ct_variant(p, dev, False, per_piece, time_major=False)
            d = check_features(f"mel={mel}", fn(audio[:N_CHECK]), ref)
            print(f"framing=concat mel={mel}: max|delta| vs production = "
                  f"{d:.2e}", flush=True)
            print(f"framing=reshape mel={mel}: the same launch on this card",
                  flush=True)
            rates[mel] = best_rate(fn, audio, gains)
            print(f"mel={mel}: {rates[mel] / 1e6:.3f} M windows/s  "
                  f"({audio.shape[0] * 1e3 / rates[mel]:.4f} ms a batch of "
                  f"{audio.shape[0]})", flush=True)
    print(f"({card})", flush=True)
    return rates


if __name__ == "__main__":
    main()
