#!/usr/bin/env python3
"""The audio-read floor and the FFT frontend at the serving batch, timed on
the card (counterpart of `tools/dev/r3_experiments.py`).

    python -m tpu_speech_commands_torch.dev.r3_experiments
        [--exp load frontend_tile] [--batch 8192] [--iters 128] [--outer 6]

  load           the load-only kernel (csrc/audio_load.cu, tsc_load_rowsum;
                 the JAX make_load_only): read the audio once, write one
                 float a row.  Its rate is the bandwidth bound of every
                 frontend kernel, which reads the same audio once
  frontend_tile  the FFT frontend kernel (MfccFrontend).  The port's kernels
                 choose their own tiles, so there is one line, not one a
                 batch tile

Each experiment runs `--iters` launches between two CUDA events with the
iteration-dependent gain 1 + 1e-9 i (as the JAX script feeds its scan), sums
every output into an on-device checksum that is fetched and checked finite,
and prints the best of `--outer` runs as windows/s and audio GB/s, beside
the card's name and power limit.  The JAX script's `gru_tile` experiment
drives bench.py, which the port does not have yet.
"""
from __future__ import annotations

import argparse

import torch

from ..device import DEFAULT_DEVICE, resolve_device
from ..ops.frontend_kernel import MfccFrontend
from ..ops.load_kernel import load_rowsum
from ..params import pr
from . import best_rate, card_line, device_audio

EXPERIMENTS = ("load", "frontend_tile")


def make_load_only(device=DEFAULT_DEVICE):
    """(B, S) float32 audio on `device`, gain -> (B, 1) float32 sum of
    audio * gain over each row: the kernel on CUDA, the plain version on the
    CPU."""
    device = resolve_device(device)

    def fn(audio: torch.Tensor, gain) -> torch.Tensor:
        if audio.device.type != device.type:
            raise ValueError(f"load-only built for {device}, audio on "
                             f"{audio.device}")
        return load_rowsum(audio, gain)

    return fn


def gains(k_inner: int, device) -> torch.Tensor:
    """(k_inner,) float32 gains 1 + 1e-9 i, computed in float32 as the JAX
    script's scan does (so the first ~60 round to 1)."""
    i = torch.arange(k_inner, dtype=torch.float32, device=device)
    return 1.0 + 1e-9 * i


def measure(fn, audio: torch.Tensor, k_inner: int = 128, outer: int = 6) -> float:
    """Best windows/s over `outer` runs of k_inner calls fn(audio, gain_i),
    timed with CUDA events; the on-device checksum must be finite."""
    return best_rate(fn, audio, gains(k_inner, audio.device), outer)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--exp", nargs="+", default=list(EXPERIMENTS),
                    choices=EXPERIMENTS)
    ap.add_argument("--batch", type=int, default=8192)
    ap.add_argument("--iters", type=int, default=128)
    ap.add_argument("--outer", type=int, default=6)
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    card = card_line()
    bytes_per_window = pr.max_samples * 4
    audio = device_audio(args.batch, pr.max_samples, 0, dev)
    rates = {}
    with torch.inference_mode():
        if "load" in args.exp:
            rates["load"] = measure(make_load_only(dev), audio, args.iters,
                                    args.outer)
        if "frontend_tile" in args.exp:
            fe = MfccFrontend(pr, "mfcc", dev)
            rates["frontend_tile"] = measure(fe, audio, args.iters, args.outer)
    for name, r in rates.items():
        print(f"{name}: {r / 1e6:.3f} M windows/s = "
              f"{r * bytes_per_window / 1e9:.0f} GB/s of audio, B = "
              f"{args.batch}  ({card})", flush=True)
    return rates


if __name__ == "__main__":
    main()
