#!/usr/bin/env python3
"""The dense-DFT frontend variants, timed on the card (counterpart of
`tools/dev/pallas_experiments.py`).

    python -m tpu_speech_commands_torch.dev.pallas_experiments [variant ...]
        [--batch 16384] [--iters 128] [--repeats 4]

Variants, each (B, 16000) float32 audio -> MFCC features:

  combined  the f32 dense-DFT kernel, cos|sin as one (W, 2 bins) matrix
            (csrc/dense_dft_frontend.cu, tsc_dense_dft_combined; the JAX
            make_combined_kernel)
  reshape   the same for window == 2 hop as two half-window products of the
            hop blocks (tsc_dense_dft_halves; make_reshape_kernel)
  bf16mat   the bf16 tensor-core DFT kernel, MfccFrontend(fast_math=True)
            (csrc/dft_frontend.cu; make_bf16_kernel)
  fft       the FFT kernel, MfccFrontend (csrc/mfcc_frontend.cu).  It takes
            the place of the JAX script's tile16 / tile32: the port's kernels
            choose their own tiles
  xla       the plain PyTorch chain, frontend/dsp.py::Frontend

Each variant runs `--iters` launches between two CUDA events after one
warm-up launch, keeping an on-device checksum of every output that is
fetched and checked finite at the end; the best of `--repeats` such runs
is printed as windows/s.  `make_combined_kernel` and `make_reshape_kernel`
read the port's global `pr`, as the JAX functions read the JAX package's.
"""
from __future__ import annotations

import argparse

import torch

from ..device import DEFAULT_DEVICE, resolve_device
from ..frontend.dsp import Frontend
from ..ops.dense_dft_kernel import (DenseDftConstants, dense_dft_combined,
                                    dense_dft_halves)
from ..ops.frontend_kernel import MfccFrontend
from ..params import pr
from . import best_rate, card_line, device_audio

BATCH = 16384


def make_combined_kernel(device=DEFAULT_DEVICE):
    """(B, S) float32 audio on `device` -> (B, n_frames, n_mfcc): the
    combined f32 dense-DFT kernel on CUDA, its plain version on the CPU."""
    consts = DenseDftConstants(pr, resolve_device(device))
    return lambda audio: dense_dft_combined(audio, consts)


def make_reshape_kernel(device=DEFAULT_DEVICE):
    """The halves kernel (window == 2 hop, else ValueError), the same
    contract as `make_combined_kernel`."""
    consts = DenseDftConstants(pr, resolve_device(device))
    if consts.halves is None:
        raise ValueError(
            f"make_reshape_kernel needs window == 2 hop, got window "
            f"{pr.window_samples}, hop {pr.hop_samples}")
    return lambda audio: dense_dft_halves(audio, consts)


def variants(device=DEFAULT_DEVICE) -> dict:
    """name -> a function making the variant's audio -> features function
    on `device`."""
    return {
        "combined": lambda: make_combined_kernel(device),
        "reshape": lambda: make_reshape_kernel(device),
        "bf16mat": lambda: MfccFrontend(pr, "mfcc", device, fast_math=True),
        "fft": lambda: MfccFrontend(pr, "mfcc", device),
        "xla": lambda: Frontend(pr, "mfcc", device),
    }


def measure(name, frontend, audio, k_inner: int = 128, repeats: int = 4) -> float:
    """Best windows/s over `repeats` runs of k_inner launches, timed with
    CUDA events; the on-device checksum of every output must be finite."""
    ones = torch.ones(k_inner, dtype=torch.float32, device=audio.device)
    best = best_rate(lambda a, g: frontend(a), audio, ones, repeats)
    print(f"{name}: {best:,.0f} windows/s ({audio.shape[0] * 1e3 / best:.4f} "
          f"ms a batch of {audio.shape[0]})", flush=True)
    return best


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("variants", nargs="*", help="default: all of "
                    + ", ".join(variants()))
    ap.add_argument("--batch", type=int, default=BATCH)
    ap.add_argument("--iters", type=int, default=128)
    ap.add_argument("--repeats", type=int, default=4)
    args = ap.parse_args(argv)
    unknown = sorted(set(args.variants) - set(variants()))
    if unknown:
        ap.error(f"unknown variants {unknown}")
    dev = resolve_device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(card_line(), flush=True)
    audio = device_audio(args.batch, pr.max_samples, 0, dev)
    makers = variants(dev)
    with torch.inference_mode():
        return {name: measure(name, makers[name](), audio, args.iters,
                              args.repeats)
                for name in args.variants or makers}


if __name__ == "__main__":
    main()
