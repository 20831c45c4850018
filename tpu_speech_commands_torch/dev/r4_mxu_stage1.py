#!/usr/bin/env python3
"""The FFT frontend kernel, the f32 dense-DFT kernel and the audio-read
floor side by side on the card (counterpart of `tools/dev/r4_mxu_stage1.py`).

    python -m tpu_speech_commands_torch.dev.r4_mxu_stage1 [--batch 8192]
        [--iters 30]

Variants, each timed over `--iters` calls between two CUDA events (the gain
of call i is i, as in the JAX script's scan), with an on-device checksum
fetched and checked finite:

  ct     the FFT frontend kernel, MfccFrontend (csrc/mfcc_frontend.cu), the
         port's counterpart of the production kernel
  dense  the combined f32 dense-DFT kernel (csrc/dense_dft_frontend.cu,
         tsc_dense_dft_combined): the whole DFT as one dense product, with
         the JAX script's contract, make_fused_frontend(dft_mode="dense")
         in f32: the gain of every call applied (as g^2 on the power) and
         the tail-aligned n_features frames only (first_frame = n_frames -
         n_features)
  load   the load-only kernel broadcast to the frontend's output size
         (csrc/audio_load.cu, tsc_load_broadcast): the audio-read floor

For ct and dense, "max|err|" is the largest difference from a float64
reference (numpy's rfft, the float64 filterbank and DCT) on the first 64
rows at gain 1.5 (the reference takes the gained audio); RuntimeError if
any element is further from it than the port's f32 feature bound
(`FEAT_ATOL` + `FEAT_RTOL` of the reference: f32 sums, magnified by the log
of a small mel energy).  The
JAX script's ct-hi and dense-hi variants are left out: they ran the TPU's
matmuls at HIGHEST precision, and the port's f32 kernels already run in
full f32 (no TF32).
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ..device import resolve_device
from ..frontend.filterbanks import LOG_EPS, dct_matrix, mel_filterbanks
from ..ops.dense_dft_kernel import DenseDftConstants, dense_dft_combined
from ..ops.frontend_kernel import MfccFrontend
from ..ops.load_kernel import load_broadcast
from ..params import ListenerParams, pr
from . import best_rate, card_line, check_features, device_audio

N_CHECK = 64
CHECK_GAIN = 1.5


def oracle_mfcc(audio: np.ndarray, p: ListenerParams) -> np.ndarray:
    """(B, S) audio -> (B, n_features, n_mfcc) float64 MFCCs, the
    tail-aligned n_features of the frames cut from the start, computed with
    numpy's rfft in float64."""
    window, hop = p.window_samples, p.hop_samples
    n_frames = 1 + (audio.shape[1] - window) // hop
    idx = np.arange(n_frames)[:, None] * hop + np.arange(window)
    frames = audio.astype(np.float64)[:, idx]
    power = np.abs(np.fft.rfft(frames, n=p.n_fft)) ** 2 / p.n_fft
    filt = mel_filterbanks(p.sample_rate, p.n_filt, p.n_fft_bins)
    mels = np.log(np.clip(power @ filt.T, LOG_EPS, None))
    coeffs = (mels @ dct_matrix(p.n_filt).T)[..., :p.n_mfcc]
    coeffs[..., 0] = np.log(np.clip(power.sum(-1), LOG_EPS, None))
    return coeffs[:, -p.n_features:]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=8192)
    ap.add_argument("--iters", type=int, default=30)
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    p = pr.replace()
    audio = device_audio(args.batch, p.max_samples, 7, dev)
    small = audio[:N_CHECK]
    oracle = torch.tensor(oracle_mfcc(CHECK_GAIN * small.cpu().numpy(), p),
                          dtype=torch.float32)
    check_gain = torch.full((1,), CHECK_GAIN, dtype=torch.float32, device=dev)
    gains = torch.arange(1, args.iters + 1, dtype=torch.float32, device=dev)

    def measure(label, fn, check=False):
        err = ""
        if check:
            d = check_features(f"{label} vs the float64 reference",
                               fn(small, check_gain).cpu(), oracle)
            err = f"max|err| vs f64 reference = {d:.2e}"
        rate = best_rate(fn, audio, gains)
        print(f"{label:10s}: {rate / 1e6:7.3f} M windows/s   {err}", flush=True)
        return rate

    ct = MfccFrontend(p, "mfcc", dev)
    dense_consts = DenseDftConstants(p, dev)
    first_frame = 1 + (p.max_samples - p.window_samples) // p.hop_samples \
        - p.n_features
    out_cols = p.n_features * p.n_mfcc
    with torch.inference_mode():
        rates = {
            "ct": measure("ct", ct, True),
            "dense": measure("dense", lambda a, g: dense_dft_combined(
                a, dense_consts, g, first_frame), True),
            "load": measure("load", lambda a, g: load_broadcast(a, g, out_cols)),
        }
    print(f"\nbaseline ct = {rates['ct'] / 1e6:.3f} M windows/s at B = "
          f"{args.batch}; dense is the whole DFT as one product, with the "
          f"gain and the last n_features frames; load is the audio-read "
          f"floor  ({card})", flush=True)
    return rates


if __name__ == "__main__":
    main()
