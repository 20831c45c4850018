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
         tsc_dense_dft_combined): the whole DFT as one dense product.  This
         is not the function the JAX script's `dense` times: there it is
         make_fused_frontend(dft_mode="dense"), the production frontend's
         f32 contract with the gain applied on every call, and the port has
         no dense kernel of that contract (it runs on the FFT kernel, `ct`
         above).  The combined kernel is make_combined_kernel's contract:
         the same DFT work and epilogue, but no gain and every frame of the
         window kept, so the gain is not applied
  load   the load-only kernel broadcast to the frontend's output size
         (csrc/audio_load.cu, tsc_load_broadcast): the audio-read floor

For ct and dense, "max|err|" is the largest difference from a float64
reference (numpy's rfft, the float64 filterbank and DCT) on the first 64
rows; RuntimeError if any element is further from it than atol 2e-3 +
rtol 1e-3 of the reference (f32 sums, magnified by the log of a small mel
energy: the bound the port's f32 features are held to everywhere).  The
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
from ..ops.frontend_kernel import MfccFrontend
from ..ops.load_kernel import load_broadcast
from ..params import ListenerParams, pr
from . import best_rate, card_line, device_audio
from .pallas_experiments import make_combined_kernel

N_CHECK = 64
ORACLE_ATOL, ORACLE_RTOL = 2e-3, 1e-3


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
    oracle = torch.tensor(oracle_mfcc(small.cpu().numpy(), p),
                          dtype=torch.float32)
    gains = torch.arange(1, args.iters + 1, dtype=torch.float32, device=dev)

    def measure(label, fn, check=None):
        err = ""
        if check is not None:
            got = check(small).cpu()
            if not torch.isfinite(got).all():
                raise RuntimeError(f"{label}: output is not finite")
            diff = (got - oracle).abs()
            err = f"max|err| vs f64 reference = {float(diff.max()):.2e}"
            if (diff > ORACLE_ATOL + ORACLE_RTOL * oracle.abs()).any():
                raise RuntimeError(f"{label}: {err}, outside atol "
                                   f"{ORACLE_ATOL:g} + rtol {ORACLE_RTOL:g}")
        rate = best_rate(fn, audio, gains)
        print(f"{label:10s}: {rate / 1e6:7.3f} M windows/s   {err}", flush=True)
        return rate

    ct = MfccFrontend(p, "mfcc", dev)
    dense = make_combined_kernel(dev)
    out_cols = p.n_features * p.n_mfcc
    with torch.inference_mode():
        rates = {
            "ct": measure("ct", ct, ct),
            "dense": measure("dense", lambda a, g: dense(a),
                             lambda a: dense(a)[:, -p.n_features:]),
            "load": measure("load", lambda a, g: load_broadcast(a, g, out_cols)),
        }
    print(f"\nbaseline ct = {rates['ct'] / 1e6:.3f} M windows/s at B = "
          f"{args.batch}; dense is the whole DFT as one product; load is the "
          f"audio-read floor  ({card})", flush=True)
    return rates


if __name__ == "__main__":
    main()
