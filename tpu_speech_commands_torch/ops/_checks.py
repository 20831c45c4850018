"""Argument checks and constant uploads shared by the frontend kernels'
wrappers (`frontend_kernel`, `ct_kernel`, `dense_dft_kernel`)."""
from __future__ import annotations

import numpy as np
import torch

from ..params import ListenerParams

OUT_DTYPES = (torch.float32, torch.bfloat16)


def row_major(m: np.ndarray, device, dtype=np.float32) -> torch.Tensor:
    """A row-major device copy: the matrix functions return transposed views,
    and torch.tensor keeps a view's column-major strides."""
    return torch.tensor(np.ascontiguousarray(m, dtype=dtype), device=device)


def check_row_major(tensors, shapes) -> None:
    for t, shape in zip(tensors, shapes):
        if tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"kernel constant {tuple(t.shape)} is not a "
                             f"row-major {shape}")


def check_launch(audio, gain, device, p: ListenerParams, out_dtype) -> int:
    """Check a frontend launch's arguments; return the number of frames the
    audio yields."""
    if not audio.is_cuda or audio.device != device:
        raise ValueError(
            f"audio on {audio.device}, kernel constants on {device}"
        )
    if audio.dtype not in (torch.float32, torch.int16):
        raise TypeError(f"audio must be float32 or int16, got {audio.dtype}")
    if audio.ndim != 2 or not audio.is_contiguous():
        raise ValueError(
            f"audio must be a contiguous (B, S) tensor, got shape "
            f"{tuple(audio.shape)} contiguous={audio.is_contiguous()}"
        )
    if (gain.dtype != torch.float32 or gain.numel() != 1
            or gain.device != audio.device):
        raise ValueError("gain must be one float32 value on the audio's device")
    if out_dtype not in OUT_DTYPES:
        raise TypeError(f"out_dtype must be float32 or bfloat16, got {out_dtype}")
    n_samples = audio.shape[1]
    need = p.window_samples + (p.n_features - 1) * p.hop_samples
    if n_samples < need:
        raise ValueError(
            f"audio length {n_samples} yields fewer than "
            f"n_features={p.n_features} frames (need >= {need} samples)"
        )
    return 1 + (n_samples - p.window_samples) // p.hop_samples
