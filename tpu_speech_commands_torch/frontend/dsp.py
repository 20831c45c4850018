"""Plain PyTorch feature frontend (counterpart of
`tpu_speech_commands/frontend/dsp.py`).

    frames  = unfold(audio)                  # (..., T, W) rectangular window
    re, im  = frames @ C, frames @ S         # real DFT as two matmuls
    power   = (re^2 + im^2) / n_fft
    mels    = safe_log(power @ M)            # mel or bark filterbank
    coeffs  = mels @ D^T [, :n_mfcc]         # DCT-II ortho
    coeffs[..., 0] = safe_log(sum(power))    # energy-coefficient swap

This chain is the plain version of the frontend kernel
(`ops/frontend_kernel.py`, `csrc/mfcc_frontend.cu`): the CPU path, and what
the kernel is held against on the card.
"""
from __future__ import annotations

import torch

from ..params import ListenerParams, pr
from .filterbanks import LOG_EPS, dct_t_matrix, dft_matrices, filterbank_matrix

# The JAX frontend runs its matmuls at Precision.HIGHEST.  TF32 keeps about
# three decimal digits, which moves log-mel features by ~1e-2 on the card:
# pin full float32 for every matmul of the port.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def safe_log(x: torch.Tensor) -> torch.Tensor:
    return torch.log(torch.clamp(x, min=LOG_EPS))


def frame_signal(audio: torch.Tensor, window_samples: int,
                 hop_samples: int) -> torch.Tensor:
    """(..., S) -> (..., T, W): frame t covers samples [t*hop, t*hop + W),
    full windows only (sonopy's chop_array)."""
    return audio.unfold(-1, window_samples, hop_samples)


def add_deltas(features: torch.Tensor) -> torch.Tensor:
    """Backward-difference deltas on axis -2 (time), concatenated on axis -1;
    the first frame's delta is zero."""
    diff = features[..., 1:, :] - features[..., :-1, :]
    deltas = torch.cat([torch.zeros_like(features[..., :1, :]), diff], dim=-2)
    return torch.cat([features, deltas], dim=-1)


def decode_audio(audio: torch.Tensor, gain=None) -> torch.Tensor:
    """int16 PCM -> float32 x/32768, then times the optional gain.  The
    decode comes first: `audio * gain` on int16 would skip the /32768."""
    if audio.dtype == torch.int16:
        audio = audio.to(torch.float32) * (1.0 / 32768.0)
    elif audio.dtype != torch.float32:
        raise TypeError(f"audio must be float32 or int16, got {audio.dtype}")
    if gain is not None:
        audio = audio * torch.as_tensor(gain, dtype=torch.float32,
                                        device=audio.device)
    return audio


class Frontend:
    """Batched feature frontend bound to a snapshot of a ListenerParams.

    feature_type: 'mfcc' (mel) or 'bark'.  Called on (B, S) float32 audio in
    [-1, 1] or int16 PCM; returns (B, n_features, feature_size) float32.
    """

    def __init__(self, params: ListenerParams | None = None,
                 feature_type: str = "mfcc", device="cpu"):
        # snapshot: a later inject_params must not mix new scalar config
        # (n_fft normalisation, framing) with the matrices built here
        p = (params or pr).replace()
        self.params = p
        self.feature_type = feature_type
        self.device = torch.device(device)
        filt = filterbank_matrix(p, feature_type)
        cos, sin = dft_matrices(p.window_samples, p.n_fft)

        def dev(m):
            return torch.tensor(m, dtype=torch.float32, device=self.device)

        self._cos, self._sin = dev(cos), dev(sin)
        self._filt = dev(filt)
        self._dct_t = dev(dct_t_matrix(p.n_filt))
        frames_from_max = (
            1 + (p.max_samples - p.window_samples) // p.hop_samples
            if p.max_samples >= p.window_samples else 0
        )
        if frames_from_max < p.n_features:
            raise ValueError(
                f"config yields {frames_from_max} frames from max_samples "
                f"but the model contract needs n_features={p.n_features}"
            )

    def power_from_frames(self, frames: torch.Tensor) -> torch.Tensor:
        """(..., W) frames -> (..., n_fft // 2 + 1) power spectrum."""
        re = torch.matmul(frames, self._cos)
        im = torch.matmul(frames, self._sin)
        return (re * re + im * im) / self.params.n_fft

    def features_from_frames(self, frames: torch.Tensor) -> torch.Tensor:
        """(..., W) frames -> (..., n_mfcc) cepstral features, no deltas."""
        p = self.params
        powers = self.power_from_frames(frames)
        mels = safe_log(torch.matmul(powers, self._filt))
        coeffs = torch.matmul(mels, self._dct_t)[..., : p.n_mfcc]
        energy = safe_log(powers.sum(dim=-1, keepdim=True))
        return torch.cat([energy, coeffs[..., 1:]], dim=-1)

    def __call__(self, audio: torch.Tensor, gain=None) -> torch.Tensor:
        """(..., S) float32 or int16 audio -> (..., n_features,
        feature_size) float32, the tail-aligned n_features frames."""
        p = self.params
        need = p.window_samples + (p.n_features - 1) * p.hop_samples
        if audio.shape[-1] < need:
            raise ValueError(
                f"audio length {audio.shape[-1]} yields fewer than "
                f"n_features={p.n_features} frames (need >= {need} "
                "samples); pad_audio to max_samples first"
            )
        audio = decode_audio(audio, gain)
        frames = frame_signal(audio, p.window_samples, p.hop_samples)
        # framing max_samples can give one frame more than the model
        # contract for some hop roundings: keep the tail-aligned rows
        frames = frames[..., -p.n_features:, :]
        feats = self.features_from_frames(frames)
        if p.use_delta:
            feats = add_deltas(feats)
        return feats

    def pad_audio(self, audio: torch.Tensor) -> torch.Tensor:
        """Truncate or left-zero-pad the last axis to max_samples (the
        command sits at the buffer tail)."""
        n, m = audio.shape[-1], self.params.max_samples
        if n >= m:
            return audio[..., :m]
        return torch.nn.functional.pad(audio, (m - n, 0))
