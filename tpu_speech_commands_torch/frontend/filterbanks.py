"""Constant matrices of the feature frontend, built in float64 numpy and
stored as float32 (counterpart of the matrix functions in
`tpu_speech_commands/frontend/numpy_ref.py` and `frontend/dsp.py:49-87`).

Reference quirks kept on purpose (PARITY.md):
- the mel grid's high edge sits at `sample_rate`, not at Nyquist, and a mel
  point maps to bin int(freq * fft_len / sample_rate);
- the bark filterbank maps bark points to FFT bins with the default
  constants `_BARK_DEFAULT_SR` / `_BARK_DEFAULT_NFFT`, whatever sample rate
  and FFT size it is asked for;
- safe_log clamps at float64 eps.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np

LOG_EPS = float(np.finfo(np.float64).eps)

_BARK_DEFAULT_SR = 16000
_BARK_DEFAULT_NFFT = 512


def hertz_to_mels(f):
    return 1127.0 * np.log(1.0 + np.asarray(f, dtype=np.float64) / 700.0)


def mels_to_hertz(mel):
    return 700.0 * (np.exp(np.asarray(mel, dtype=np.float64) / 1127.0) - 1.0)


@lru_cache()
def mel_filterbanks(sample_rate: int, num_filt: int, fft_len: int) -> np.ndarray:
    """Triangular mel filterbank, (num_filt, fft_len) float64; fft_len is the
    number of rfft bins (n_fft // 2 + 1)."""
    grid_mels = np.linspace(
        hertz_to_mels(0.0), hertz_to_mels(float(sample_rate)), num_filt + 2
    )
    grid_hertz = mels_to_hertz(grid_mels)
    grid_indices = (grid_hertz * fft_len / sample_rate).astype(int)

    banks = np.zeros((num_filt, fft_len))
    for i, (left, middle, right) in enumerate(
        zip(grid_indices, grid_indices[1:], grid_indices[2:])
    ):
        left_c, middle_c, right_c = (
            min(left, fft_len), min(middle, fft_len), min(right, fft_len)
        )
        if middle_c > left_c:
            banks[i, left_c:middle_c] = (
                np.arange(left_c, middle_c) - left
            ) / float(middle - left)
        if right_c > middle_c:
            banks[i, middle_c:right_c] = (
                right - np.arange(middle_c, right_c)
            ) / float(right - middle)
    return banks


def hz2bark(f):
    return 6.0 * np.arcsinh(np.asarray(f, dtype=np.float64) / 600.0)


def bark2hz(fb):
    return 600.0 * np.sinh(np.asarray(fb, dtype=np.float64) / 6.0)


def fft2bark(j, sample_rate=_BARK_DEFAULT_SR, nfft=_BARK_DEFAULT_NFFT):
    return hz2bark((np.asarray(j, dtype=np.float64) * sample_rate) / (nfft + 1))


def bark2fft(fb, sample_rate=_BARK_DEFAULT_SR, nfft=_BARK_DEFAULT_NFFT):
    return (nfft + 1) * bark2hz(fb) / sample_rate


def _bark_filter_gain(fb: float, fc: float) -> float:
    if fc - 2.5 <= fb <= fc - 0.5:
        return 10 ** (2.5 * (fb - fc + 0.5))
    elif fc - 0.5 < fb < fc + 0.5:
        return 1.0
    elif fc + 0.5 <= fb <= fc + 1.3:
        return 10 ** (-2.5 * (fb - fc - 0.5))
    return 0.0


@lru_cache()
def bark_filterbanks(nfilts=20, nfft=512, sample_rate=16000, low_freq=0,
                     high_freq=None) -> np.ndarray:
    """Bark filterbank, (nfilts, nfft // 2 + 1) float64, with the reference's
    default-constant bin mapping."""
    high_freq = high_freq or sample_rate / 2
    bark_points = np.linspace(hz2bark(low_freq), hz2bark(high_freq),
                              nfilts + 4)
    bins = np.floor(bark2fft(bark_points))
    fbank = np.zeros((nfilts, nfft // 2 + 1))
    for i in range(nfilts):
        fc = bark_points[i + 2]
        for j in range(int(bins[i]), int(bins[i + 4])):
            if j >= fbank.shape[1]:
                break
            fbank[i, j] = _bark_filter_gain(float(fft2bark(j)), float(fc))
    return np.abs(fbank)


@lru_cache()
def dct_matrix(n: int) -> np.ndarray:
    """Orthonormal DCT-II matrix D (float64) with y = D @ x."""
    k = np.arange(n)[:, None]
    m = np.arange(n)[None, :]
    d = np.cos(np.pi * (2 * m + 1) * k / (2 * n)) * np.sqrt(2.0 / n)
    d[0] *= np.sqrt(0.5)
    return d


@lru_cache()
def dft_matrices(window_samples: int, n_fft: int):
    """Real and imaginary DFT matrices (W, n_fft // 2 + 1), float32: frames
    @ cos, frames @ sin equal np.fft.rfft(frame, n=n_fft) (frames longer
    than n_fft are truncated, shorter ones zero-padded)."""
    n_bins = n_fft // 2 + 1
    n_used = min(window_samples, n_fft)
    n = np.arange(n_used, dtype=np.float64)[:, None]
    k = np.arange(n_bins, dtype=np.float64)[None, :]
    angle = -2.0 * np.pi * n * k / n_fft
    cos = np.zeros((window_samples, n_bins))
    sin = np.zeros((window_samples, n_bins))
    cos[:n_used] = np.cos(angle)
    sin[:n_used] = np.sin(angle)
    return cos.astype(np.float32), sin.astype(np.float32)


@lru_cache()
def mel_matrix(sample_rate: int, num_filt: int, fft_len: int) -> np.ndarray:
    """(fft_len, num_filt) float32, the transposed mel filterbank."""
    return mel_filterbanks(sample_rate, num_filt, fft_len).T.astype(np.float32)


@lru_cache()
def bark_matrix(sample_rate: int, num_filt: int, n_fft: int) -> np.ndarray:
    """(n_fft // 2 + 1, num_filt) float32, the transposed bark filterbank."""
    return bark_filterbanks(
        nfilts=num_filt, nfft=n_fft, sample_rate=sample_rate
    ).T.astype(np.float32)


@lru_cache()
def dct_t_matrix(n: int) -> np.ndarray:
    """(n, n) float32, the transposed orthonormal DCT-II matrix."""
    return dct_matrix(n).T.astype(np.float32)


def filterbank_matrix(params, feature_type: str) -> np.ndarray:
    """(n_fft // 2 + 1, n_filt) float32 filterbank of a config: 'mfcc' (mel)
    or 'bark'."""
    if feature_type == "mfcc":
        return mel_matrix(params.sample_rate, params.n_filt, params.n_fft_bins)
    if feature_type == "bark":
        return bark_matrix(params.sample_rate, params.n_filt, params.n_fft)
    raise ValueError(f"unknown feature_type: {feature_type}")
