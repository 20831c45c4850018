"""Float64 NumPy oracle of the feature frontend (counterpart of
`tpu_speech_commands/frontend/numpy_ref.py`, the same functions and the
same reference quirks).

The filterbanks and the DCT matrix come from `frontend/filterbanks.py`,
whose float64 matrices the port's frontends also take their float32
constants from: one copy of the construction.  The comparator
(`mfcc_feature`) and the spectrogram tool (`plot_spectrogram`) read
features from here, and tests may use it as the oracle on the port's side.

Quirks kept on purpose (PARITY.md): a rectangular window, no pre-emphasis;
power = |rfft|^2 / n_fft; the mel grid's high edge at the sample rate; the
bark filterbank's default-constant bin mapping; safe_log clamped at float64
eps; coefficient 0 replaced by the log of the frame's total power.
"""
from __future__ import annotations

import numpy as np

from ..params import pr
from .filterbanks import LOG_EPS, bark_filterbanks, dct_matrix, mel_filterbanks


def safe_log(x):
    """log with a clamp at float64 eps: no log(0) or log(<0)."""
    return np.log(np.clip(x, LOG_EPS, None))


def chop_array(arr, window_size, hop_size):
    """The full rectangular windows of `arr` at stride `hop_size`, a list of
    views; a trailing partial window is dropped."""
    arr = np.asarray(arr)
    n_frames = (1 + (len(arr) - window_size) // hop_size
                if len(arr) >= window_size else 0)
    return [arr[t * hop_size: t * hop_size + window_size]
            for t in range(n_frames)]


def power_spec(audio: np.ndarray, window_stride, fft_size):
    """|rfft|^2 / fft_size of the rectangular frames, each zero-padded (or
    cut) to fft_size: (frames, fft_size // 2 + 1)."""
    window_size, hop_size = window_stride
    frames = chop_array(audio, window_size, hop_size)
    if not frames:
        return np.empty((0, fft_size // 2 + 1))
    spectrum = np.fft.rfft(np.stack(frames), n=fft_size)
    return (np.abs(spectrum) ** 2) / fft_size


def dct_ortho(x: np.ndarray) -> np.ndarray:
    """DCT-II with ortho norm along the last axis."""
    return x @ dct_matrix(x.shape[-1]).T


def mel_spec(audio, sample_rate, window_stride=(160, 80), fft_size=512,
             num_filt=20):
    """Log-mel spectrogram; returns (mels, powers)."""
    powers = power_spec(audio, window_stride, fft_size)
    if powers.size == 0:
        return np.empty((0, num_filt)), powers
    filters = mel_filterbanks(sample_rate, num_filt, powers.shape[1])
    return safe_log(powers @ filters.T), powers


def mfcc_spec(audio, sample_rate, window_stride=(160, 80), fft_size=512,
              num_filt=20, num_coeffs=13):
    """MFCC features (frames, num_coeffs); coefficient 0 is the log of the
    frame's total power."""
    mels, powers = mel_spec(audio, sample_rate, window_stride, fft_size,
                            num_filt)
    if len(mels) == 0:
        return np.empty((0, min(num_filt, num_coeffs)))
    mfccs = dct_ortho(mels)[:, :num_coeffs]
    mfccs[:, 0] = safe_log(np.sum(powers, 1))
    return mfccs


def bark_spec(audio, sample_rate, window_size, hop_size, fft_size=512,
              num_filt=24):
    """Log bark spectrogram."""
    powers = power_spec(audio, (window_size, hop_size), fft_size)
    filterbanks = bark_filterbanks(nfilts=num_filt, nfft=fft_size,
                                   sample_rate=sample_rate)
    return safe_log(powers @ filterbanks.T)


def bfcc_spec(audio, sample_rate, window_size, hop_size, fft_size=512,
              num_filt=26, num_coeffs=13):
    """BFCC features (frames, num_coeffs); coefficient 0 is the log of the
    frame's total power."""
    powers = power_spec(audio, (window_size, hop_size), fft_size)
    if powers.size == 0:
        return np.empty((0, min(num_filt, num_coeffs)))
    filterbanks = bark_filterbanks(nfilts=num_filt, nfft=fft_size,
                                   sample_rate=sample_rate)
    bfccs = dct_ortho(safe_log(powers @ filterbanks.T))[:, :num_coeffs]
    bfccs[:, 0] = safe_log(np.sum(powers, 1))
    return bfccs


def add_deltas(features: np.ndarray) -> np.ndarray:
    """Backward-difference deltas on the last axis: deltas[i] = f[i] -
    f[i - 1], deltas[0] = 0."""
    deltas = np.zeros_like(features)
    deltas[1:] = features[1:] - features[:-1]
    return np.concatenate([features, deltas], -1)


def vectorize_raw(audio: np.ndarray, params=None,
                  frontend: str = "mfcc") -> np.ndarray:
    """Audio -> feature vectors, no length clipping."""
    p = params or pr
    if len(audio) == 0:
        raise ValueError("Cannot vectorize empty audio!")
    if frontend == "mfcc":
        return mfcc_spec(audio, p.sample_rate,
                         (p.window_samples, p.hop_samples), fft_size=p.n_fft,
                         num_filt=p.n_filt, num_coeffs=p.n_mfcc)
    if frontend == "bark":
        return bfcc_spec(audio, p.sample_rate, p.window_samples,
                         p.hop_samples, fft_size=p.n_fft, num_filt=p.n_filt,
                         num_coeffs=p.n_mfcc)
    raise ValueError(f"unknown frontend: {frontend}")


def audio_to_feature(audio_data: np.ndarray, params=None,
                     frontend: str = "mfcc"):
    """Truncate to max_samples, left-pad with zeros, vectorize (+ deltas)."""
    p = params or pr
    audio_data = audio_data[: p.max_samples]
    if len(audio_data) < p.max_samples:
        audio_data = np.concatenate(
            [np.zeros((p.max_samples - len(audio_data),)), audio_data])
    feature = vectorize_raw(audio_data, p, frontend)
    if p.use_delta:
        feature = add_deltas(feature)
    return feature
