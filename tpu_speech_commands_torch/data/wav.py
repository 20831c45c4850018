"""Wav and PCM codec utilities (counterpart of
`tpu_speech_commands/data/wav.py`, a copy on the port's `pr`).

Stdlib-`wave`-based: 16-bit PCM read/write, mono mixdown, polyphase
resampling to the configured rate.
"""
from __future__ import annotations

import wave

import numpy as np

from ..params import pr

INT16_SCALE = float(np.iinfo(np.int16).max + 1)  # 32768, matches data_utils.py:21


def buffer_to_audio(buffer: bytes) -> np.ndarray:
    """Raw mono 16-bit LE PCM bytes -> float32 array in [-1, 1)."""
    if pr.sample_depth != 2:
        raise ValueError("only support 16-bit sample depth.")
    return np.frombuffer(buffer, dtype="<i2").astype(np.float32) / INT16_SCALE


def audio_to_buffer(audio: np.ndarray) -> bytes:
    """float audio -> raw mono 16-bit LE PCM bytes (inverse of buffer_to_audio).

    Clamped to the int16 range: without it a full-scale +1.0 sample
    (32768) wraps to -32768 — a polarity glitch save_audio already
    guards against."""
    if pr.sample_depth != 2:
        raise ValueError("only support 16-bit sample depth.")
    scaled = np.clip(np.asarray(audio) * INT16_SCALE, -32768, 32767)
    return scaled.astype("<i2").tobytes()


def save_audio(filename: str, audio: np.ndarray, sample_rate: int | None = None):
    """Save float audio to a 16-bit PCM wav (data_utils.py:37-47)."""
    if pr.sample_depth != 2:
        raise ValueError("only support 16-bit sample depth.")
    rate = sample_rate or pr.sample_rate
    pcm = (np.clip(np.asarray(audio), -1.0, 1.0) * np.iinfo(np.int16).max).astype(
        "<i2"
    )
    with wave.open(filename, "wb") as wf:
        wf.setnchannels(1)
        wf.setsampwidth(2)
        wf.setframerate(rate)
        wf.writeframes(pcm.tobytes())


def load_wav(path: str, sample_rate: int | None = None, mono: bool = True) -> np.ndarray:
    """Load a wav file as float32 in [-1, 1), resampled to `sample_rate`.

    Replaces librosa.load in get_mfcc_feature (data_utils.py:89-97): mono
    mixdown by channel average, polyphase resampling when rates differ.
    Supports 8/16/32-bit integer PCM.
    """
    target_rate = sample_rate or pr.sample_rate
    try:
        with wave.open(path, "rb") as wf:
            n_channels = wf.getnchannels()
            sampwidth = wf.getsampwidth()
            rate = wf.getframerate()
            raw = wf.readframes(wf.getnframes())
    except (wave.Error, EOFError):
        # stdlib wave rejects WAVE_FORMAT_EXTENSIBLE (0xFFFE) and some
        # nonstandard chunk layouts; fall back to a manual RIFF parse
        n_channels, sampwidth, rate, raw = _parse_riff(path)

    if sampwidth == 2:
        data = np.frombuffer(raw, dtype="<i2").astype(np.float32) / INT16_SCALE
    elif sampwidth == 1:  # 8-bit wav is unsigned
        data = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    elif sampwidth == 3:  # 24-bit: widen to int32 with sign extension
        b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
        as32 = (
            b[:, 0].astype(np.int32)
            | (b[:, 1].astype(np.int32) << 8)
            | (b[:, 2].astype(np.int32) << 16)
        )
        as32 = np.where(as32 >= 1 << 23, as32 - (1 << 24), as32)
        data = as32.astype(np.float32) / float(1 << 23)
    elif sampwidth == 4:
        data = np.frombuffer(raw, dtype="<i4").astype(np.float32) / float(2 ** 31)
    else:
        raise ValueError(f"unsupported wav sample width: {sampwidth}")

    if n_channels > 1:
        data = data.reshape(-1, n_channels)
        data = data.mean(axis=1) if mono else data

    if rate != target_rate:
        from scipy.signal import resample_poly
        from math import gcd

        g = gcd(target_rate, rate)
        data = resample_poly(data, target_rate // g, rate // g, axis=0).astype(
            np.float32
        )
    return data


def _parse_riff(path: str):
    """Minimal RIFF/WAVE parser for PCM files the stdlib rejects
    (WAVE_FORMAT_EXTENSIBLE etc.).  Returns (channels, sampwidth, rate, raw)."""
    import struct

    with open(path, "rb") as f:
        header = f.read(12)
        if header[:4] != b"RIFF" or header[8:12] != b"WAVE":
            raise ValueError(f"not a RIFF/WAVE file: {path}")
        fmt = None
        data = None
        while True:
            chunk = f.read(8)
            if len(chunk) < 8:
                break
            cid, size = chunk[:4], struct.unpack("<I", chunk[4:])[0]
            payload = f.read(size + (size & 1))[:size]
            if cid == b"fmt ":
                fmt = payload
            elif cid == b"data":
                data = payload
                if fmt is not None:
                    break
    if fmt is None or data is None:
        raise ValueError(f"missing fmt/data chunk: {path}")
    audio_format, channels, rate = struct.unpack("<HHI", fmt[:8])
    bits = struct.unpack("<H", fmt[14:16])[0]
    if audio_format == 0xFFFE and len(fmt) >= 26:  # extensible: real fmt in GUID
        audio_format = struct.unpack("<H", fmt[24:26])[0]
    if audio_format != 1:
        raise ValueError(f"only PCM wav supported (format {audio_format}): {path}")
    return channels, bits // 8, rate, data


def wav_duration_samples(path: str) -> tuple[int, int]:
    """(n_frames, sample_rate) without decoding the payload.

    Falls back to the RIFF parser for headers stdlib `wave` rejects
    (e.g. WAVE_FORMAT_EXTENSIBLE) so the files load_wav accepts can
    also be probed."""
    try:
        with wave.open(path, "rb") as wf:
            return wf.getnframes(), wf.getframerate()
    except (wave.Error, EOFError):
        channels, bps, rate, data = _parse_riff(path)
        if channels < 1 or bps < 1:
            raise ValueError(f"malformed wav header (channels={channels}, "
                             f"bytes/sample={bps}): {path}")
        return len(data) // (channels * bps), rate
