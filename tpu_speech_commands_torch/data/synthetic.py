"""Synthetic speech-commands-style dataset generation (counterpart of
`tpu_speech_commands/data/synthetic.py`, a copy on the port's `pr`: the same
seed writes the same files).

Builds a reference-layout dataset (``<root>/sounds/<class>/*.wav``) of
distinguishable synthetic signals — per-class tone chords over noise — for
integration tests, demos, and benchmarking without downloading Google
Speech Commands.  'background' is pure noise.
"""
from __future__ import annotations

import os
import zlib

import numpy as np

from ..params import pr
from .wav import save_audio

# two characteristic tones per command class
_CLASS_TONES = {
    "left": (400.0, 900.0),
    "right": (600.0, 1500.0),
    "up": (800.0, 2200.0),
    "down": (300.0, 1100.0),
    "yes": (500.0, 1800.0),
    "no": (700.0, 1300.0),
    "stop": (950.0, 2600.0),
    "go": (350.0, 1650.0),
}


def synth_command_audio(
    class_name: str, rng: np.random.Generator, n_samples: int | None = None,
    sample_rate: int | None = None, hard: bool = False,
) -> np.ndarray:
    """One synthetic utterance, float32 in [-1, 1].

    hard=True draws a second, noisier distribution (used by the accuracy-
    parity study so the Keras-vs-JAX comparison doesn't rest on a single
    corpus): variable SNR (noise amplitude 0.02-0.12 vs fixed 0.02),
    weaker and more variable tone amplitudes, a random time shift of the
    utterance envelope (commands not always centered), and background
    clips that may contain band-limited noise bursts."""
    sr = sample_rate or pr.sample_rate
    n = n_samples or pr.max_samples
    t = np.arange(n) / sr
    noise_amp = rng.uniform(0.02, 0.12) if hard else 0.02
    noise = noise_amp * rng.standard_normal(n)
    if class_name == "background":
        out = noise + 0.01 * np.sin(2 * np.pi * rng.uniform(50, 4000) * t)
        if hard and rng.random() < 0.5:
            # band-limited burst: a short loud tone that is NOT a command
            burst = np.zeros(n, np.float32)
            w = max(1, int(0.1 * n))
            s = rng.integers(0, n - w)
            burst[s:s + w] = rng.uniform(0.1, 0.3) * np.sin(
                2 * np.pi * rng.uniform(2000, 6000) * t[:w]
            )
            out = out + burst
        return out.astype(np.float32)
    tones = _CLASS_TONES.get(class_name)
    if tones is None:
        # stable across processes (builtin hash() is salted per process,
        # which would break seed-reproducibility for custom class lists)
        digest = zlib.crc32(class_name.encode("utf-8"))
        base = 300.0 + 137.0 * (digest % 23)
        tones = (base, base * 2.7)
    jitter = rng.uniform(0.97, 1.03)
    env = np.hanning(n)  # utterance-shaped envelope
    if hard:  # random time shift: command sits anywhere in the clip
        shift = rng.integers(-n // 4, n // 4 + 1)
        env = np.roll(env, shift)
        if shift > 0:
            env[:shift] = 0.0
        elif shift < 0:
            env[shift:] = 0.0
    amp_lo, amp_hi = (0.05, 0.2) if hard else (0.15, 0.3)
    sig = sum(
        rng.uniform(amp_lo, amp_hi) * np.sin(2 * np.pi * f * jitter * t + rng.uniform(0, 6))
        for f in tones
    )
    return (env * sig + noise).astype(np.float32)


def make_synthetic_dataset(
    root: str,
    class_names: list[str],
    samples_per_class: int = 8,
    seed: int = 0,
    duration_jitter: bool = True,
    hard: bool = False,
) -> str:
    """Write a reference-layout wav dataset; returns root.

    hard=True uses the noisier second distribution (see
    synth_command_audio)."""
    rng = np.random.default_rng(seed)
    for class_name in class_names:
        class_dir = os.path.join(root, "sounds", class_name)
        os.makedirs(class_dir, exist_ok=True)
        for i in range(samples_per_class):
            n = pr.max_samples
            if duration_jitter and i % 3 == 1:
                n = int(pr.max_samples * rng.uniform(0.6, 1.0))  # short clip
            audio = synth_command_audio(class_name, rng, n, hard=hard)
            save_audio(os.path.join(class_dir, f"{class_name}_{i}.wav"), audio)
    return root
