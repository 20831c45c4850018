"""Audio augmentation inside the train step (counterpart of
`tpu_speech_commands/data/augment.py`): random gain, random time shift and
random-SNR background-noise mixing, then the frontend.

`augment_batch` is split in two: `draw_augmentation` makes every random
draw (gain, shift, noise pick, SNR, which rows get noise) from a
`torch.Generator` on the host, and `apply_augmentation` applies given draws
on the audio's device.  Draws made on the host are the same for every
device, so one step on the card and one on the CPU see the same
augmentation, and a test can hand `apply_augmentation` the draws JAX made.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..models.factory import features_to_input


@dataclass(frozen=True)
class AugmentConfig:
    snr_db_min: float = 5.0
    snr_db_max: float = 20.0
    noise_prob: float = 0.7     # fraction of samples that get noise mixed in
    shift_max: float = 0.1      # max |time shift| as a fraction of the buffer
    gain_min: float = 0.8
    gain_max: float = 1.2


def draw_augmentation(generator: torch.Generator, batch: int, n_samples: int,
                      n_noise: int, config: AugmentConfig = AugmentConfig()
                      ) -> dict:
    """The draws of one batch, on the generator's device (the CPU for a
    host generator): gain (B, 1) in [gain_min, gain_max); shift (B,) int64
    in [-max_shift, max_shift], max_shift = int(shift_max * n_samples);
    pick (B,) in [0, n_noise), snr_db (B, 1) in [snr_db_min, snr_db_max)
    and apply (B, 1) uniform in [0, 1), noise where apply < noise_prob.
    Keys without a stage (no shift, an empty bank) are absent."""
    dev = generator.device

    def uniform(lo, hi, shape):
        u = torch.rand(shape, generator=generator, device=dev)
        return lo + (hi - lo) * u

    draws = {"gain": uniform(config.gain_min, config.gain_max, (batch, 1))}
    max_shift = int(config.shift_max * n_samples)
    if max_shift > 0:
        draws["shift"] = torch.randint(-max_shift, max_shift + 1, (batch,),
                                       generator=generator, device=dev)
    if n_noise > 0:
        draws["pick"] = torch.randint(0, n_noise, (batch,),
                                      generator=generator, device=dev)
        draws["snr_db"] = uniform(config.snr_db_min, config.snr_db_max,
                                  (batch, 1))
        draws["apply"] = uniform(0.0, 1.0, (batch, 1))
    return draws


def apply_augmentation(audio: torch.Tensor, noise_bank: torch.Tensor,
                       draws: dict,
                       config: AugmentConfig = AugmentConfig()) -> torch.Tensor:
    """Gain-scale, time-shift (zero backfill) and noise-mix (B, S) float32
    audio with given draws, on the audio's device; clipped to [-1, 1]."""
    dev = audio.device
    draws = {k: v.to(dev) for k, v in draws.items()}
    n_samples = audio.shape[1]
    out = audio * draws["gain"]
    if "shift" in draws:
        idx = torch.arange(n_samples, device=dev)[None, :] - draws["shift"][:, None]
        valid = (idx >= 0) & (idx < n_samples)
        out = torch.gather(out, 1, idx.clamp(0, n_samples - 1)) * valid
    if "pick" in draws:
        noise = noise_bank[draws["pick"]]
        p_sig = torch.mean(out ** 2, dim=1, keepdim=True)
        p_noise = torch.mean(noise ** 2, dim=1, keepdim=True) + 1e-12
        scale = torch.sqrt(p_sig / (10.0 ** (draws["snr_db"] / 10.0)) / p_noise)
        mixed = out + scale * noise
        out = torch.where(draws["apply"] < config.noise_prob, mixed, out)
    return torch.clamp(out, -1.0, 1.0)


def augment_batch(generator: torch.Generator, audio: torch.Tensor,
                  noise_bank: torch.Tensor,
                  config: AugmentConfig = AugmentConfig()) -> torch.Tensor:
    """Randomly gain-scale, time-shift and noise-mix a batch of clips."""
    draws = draw_augmentation(generator, audio.shape[0], audio.shape[1],
                              noise_bank.shape[0], config)
    return apply_augmentation(audio, noise_bank, draws, config)


def make_audio_pipeline(frontend, model_type: str, noise_bank,
                        config: AugmentConfig = AugmentConfig(),
                        device=None):
    """The trainer's `device_pipeline`: raw audio -> (augmentation when
    training) -> frontend -> model input.  `pipeline(generator, audio,
    train)` draws from the host `generator` when training; the frontend
    runs without autograd (it has no parameters) and hands f32 features
    over.  The noise bank lives on `device` (the frontend's by default)."""
    device = device or getattr(frontend, "device", "cpu")
    noise_bank = torch.as_tensor(noise_bank, dtype=torch.float32).to(device)
    if config.noise_prob > 0 and noise_bank.shape[0] == 0:
        raise ValueError(
            "augmentation noise bank is empty: the dataset has no "
            "'background' clips to mix in; add background wavs or set "
            "noise_prob=0")

    def pipeline(generator, audio: torch.Tensor, train: bool) -> torch.Tensor:
        with torch.no_grad():
            if train:
                audio = augment_batch(generator, audio, noise_bank, config)
            feats = frontend(audio).float()
        return features_to_input(feats, model_type)

    return pipeline
