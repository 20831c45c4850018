"""The port's augmentation (`tpu_speech_commands_torch/data/augment.py`)
against the JAX package's `augment_batch`, on the CPU.

JAX draws from its key inside `augment_batch`; the test makes the same
draws from the same key split (gain, shift, pick, SNR, apply) and hands them
to the port's `apply_augmentation`: the outputs agree within atol 1e-6 (the
same f32 arithmetic; the SNR power's 10 ** x may differ in its last bit).
The port's own draws are held to their ranges.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_speech_commands.data.augment import AugmentConfig as JaxConfig
from tpu_speech_commands.data.augment import augment_batch
from tpu_speech_commands_torch.data.augment import (AugmentConfig,
                                                    apply_augmentation,
                                                    draw_augmentation,
                                                    make_audio_pipeline)
from tpu_speech_commands_torch.ops.frontend_kernel import MfccFrontend


def _jax_draws(key, batch, n_samples, n_noise, c):
    """augment_batch's draws, made the way it makes them."""
    k_gain, k_shift, k_pick, k_snr, k_apply = jax.random.split(key, 5)
    max_shift = int(c.shift_max * n_samples)
    draws = {
        "gain": jax.random.uniform(k_gain, (batch, 1), minval=c.gain_min,
                                   maxval=c.gain_max),
        "shift": jax.random.randint(k_shift, (batch,), -max_shift,
                                    max_shift + 1),
        "pick": jax.random.randint(k_pick, (batch,), 0, n_noise),
        "snr_db": jax.random.uniform(k_snr, (batch, 1), minval=c.snr_db_min,
                                     maxval=c.snr_db_max),
        "apply": jax.random.uniform(k_apply, (batch, 1)),
    }
    return {k: torch.tensor(np.asarray(v)) for k, v in draws.items()}


@pytest.mark.parametrize("noise_prob", [0.7, 1.0])
def test_apply_with_jax_draws_matches_jax(noise_prob):
    rng = np.random.default_rng(2)
    batch, n = 12, 4000
    audio = (0.3 * rng.standard_normal((batch, n))).astype(np.float32)
    audio[3] = 0.0  # a silent clip: noise scaled to 0 power
    bank = (0.1 * rng.standard_normal((3, n))).astype(np.float32)
    c = JaxConfig(noise_prob=noise_prob)
    key = jax.random.PRNGKey(11)
    want = np.asarray(augment_batch(key, jnp.asarray(audio), jnp.asarray(bank),
                                    c))
    draws = _jax_draws(key, batch, n, 3, c)
    got = apply_augmentation(torch.tensor(audio), torch.tensor(bank), draws,
                             AugmentConfig(noise_prob=noise_prob))
    assert got.shape == (batch, n) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    assert (draws["shift"] != 0).any() and np.abs(want).max() <= 1.0


def test_draw_ranges():
    c = AugmentConfig()
    g = torch.Generator().manual_seed(0)
    d = draw_augmentation(g, 4000, 16000, 7, c)
    assert set(d) == {"gain", "shift", "pick", "snr_db", "apply"}
    assert d["gain"].shape == d["snr_db"].shape == d["apply"].shape == (4000, 1)
    assert c.gain_min <= d["gain"].min() and d["gain"].max() < c.gain_max
    assert c.snr_db_min <= d["snr_db"].min() and d["snr_db"].max() < c.snr_db_max
    assert 0.0 <= d["apply"].min() and d["apply"].max() < 1.0
    assert -1600 <= d["shift"].min() < -1500 and 1500 < d["shift"].max() <= 1600
    assert d["pick"].min() == 0 and d["pick"].max() == 6
    share = float((d["apply"] < c.noise_prob).float().mean())
    assert abs(share - c.noise_prob) < 0.03
    again = draw_augmentation(torch.Generator().manual_seed(0), 4000, 16000,
                              7, c)
    assert all(torch.equal(d[k], again[k]) for k in d)
    # no shift stage at shift_max 0, no noise stage with an empty bank
    d = draw_augmentation(g, 3, 16000, 0, AugmentConfig(shift_max=0.0))
    assert set(d) == {"gain"}


def test_pipeline_augments_only_in_training():
    rng = np.random.default_rng(4)
    audio = torch.tensor((0.2 * rng.standard_normal((3, 16000))).astype(
        np.float32))
    fe = MfccFrontend(None, "mfcc", "cpu")
    pipe = make_audio_pipeline(fe, "simple_cnn", np.zeros((2, 16000),
                                                          np.float32))
    clean = pipe(None, audio, False)
    assert clean.shape == (3, 30, 20, 1) and not clean.requires_grad
    torch.testing.assert_close(clean[..., 0], fe(audio))
    noisy = pipe(torch.Generator().manual_seed(1), audio, True)
    assert noisy.shape == clean.shape and not torch.equal(noisy, clean)
    with pytest.raises(ValueError, match="noise bank is empty"):
        make_audio_pipeline(fe, "simple_gru", np.zeros((0, 16000), np.float32))
