"""The port's losses and optimizers (`tpu_speech_commands_torch/losses.py`,
`optim.py`) against the JAX package's (`losses.py`, `optim.py`, optax), on
the same numpy inputs from a seed, on the CPU.

Tolerances: the losses atol 1e-6 (the same log_softmax in float32); each
optimizer x schedule, 5 updates on a fixed gradient sequence, parameters
within atol 1e-6 / rtol 1e-6 (the same f32 update arithmetic; the port
evaluates its schedules in float64, optax in float32); the schedules within
rtol 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tpu_speech_commands import losses as jax_losses
from tpu_speech_commands import optim as jax_optim
from tpu_speech_commands_torch import losses, optim

SCHEDULES = [None, "cosine", "exponential", "polynomial", "piecewise_constant"]


def _batch(seed=0, b=9, c=5):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, c, b).astype(np.int32),
            (3 * rng.standard_normal((b, c))).astype(np.float32))


@pytest.mark.parametrize("bias", [None, 0.9])
def test_losses_match_jax(bias):
    labels, logits = _batch()
    want = jax_losses.make_loss_fn(5, bias)(jnp.asarray(labels),
                                            jnp.asarray(logits))
    got = losses.make_loss_fn(5, bias)(torch.tensor(labels),
                                       torch.tensor(logits))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_ignore_index_and_weights_match_jax():
    labels, logits = _batch(1)
    for fn in ("sparse_categorical_crossentropy",):
        want = getattr(jax_losses, fn)(jnp.asarray(labels), jnp.asarray(logits),
                                       ignore_index=2)
        got = getattr(losses, fn)(torch.tensor(labels), torch.tensor(logits),
                                  ignore_index=2)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    w = np.linspace(0.5, 2.0, 5).astype(np.float32)
    want = jax_losses.weighted_sparse_categorical_crossentropy(
        jnp.asarray(labels), jnp.asarray(logits), w)
    got = losses.weighted_sparse_categorical_crossentropy(
        torch.tensor(labels), torch.tensor(logits), w)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    np.testing.assert_array_equal(losses.background_bias_weights(0.6, 4),
                                  jax_losses.background_bias_weights(0.6, 4))
    with pytest.raises(ValueError):
        losses.background_bias_weights(1.0, 4)


@pytest.mark.parametrize("decay_type", SCHEDULES)
def test_schedules_match_optax(decay_type):
    steps = 1000 if decay_type == "piecewise_constant" else 40
    want = jax_optim.get_lr_scheduler(3e-3, decay_type, steps)
    got = optim.get_lr_scheduler(3e-3, decay_type, steps)
    for step in (0, 1, 7, 20, 39, 40, 55, 499, 500, 899, 900, 999, 1000, 1200):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6)


@pytest.mark.parametrize("decay_type", SCHEDULES)
@pytest.mark.parametrize("optim_type", ["adam", "rmsprop", "sgd"])
def test_optimizer_updates_match_optax(optim_type, decay_type):
    """5 updates on a fixed gradient sequence, from the same start."""
    rng = np.random.default_rng(3)
    shapes = [(4, 6), (6,), (2, 3, 5)]
    start = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[(rng.standard_normal(s) * 10 ** rng.uniform(-3, 1)).astype(
        np.float32) for s in shapes] for _ in range(5)]
    injectable = decay_type is None
    tx = jax_optim.get_optimizer(optim_type, 2e-2, decay_type=decay_type,
                                 decay_steps=4, injectable=injectable)
    jp = [jnp.asarray(a) for a in start]
    state = tx.init(jp)
    params = [torch.tensor(a) for a in start]
    opt = optim.get_optimizer(optim_type, 2e-2, decay_type=decay_type,
                              decay_steps=4, injectable=injectable,
                              params=params)
    for g in grads:
        updates, state = tx.update([jnp.asarray(a) for a in g], state, jp)
        jp = optax.apply_updates(jp, updates)
        opt.step([torch.tensor(a) for a in g])
        for got, want in zip(params, jp):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-6, atol=1e-6)


def test_plateau_scaling_matches_the_jax_trainer():
    """The injectable learning rate: the JAX trainer scales optax's injected
    hyperparameter by the factor, floored at min_lr; the port scales
    `Optimizer.learning_rate` the same way, and the next update uses it."""
    from tpu_speech_commands.training.trainer import _find_hyperparams

    tx = jax_optim.get_optimizer("adam", 1e-3, decay_type=None,
                                 injectable=True)
    state = tx.init([jnp.zeros(3)])
    hp = _find_hyperparams(state)
    opt = optim.get_optimizer("adam", 1e-3, decay_type=None, injectable=True,
                              params=[torch.zeros(3)])
    assert opt.current_lr() == pytest.approx(float(hp["learning_rate"]))
    from tpu_speech_commands_torch.training.trainer import scale_lr

    for _ in range(3):
        hp["learning_rate"] = jnp.maximum(hp["learning_rate"] * 0.5, 1e-10)
        scale_lr(opt, 0.5, 1e-10)
        np.testing.assert_allclose(opt.current_lr(),
                                   float(hp["learning_rate"]), rtol=1e-6)
    scale_lr(opt, 1e-12, 1e-10)
    assert opt.current_lr() == 1e-10
    opt.step([torch.ones(3)])
    assert opt.params[0].abs().max() == pytest.approx(1e-10, rel=1e-3)
    with pytest.raises(ValueError, match="injectable"):
        optim.get_optimizer("adam", 1e-3, decay_type="cosine", injectable=True)
    with pytest.raises(ValueError):
        optim.get_optimizer("adamw", 1e-3)
