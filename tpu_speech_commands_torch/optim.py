"""Optimizers and learning-rate schedules (counterpart of
`tpu_speech_commands/optim.py`, which builds them with optax).

The updates are written out as plain functions on tensors, step for step
optax's (tested against it), with the Keras hyperparameters the JAX package
chose; `torch.optim`'s defaults differ (RMSprop's alpha 0.99, Adam's eps
1e-8):
- schedules: constant | cosine (alpha 0.2 floor) | exponential (rate 0.9) |
  polynomial (end lr / 100, power 1) | piecewise_constant (1e-3 for 500
  steps, then lr, lr / 10 after 90%, lr / 100 after 100%); a schedule is
  read at the update's count before the update (optax's);
- adam (b1 0.9, b2 0.999, eps 1e-7), rmsprop (decay 0.9, eps 1e-7 outside
  the sqrt, no momentum, no centering), sgd (no momentum);
- an injectable learning rate (`Optimizer.learning_rate`): a float the
  trainer's plateau callback scales, only without a decay schedule.
"""
from __future__ import annotations

import math

import torch

DECAY_TYPES = (None, "cosine", "exponential", "polynomial", "piecewise_constant")
OPTIMIZER_TYPES = ("adam", "rmsprop", "sgd")


def get_lr_scheduler(learning_rate: float, decay_type: str | None,
                     decay_steps: int):
    """step (int) -> learning rate (float), optax's schedule of that name
    with the JAX package's settings."""
    if decay_type:
        decay_type = decay_type.lower()
    if decay_type in (None, "none", ""):
        return lambda step: learning_rate
    if decay_type == "cosine":
        def cosine(step):
            count = min(step, decay_steps)
            cos = 0.5 * (1.0 + math.cos(math.pi * count / decay_steps))
            return learning_rate * ((1.0 - 0.2) * cos + 0.2)
        return cosine
    if decay_type == "exponential":
        return lambda step: learning_rate * 0.9 ** (step / decay_steps)
    if decay_type == "polynomial":
        end = learning_rate / 100.0

        def polynomial(step):
            count = min(max(step, 0), decay_steps)
            return (learning_rate - end) * (1.0 - count / decay_steps) + end
        return polynomial
    if decay_type == "piecewise_constant":
        if decay_steps <= 500:
            # the fixed 500-step warmup covers the whole run, as in the
            # reference (Keras PiecewiseConstantDecay answers 1e-3 there)
            print(
                f"WARNING: piecewise_constant with decay_steps="
                f"{decay_steps} <= 500 trains entirely inside the fixed "
                "1e-3 warmup phase; use more epochs/steps or another "
                "decay_type")
        boundaries = sorted({500, max(int(decay_steps * 0.9), 501),
                             max(decay_steps, 502)})
        values = [1e-3, learning_rate, learning_rate / 10.0,
                  learning_rate / 100.0]
        return lambda step: values[sum(step >= b for b in boundaries)]
    raise ValueError("Unsupported lr decay type")


class Optimizer:
    """One of adam | rmsprop | sgd over a list of parameters, updated in
    place by `step(grads)`.  The learning rate is the schedule's at the
    update's count, or, when `injectable`, the float `learning_rate`, which
    the plateau callback may scale."""

    def __init__(self, optim_type: str, schedule, params=None,
                 injected_lr: float | None = None):
        self.optim_type = optim_type
        self.schedule = schedule
        self.learning_rate = injected_lr
        self.count = 0
        self.params = list(params) if params is not None else []
        self.state: list[dict] = [{} for _ in self.params]

    def bind(self, params) -> "Optimizer":
        """Point the optimizer at `params` with a fresh state."""
        self.params = list(params)
        self.state = [{} for _ in self.params]
        self.count = 0
        return self

    def current_lr(self) -> float:
        if self.learning_rate is not None:
            return self.learning_rate
        return self.schedule(self.count)

    @torch.no_grad()
    def step(self, grads) -> None:
        lr = self.current_lr()
        t = self.count + 1
        for p, g, st in zip(self.params, grads, self.state):
            if self.optim_type == "adam":
                mu = st.setdefault("mu", torch.zeros_like(p))
                nu = st.setdefault("nu", torch.zeros_like(p))
                mu.copy_((1.0 - 0.9) * g + 0.9 * mu)
                nu.copy_((1.0 - 0.999) * (g * g) + 0.999 * nu)
                mu_hat = mu / (1.0 - 0.9 ** t)
                nu_hat = nu / (1.0 - 0.999 ** t)
                upd = mu_hat / (torch.sqrt(nu_hat) + 1e-7)
            elif self.optim_type == "rmsprop":
                nu = st.setdefault("nu", torch.zeros_like(p))
                nu.copy_((1.0 - 0.9) * (g * g) + 0.9 * nu)
                upd = g / (torch.sqrt(nu) + 1e-7)
            else:
                upd = g
            p.add_(-lr * upd)
        self.count = t


def get_optimizer(optim_type: str, learning_rate: float,
                  average_type: str | None = None,
                  decay_type: str | None = "cosine",
                  decay_steps: int = 100000, injectable: bool = False,
                  params=None) -> Optimizer:
    """The optimizer the JAX package's get_optimizer builds.  `injectable`
    keeps the learning rate a float the plateau callback scales; it needs
    decay_type None (a schedule would overwrite the scaling every step).
    average_type is the trainer's (training/averaging.py)."""
    optim_type = optim_type.lower()
    no_decay = (decay_type or "").lower() in ("none", "")
    if injectable and not no_decay:
        raise ValueError(
            "injectable=True requires decay_type=None: a decay schedule "
            "overwrites the injected learning_rate each step, so plateau "
            "scaling would be silently reverted")
    if optim_type not in OPTIMIZER_TYPES:
        raise ValueError("Unsupported optimizer type")
    schedule = get_lr_scheduler(learning_rate, decay_type, decay_steps)
    _ = average_type
    return Optimizer(optim_type, schedule, params,
                     float(learning_rate) if injectable else None)
