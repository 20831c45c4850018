"""Weight averaging: EMA, SWA and Lookahead (counterpart of
`tpu_speech_commands/training/averaging.py`, its per-step host path
`observe`).

- 'ema': a per-step exponential moving average of the parameters (decay
  0.99);
- 'swa': an equal-weight average of snapshots every `swa_period` steps from
  `swa_start`;
- 'lookahead': every `sync_period` steps the slow weights move toward the
  fast ones by `slow_step_size` and the fast weights are reset to them.

The averaged copy lives beside the model; EMA and SWA weights are what the
trainer evaluates and checkpoints.
"""
from __future__ import annotations

import torch

AVERAGE_TYPES = ("ema", "swa", "lookahead")


class WeightAverager:
    def __init__(self, average_type: str, params,
                 ema_decay: float = 0.99,
                 swa_start: int = 0, swa_period: int = 10,
                 sync_period: int = 6, slow_step_size: float = 0.5):
        self.average_type = average_type.lower()
        if self.average_type not in AVERAGE_TYPES:
            raise ValueError(f"unknown average_type {average_type!r}; "
                             f"expected one of {AVERAGE_TYPES}")
        self.ema_decay = ema_decay
        self.swa_start = swa_start
        self.swa_period = swa_period
        self.sync_period = sync_period
        self.slow_step_size = slow_step_size
        self.avg_params = [p.detach().clone() for p in params]
        self.count = 0

    @torch.no_grad()
    def _update(self, params) -> None:
        for a, p in zip(self.avg_params, params):
            if self.average_type == "ema":
                d = self.ema_decay
                a.copy_(d * a + (1.0 - d) * p)
            elif self.average_type == "swa":
                n = float(self.count)
                a.copy_((a * n + p) / (n + 1.0))
            else:  # lookahead: slow <- slow + alpha (fast - slow)
                a.copy_(a + self.slow_step_size * (p - a))
        self.count += 1

    @torch.no_grad()
    def observe(self, step: int, params) -> bool:
        """Call after each optimizer step (`step` counts the steps taken).
        Returns True where lookahead reset the fast weights `params` to the
        slow ones, in place."""
        params = list(params)
        if self.average_type == "ema":
            self._update(params)
        elif self.average_type == "swa":
            if step >= self.swa_start and \
                    (step - self.swa_start) % self.swa_period == 0:
                self._update(params)
        elif step > 0 and step % self.sync_period == 0:
            self._update(params)
            for p, a in zip(params, self.avg_params):
                p.copy_(a)
            return True
        return False
