"""ThresholdDecoder — raw softmax score -> calibrated confidence
(counterpart of `tpu_speech_commands/streaming/decoder.py`, a copy).

Re-implementation of the reference decoder (`listen.py:452-521`): models the
network's raw output as a logit-normal mixture described by
``threshold_config`` = ((mu, std), ...); decoding maps a raw score through
the mixture CDF so that "0.8" means "greater than ~80% of typical network
outputs", then piecewise-rescales so ``center`` maps to 0.5.

Numerics match the reference exactly: integer truncation of mu±4σ bounds,
resolution*out_range point CDF table, round-to-nearest table lookup, and the
asigmoid(-10) out-of-domain fallback.
"""
from __future__ import annotations

import math

import numpy as np


class ThresholdDecoder:
    def __init__(
        self,
        mu_stds: tuple,
        center: float = 0.5,
        resolution: int = 200,
        min_z: float = -4,
        max_z: float = 4,
    ):
        self.min_out = int(min(mu + min_z * std for mu, std in mu_stds))
        self.max_out = int(max(mu + max_z * std for mu, std in mu_stds))
        self.out_range = self.max_out - self.min_out
        self.cd = np.cumsum(self._calc_pd(mu_stds, resolution))
        self.center = center

    @staticmethod
    def sigmoid(x: float) -> float:
        return 1.0 / (1.0 + math.exp(-x))

    @staticmethod
    def asigmoid(x: float) -> float:
        """Inverse sigmoid (logit); -10 outside (0, 1) like the reference."""
        return -math.log(1.0 / x - 1.0) if (0.0 < x < 1.0) else -10.0

    @staticmethod
    def pdf(x, mu: float, std: float):
        if std == 0:
            return np.zeros_like(np.asarray(x, dtype=float))
        return (1.0 / (std * math.sqrt(2 * math.pi))) * np.exp(
            -((x - mu) ** 2) / (2 * std ** 2)
        )

    def decode(self, raw_output: float) -> float:
        if raw_output == 1.0 or raw_output == 0.0:
            return raw_output
        if self.out_range == 0:
            cp = float(raw_output > self.min_out)
        else:
            ratio = (self.asigmoid(raw_output) - self.min_out) / self.out_range
            ratio = min(max(ratio, 0.0), 1.0)
            cp = self.cd[int(ratio * (len(self.cd) - 1) + 0.5)]
        if cp < self.center:
            return 0.5 * cp / self.center
        return 0.5 + 0.5 * (cp - self.center) / (1.0 - self.center)

    def encode(self, threshold: float) -> float:
        """Inverse of decode (listen.py:510-517)."""
        threshold = 0.5 * threshold / self.center
        if threshold < 0.5:
            cp = threshold * self.center * 2
        else:
            cp = (threshold - 0.5) * 2 * (1 - self.center) + self.center
        if self.out_range == 0:  # degenerate config: cd is empty (0/0 NaN)
            return self.sigmoid(self.min_out)
        ratio = np.searchsorted(self.cd, cp) / len(self.cd)
        return self.sigmoid(self.min_out + self.out_range * ratio)

    def decode_array(self, raw: np.ndarray) -> np.ndarray:
        """Vectorised decode for batched post-processing.

        Identical numerics to decode(): logit, CDF table lookup with
        round-to-nearest index, piecewise rescale around center; exact 0/1
        pass through and out-of-(0,1) values take the asigmoid(-10) branch.
        """
        raw = np.asarray(raw, dtype=np.float64)
        if self.out_range == 0:
            cp = (raw > self.min_out).astype(np.float64)
        else:
            interior = (raw > 0.0) & (raw < 1.0)
            logit = np.where(
                interior, -np.log(1.0 / np.where(interior, raw, 0.5) - 1.0), -10.0
            )
            ratio = np.clip((logit - self.min_out) / self.out_range, 0.0, 1.0)
            idx = (ratio * (len(self.cd) - 1) + 0.5).astype(np.int64)
            cp = self.cd[idx]
        out = np.where(
            cp < self.center,
            0.5 * cp / self.center,
            0.5 + 0.5 * (cp - self.center) / (1.0 - self.center),
        )
        exact = (raw == 0.0) | (raw == 1.0)
        return np.where(exact, raw, out)

    def _calc_pd(self, mu_stds, resolution: int):
        points = np.linspace(
            self.min_out, self.max_out, resolution * self.out_range
        )
        return np.sum(
            [self.pdf(points, mu, std) for mu, std in mu_stds], axis=0
        ) / (resolution * len(mu_stds))
