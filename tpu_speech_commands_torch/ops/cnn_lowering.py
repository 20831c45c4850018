"""Host lowering of a SimpleCNN / SimpleCNNLite for the CNN kernels, in
numpy (counterpart of `tpu_speech_commands/ops/pallas_classifier.py::
lower_classifier` and `_lower_block`, and of `ops/pallas_cnn.py::
fold_block1_params`).

Per conv block it produces the effective 3x3 HWIO kernel and its epilogue
constants:
- a separable block's depthwise and pointwise kernels compose, in float64,
  into one dense kernel w[dy, dx, ci, co] = dw[dy, dx, ci] * pw[ci, co],
  with the pointwise bias as the conv bias;
- a block without an inline relu folds BatchNorm (epsilon 1e-3) into the
  kernel, leaving one bias added after the pool (the pool commutes with the
  monotone +bias, relu6 epilogue);
- a block with the inline relu cannot fold BatchNorm through the relu, so it
  keeps the unfolded kernel, the pre-relu conv bias, and the post-relu
  BatchNorm scale `mult` (which can be negative) and shift, applied before
  the pool.

The Toeplitz conv matrices of the TPU kernels were that machine's answer to
padding its matrix unit; they are not part of the math and are not built.
The arrays are row-major float32 (float64 for `fold_block1_params`, as in
the JAX package).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..models.cnn import BLOCKS, BN_EPSILON, conv_out, inline_relu, same_pads


def effective_conv_kernel(params: dict, separable: bool):
    """(w (3, 3, cin, cout), conv_bias (cout,)) in float64 for a dense or a
    separable block."""
    if separable:
        dw = np.asarray(params["depthwise"]["kernel"], np.float64)[:, :, 0, :]
        pw = np.asarray(params["pointwise"]["kernel"], np.float64)[0, 0]
        return (np.einsum("yxc,cd->yxcd", dw, pw),
                np.asarray(params["pointwise"]["bias"], np.float64))
    w = np.asarray(params["conv"]["kernel"], np.float64)
    return w, np.zeros(w.shape[3], np.float64)


def batchnorm_affine(bn: dict, stats: dict):
    """Inference BatchNorm as y = x * mult + shift, in float64."""
    mult = np.asarray(bn["scale"], np.float64) / np.sqrt(
        np.asarray(stats["var"], np.float64) + BN_EPSILON)
    shift = np.asarray(bn["bias"], np.float64) - \
        np.asarray(stats["mean"], np.float64) * mult
    return mult, shift


def folded_conv(params: dict, stats: dict, separable: bool):
    """(w * mult, bias) in float64: BatchNorm folded into the conv, the
    bias as the JAX package computes it."""
    w, conv_bias = effective_conv_kernel(params, separable)
    mult, _ = batchnorm_affine(params["bn"], stats)
    bias = (conv_bias - np.asarray(stats["mean"], np.float64)) * mult + \
        np.asarray(params["bn"]["bias"], np.float64)
    return w * mult, bias


def _f32(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.float32)


@dataclass
class Stage:
    """One conv block, lowered.  `kernel` (3, 3, cin, cout) HWIO; without the
    inline relu, out = relu6(pool(conv(x, kernel)) + bias) with BatchNorm
    folded in; with it, out = pool(relu6(relu(conv(x, kernel) + pre_bias) *
    mult + bias))."""

    kernel: np.ndarray
    bias: np.ndarray
    pre_bias: np.ndarray | None
    mult: np.ndarray | None
    h_in: int
    w_in: int
    stride: int
    pool: bool

    @property
    def inline_relu(self) -> bool:
        return self.mult is not None

    @property
    def cin(self) -> int:
        return self.kernel.shape[2]

    @property
    def cout(self) -> int:
        return self.kernel.shape[3]

    @property
    def pads(self) -> tuple[tuple[int, int], tuple[int, int]]:
        """((top, bottom), (left, right)) TF SAME padding."""
        return (same_pads(self.h_in, self.stride),
                same_pads(self.w_in, self.stride))

    @property
    def h_out(self) -> int:
        h = conv_out(self.h_in, self.stride)
        return h // 2 if self.pool else h

    @property
    def w_out(self) -> int:
        w = conv_out(self.w_in, self.stride)
        return w // 2 if self.pool else w


def lower_block(params: dict, stats: dict, h_in: int, w_in: int, stride: int,
                pool: bool, inline: bool, separable: bool) -> Stage:
    if inline:
        w, conv_bias = effective_conv_kernel(params, separable)
        mult, shift = batchnorm_affine(params["bn"], stats)
        return Stage(_f32(w), _f32(shift), _f32(conv_bias), _f32(mult),
                     h_in, w_in, stride, pool)
    w, bias = folded_conv(params, stats, separable)
    return Stage(_f32(w), _f32(bias), None, None, h_in, w_in, stride, pool)


@dataclass
class Lowered:
    """The whole classifier: four stages, then relu6(flat @ dense_w +
    dense_b) @ head_w + head_b over the NHWC (y, x, c) flatten."""

    stages: list[Stage]
    dense_w: np.ndarray
    dense_b: np.ndarray
    head_w: np.ndarray
    head_b: np.ndarray


def lower_classifier(variables: dict, separable: bool, n_features: int,
                     feature_size: int) -> Lowered:
    """A JAX-layout variables tree ({'params', 'batch_stats'} of arrays) ->
    the lowered classifier for (n_features, feature_size) inputs."""
    params, stats = variables["params"], variables["batch_stats"]
    h, w = n_features, feature_size
    stages = []
    for name, _, stride, pool in BLOCKS:
        st = lower_block(params[name], stats[name]["bn"], h, w, stride, pool,
                         inline_relu(name, separable), separable)
        stages.append(st)
        h, w = st.h_out, st.w_out
    dense_w = _f32(params["feature_dense"]["kernel"])
    flat = h * w * stages[-1].cout
    if dense_w.shape[0] != flat:
        raise ValueError(
            f"flatten mismatch: conv output {h}x{w}x{stages[-1].cout}={flat} "
            f"vs feature_dense kernel {dense_w.shape}")
    return Lowered(stages, dense_w, _f32(params["feature_dense"]["bias"]),
                   _f32(params["score_predict"]["kernel"]),
                   _f32(params["score_predict"]["bias"]))


def lower_block1(variables: dict, separable: bool, n_features: int,
                 feature_size: int) -> Stage:
    """Block 1 alone (BatchNorm folded, 2x2 pool), for the block-1 kernel."""
    name, _, stride, pool = BLOCKS[0]
    return lower_block(variables["params"][name],
                       variables["batch_stats"][name]["bn"], n_features,
                       feature_size, stride, pool, False, separable)


def fold_block1_params(variables: dict, separable: bool = False):
    """(w (3, 3, C), bias (C,)) of block 1 with BatchNorm folded in, float64."""
    w, bias = folded_conv(variables["params"]["block1"],
                          variables["batch_stats"]["block1"]["bn"], separable)
    return w[:, :, 0, :], bias
