"""CNN keyword-spotting models as `nn.Module`s (counterpart of
`tpu_speech_commands/models/cnn.py`).

- SimpleCNN: 4 conv blocks [16,s1 -> 32,s1 -> 64,s2 -> 128,s1], each
  Conv(3x3, SAME, no bias) -> BatchNorm -> ReLU6, 2x2 max-pool after blocks
  1, 2 and 4; then an NHWC flatten -> Dense(128) -> ReLU6 -> Dense(C).
  Block 4 carries the reference's inline relu before its BatchNorm.
- SimpleCNNLite: the same with separable convs (depthwise 3x3, then a
  pointwise 1x1 with a bias); blocks 3 and 4 carry the inline relu.

Keras semantics, as in the JAX package, and where torch's defaults differ:
- BatchNorm epsilon is 1e-3 (Keras), not torch's 1e-5.  These modules are
  inference-only: BatchNorm always uses its running statistics, and the
  training-only Dropout does not appear.
- Padding is TF SAME: the low side gets total // 2 and the extra unit pads
  high, so a stride-2 conv over an even dimension pads 0 low and 1 high
  (`same_pads`).  `F.conv2d(padding=1)` would shift that conv by a row.
- Parameters keep the flax names and layouts: `conv.kernel` (3, 3, Cin, Cout)
  HWIO, `depthwise.kernel` (3, 3, 1, Cin), `pointwise.kernel` (1, 1, Cin,
  Cout) and `pointwise.bias`, `bn.scale` and `bn.bias` with the buffers
  `bn.mean` and `bn.var`, `feature_dense` and `score_predict` (kernel (in,
  out), bias).  Each conv permutes its kernel to torch's (Cout, Cin/groups,
  kh, kw) when it runs.
- Input is (B, H, W) or (B, H, W, 1), NHWC as in JAX; activations run NCHW
  inside, and the flatten before `feature_dense` is in NHWC (y, x, c) order,
  the row order of the dense kernel.

Parameters start at zero (BatchNorm at identity): their values come from a
checkpoint (`convert.py`).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .rnn import Dense

BN_EPSILON = 1e-3  # Keras BatchNormalization default
# (name, features, stride, pool) per block; the inline relu sits on block 4,
# and on block 3 of the separable variant
BLOCKS = (("block1", 16, 1, True), ("block2", 32, 1, True),
          ("block3", 64, 2, False), ("block4", 128, 1, True))
FEATURE_DENSE = 128


def relu6(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x, 0.0, 6.0)


def inline_relu(name: str, separable: bool) -> bool:
    return name == "block4" or (separable and name == "block3")


def conv_out(dim: int, stride: int) -> int:
    """Output length of a SAME conv: ceil(dim / stride)."""
    return -(-dim // stride)


def same_pads(dim: int, stride: int, k: int = 3) -> tuple[int, int]:
    """TF / XLA SAME padding (low, high): total = (out - 1) * stride + k -
    dim, the low side rounded down and the extra unit high.  Stride 1 or an
    odd dimension gives (1, 1); stride 2 on an even dimension gives (0, 1)."""
    total = max((conv_out(dim, stride) - 1) * stride + k - dim, 0)
    return total // 2, total - total // 2


def output_hw(n_features: int, feature_size: int) -> tuple[int, int]:
    """(h, w) after the four blocks: a conv of stride s gives ceil(d / s),
    a VALID 2x2 pool floor(d / 2)."""
    h, w = n_features, feature_size
    for _, _, stride, pool in BLOCKS:
        h, w = conv_out(h, stride), conv_out(w, stride)
        if pool:
            h, w = h // 2, w // 2
    return h, w


class ConvKernel(nn.Module):
    """A flax conv's parameters: `kernel` in HWIO, and `bias` if it has one."""

    def __init__(self, shape: tuple, bias: bool = False):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(shape))
        self.bias = nn.Parameter(torch.zeros(shape[-1])) if bias else None


class BatchNormKeras(nn.Module):
    """Inference BatchNorm over the channel axis of an NCHW tensor, with
    the Keras epsilon."""

    def __init__(self, features: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mult = self.scale * torch.rsqrt(self.var + BN_EPSILON)
        return (x - self.mean[:, None, None]) * mult[:, None, None] + \
            self.bias[:, None, None]


class ConvBlock(nn.Module):
    """Conv -> (inline relu) -> BatchNorm -> ReLU6 -> (2x2 max-pool), on
    NCHW tensors (counterpart of `_ConvBlock`)."""

    def __init__(self, cin: int, features: int, stride: int = 1,
                 separable: bool = False, inline_relu: bool = False,
                 pool: bool = False):
        super().__init__()
        self.cin, self.features, self.stride = cin, features, stride
        self.separable, self.inline_relu, self.pool = separable, inline_relu, pool
        if separable:
            self.depthwise = ConvKernel((3, 3, 1, cin))
            self.pointwise = ConvKernel((1, 1, cin, features), bias=True)
        else:
            self.conv = ConvKernel((3, 3, cin, features))
        self.bn = BatchNormKeras(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        (h_lo, h_hi), (w_lo, w_hi) = (same_pads(d, self.stride)
                                      for d in x.shape[2:])
        x = F.pad(x, (w_lo, w_hi, h_lo, h_hi))
        if self.separable:
            x = F.conv2d(x, self.depthwise.kernel.permute(3, 2, 0, 1),
                         stride=self.stride, groups=self.cin)
            x = F.conv2d(x, self.pointwise.kernel.permute(3, 2, 0, 1),
                         self.pointwise.bias)
        else:
            x = F.conv2d(x, self.conv.kernel.permute(3, 2, 0, 1),
                         stride=self.stride)
        if self.inline_relu:
            x = torch.relu(x)
        x = relu6(self.bn(x))
        if self.pool:
            x = F.max_pool2d(x, 2, 2)
        return x


class SimpleCNN(nn.Module):
    """Reference SimpleCNN: (B, H, W[, 1]) features -> (B, C) float32
    logits.  `forward(x, skip_block1=True)` takes the pooled (B, H/2, W/2,
    16) NHWC output of block 1 instead (the entry the fused block-1 kernel
    feeds)."""

    separable = False

    def __init__(self, num_classes: int, n_features: int = 30,
                 feature_size: int = 20):
        super().__init__()
        self.num_classes = num_classes
        self.n_features, self.feature_size = n_features, feature_size
        cin = 1
        for name, features, stride, pool in BLOCKS:
            self.add_module(name, ConvBlock(
                cin, features, stride, self.separable,
                inline_relu(name, self.separable), pool))
            cin = features
        h, w = output_hw(n_features, feature_size)
        if h < 1 or w < 1:
            raise ValueError(f"input {n_features}x{feature_size} is too small "
                             "for four conv blocks")
        self.feature_dense = Dense(h * w * cin, FEATURE_DENSE)
        self.score_predict = Dense(FEATURE_DENSE, num_classes)

    def blocks(self) -> list[ConvBlock]:
        return [getattr(self, name) for name, *_ in BLOCKS]

    def forward(self, x: torch.Tensor, skip_block1: bool = False) -> torch.Tensor:
        x = x.to(torch.float32)
        if x.ndim == 3:
            x = x[..., None]
        x = x.permute(0, 3, 1, 2)  # NHWC -> NCHW
        for block in self.blocks()[1 if skip_block1 else 0:]:
            x = block(x)
        x = x.permute(0, 2, 3, 1).flatten(1)  # NHWC flatten, as Keras
        return self.score_predict(relu6(self.feature_dense(x)))

    def variables(self) -> dict:
        """The parameters as the JAX package's tree of numpy arrays:
        {'params': {...}, 'batch_stats': {'blockN': {'bn': {mean, var}}}}."""
        params: dict = {}
        stats: dict = {}
        for key, value in self.state_dict().items():
            *path, leaf = key.split(".")
            root = stats if path[-1] == "bn" and leaf in ("mean", "var") else params
            node = root
            for part in path:
                node = node.setdefault(part, {})
            node[leaf] = value.detach().cpu().numpy().astype(np.float32)
        return {"params": params, "batch_stats": stats}


class SimpleCNNLite(SimpleCNN):
    """Reference SimpleCNNLite: SimpleCNN with separable convs."""

    separable = True
