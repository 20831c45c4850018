"""Recurrent keyword-spotting models as `nn.Module`s (counterpart of
`tpu_speech_commands/models/rnn.py`).

Keras semantics, as in the JAX package:
- GRU: reset_after (separate input and recurrent biases, the recurrent bias
  inside the reset gate), sigmoid gates, gate order [z, r, h], and the
  reference's LINEAR candidate activation.  `nn.GRU` hard-codes tanh and
  cannot stand in.
- LSTM: gate order [i, f, c, o], tanh, the unit forget bias already baked
  into the stored bias vector.
- Dropout acts only in training mode (`model.train()`): one input mask per
  sequence and layer, shared across all time steps (Keras RNN dropout), at
  `dropout_rate` 0.2, drawn from the `generator` the caller passes (under a
  process mesh, the global batch's mask, of which each rank keeps its
  rows).  A model is built in eval mode, as the JAX model's `train`
  defaults to False: the train step calls `.train()`.

The time loop is a plain Python loop.  For the GRU it is the plain version
of the GRU kernel (`ops/rnn_kernel.py`, `csrc/gru_classifier.cu`), and the
module the train step differentiates.  `compute_dtype=torch.bfloat16`
reproduces that kernel's bf16 mode: matmul inputs (x, h and the weights)
rounded to bf16, products accumulated in f32, biases and gate math in f32.
Parameters start at zero: their values come from a checkpoint
(`convert.py`) or from `models.factory.init_model`.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..parallel.tensor_parallel import parallel_dense


def _rounded(t: torch.Tensor, compute_dtype) -> torch.Tensor:
    """Round a float32 tensor to compute_dtype and back: a product of two
    such values is exact in f32, so f32 matmuls of rounded operands equal
    low-precision matmuls with f32 accumulation."""
    if compute_dtype == torch.float32:
        return t
    return t.to(compute_dtype).to(torch.float32)


def _mm(x, w, compute_dtype):
    return torch.matmul(_rounded(x, compute_dtype), _rounded(w, compute_dtype))


def dropout(x: torch.Tensor, rate: float, shape: tuple,
            generator=None, mesh=None) -> torch.Tensor:
    """flax Dropout: keep each element of a mask of `shape` (broadcast
    over x) with probability 1 - rate and scale the kept by 1 / (1 - rate).
    The mask is drawn from `generator` (on x's device).  Under a process
    `mesh`, x holds this rank's rows of the global batch: the mask is drawn
    for the global batch and the rank keeps its rows, so a sharded step
    draws what the one-device step draws."""
    keep = 1.0 - rate
    rows = None
    if mesh is not None:
        rows = mesh.batch_rows(shape[0] * mesh.n_batch)
        shape = (shape[0] * mesh.n_batch,) + tuple(shape[1:])
    mask = torch.rand(shape, generator=generator, device=x.device) < keep
    if rows is not None:
        mask = mask[rows]
    return torch.where(mask, x / keep, torch.zeros((), device=x.device))


def jax_variables(module: nn.Module) -> dict:
    """A module's state as the JAX package's variables tree of numpy
    arrays: {'params': {...}[, 'batch_stats': {...}]}, BatchNorm running
    statistics (`bn.mean`, `bn.var`) under batch_stats."""
    params: dict = {}
    stats: dict = {}
    for key, value in module.state_dict().items():
        *path, leaf = key.split(".")
        root = stats if path[-1] == "bn" and leaf in ("mean", "var") else params
        node = root
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = value.detach().cpu().numpy().astype(np.float32)
    return {"params": params, "batch_stats": stats} if stats else \
        {"params": params}


class GRUCellKeras(nn.Module):
    """Keras GRU cell, reset_after, linear candidate, gates [z, r, h]."""

    def __init__(self, input_size: int, units: int):
        super().__init__()
        self.units = units
        self.kernel = nn.Parameter(torch.zeros(input_size, 3 * units))
        self.recurrent_kernel = nn.Parameter(torch.zeros(units, 3 * units))
        self.bias_input = nn.Parameter(torch.zeros(3 * units))
        self.bias_recurrent = nn.Parameter(torch.zeros(3 * units))

    def forward(self, h, x, compute_dtype=torch.float32):
        xw = _mm(x, self.kernel, compute_dtype) + self.bias_input
        hw = _mm(h, self.recurrent_kernel, compute_dtype) + self.bias_recurrent
        xz, xr, xh = xw.chunk(3, dim=-1)
        hz, hr, hh = hw.chunk(3, dim=-1)
        z = torch.sigmoid(xz + hz)
        r = torch.sigmoid(xr + hr)
        cand = xh + r * hh  # reset_after; linear candidate activation
        return z * h + (1.0 - z) * cand


class LSTMCellKeras(nn.Module):
    """Keras LSTM cell, gates [i, f, c, o], tanh activations."""

    def __init__(self, input_size: int, units: int):
        super().__init__()
        self.units = units
        self.kernel = nn.Parameter(torch.zeros(input_size, 4 * units))
        self.recurrent_kernel = nn.Parameter(torch.zeros(units, 4 * units))
        self.bias = nn.Parameter(torch.zeros(4 * units))

    def forward(self, carry, x, compute_dtype=torch.float32):
        h, c = carry
        gates = (_mm(x, self.kernel, compute_dtype)
                 + _mm(h, self.recurrent_kernel, compute_dtype) + self.bias)
        i, f, g, o = gates.chunk(4, dim=-1)
        c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        return torch.sigmoid(o) * torch.tanh(c_new), c_new


class RecurrentStack(nn.Module):
    """Stacked RNN over (B, T, D); returns the last layer's final h."""

    mesh = None  # a ProcessMesh: dropout's mask is the global batch's

    def __init__(self, cell_type: str, input_size: int, units: int = 48,
                 num_layers: int = 1, dropout_rate: float = 0.2):
        super().__init__()
        self.dropout_rate = dropout_rate
        if cell_type not in ("gru", "lstm"):
            raise ValueError(f"cell_type must be gru|lstm, got {cell_type!r}")
        cell_cls = GRUCellKeras if cell_type == "gru" else LSTMCellKeras
        self.cell_type = cell_type
        self.units = units
        # registered under the JAX tree's names, so state-dict keys read
        # `backbone.gru_unit_0.kernel`
        self.layer_names = [f"{cell_type}_unit_{i}" for i in range(num_layers)]
        for i, name in enumerate(self.layer_names):
            self.add_module(name, cell_cls(input_size if i == 0 else units,
                                           units))

    def cells(self) -> list[nn.Module]:
        return [getattr(self, name) for name in self.layer_names]

    def forward(self, x, compute_dtype=torch.float32, generator=None):
        x = x.to(torch.float32)
        batch = x.shape[0]
        for cell in self.cells():
            if self.training and self.dropout_rate > 0.0:
                x = dropout(x, self.dropout_rate, (batch, 1, x.shape[-1]),
                            generator, self.mesh)
            h = x.new_zeros(batch, self.units)
            carry = (h, h) if self.cell_type == "lstm" else h
            outs = []
            for t in range(x.shape[1]):
                carry = cell(carry, x[:, t], compute_dtype)
                h = carry[0] if self.cell_type == "lstm" else carry
                outs.append(h)
            x = torch.stack(outs, dim=1)  # next layer reads the sequence
        return h


class Dense(nn.Module):
    """Keras Dense layer: kernel (in, out), bias (out,).  Under tensor
    parallelism (`parallel.tensor_parallel.shard_model`) it holds this
    rank's shard: `parallel` "column" or "row", the collectives from
    `mesh`."""

    mesh = None
    parallel = None

    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(in_features, out_features))
        self.bias = nn.Parameter(torch.zeros(out_features))

    def forward(self, x, compute_dtype=torch.float32):
        if self.parallel is not None:
            return parallel_dense(self, x, _mm, compute_dtype)
        return _mm(x, self.kernel, compute_dtype) + self.bias


class _SimpleRNN(nn.Module):
    cell_type = ""

    def __init__(self, num_classes: int, feature_size: int = 20,
                 recurrent_units: int = 48, num_layers: int = 1,
                 dropout_rate: float = 0.2):
        super().__init__()
        self.num_classes = num_classes
        self.backbone = RecurrentStack(self.cell_type, feature_size,
                                       recurrent_units, num_layers,
                                       dropout_rate)
        self.score_predict = Dense(recurrent_units, num_classes)
        self.eval()  # inference unless asked, as the JAX model's train=False

    def forward(self, x, compute_dtype=torch.float32, generator=None):
        """(B, T, D) features -> (B, num_classes) float32 logits; in
        training mode the input dropout draws from `generator`."""
        return self.score_predict(self.backbone(x, compute_dtype, generator),
                                  compute_dtype)

    def variables(self) -> dict:
        """The parameters as the JAX package's tree of numpy arrays."""
        return jax_variables(self)


class SimpleGRU(_SimpleRNN):
    """Reference SimpleGRU: stacked Keras GRU(48) -> Dense head (logits)."""

    cell_type = "gru"


class SimpleLSTM(_SimpleRNN):
    """Reference SimpleLSTM: stacked Keras LSTM(48) -> Dense head (logits)."""

    cell_type = "lstm"
