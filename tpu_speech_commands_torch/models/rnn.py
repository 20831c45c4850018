"""Recurrent keyword-spotting models as `nn.Module`s (counterpart of
`tpu_speech_commands/models/rnn.py`).

Keras semantics, as in the JAX package:
- GRU: reset_after (separate input and recurrent biases, the recurrent bias
  inside the reset gate), sigmoid gates, gate order [z, r, h], and the
  reference's LINEAR candidate activation.  `nn.GRU` hard-codes tanh and
  cannot stand in.
- LSTM: gate order [i, f, c, o], tanh, the unit forget bias already baked
  into the stored bias vector.
- Dropout only acts in training; these modules are inference-only, so it
  does not appear.

The time loop is a plain Python loop.  For the GRU it is the plain version
of the GRU kernel (`ops/rnn_kernel.py`, `csrc/gru_classifier.cu`).
`compute_dtype=torch.bfloat16` reproduces that kernel's bf16 mode: matmul
inputs (x, h and the weights) rounded to bf16, products accumulated in f32,
biases and gate math in f32.  Parameters start at zero: their values come
from a checkpoint (`convert.py`).
"""
from __future__ import annotations

import torch
from torch import nn


def _rounded(t: torch.Tensor, compute_dtype) -> torch.Tensor:
    """Round a float32 tensor to compute_dtype and back: a product of two
    such values is exact in f32, so f32 matmuls of rounded operands equal
    low-precision matmuls with f32 accumulation."""
    if compute_dtype == torch.float32:
        return t
    return t.to(compute_dtype).to(torch.float32)


def _mm(x, w, compute_dtype):
    return torch.matmul(_rounded(x, compute_dtype), _rounded(w, compute_dtype))


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

    def __init__(self, cell_type: str, input_size: int, units: int = 48,
                 num_layers: int = 1):
        super().__init__()
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

    def forward(self, x, compute_dtype=torch.float32):
        x = x.to(torch.float32)
        batch = x.shape[0]
        for cell in self.cells():
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
    """Keras Dense layer: kernel (in, out), bias (out,)."""

    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(in_features, out_features))
        self.bias = nn.Parameter(torch.zeros(out_features))

    def forward(self, x, compute_dtype=torch.float32):
        return _mm(x, self.kernel, compute_dtype) + self.bias


class _SimpleRNN(nn.Module):
    cell_type = ""

    def __init__(self, num_classes: int, feature_size: int = 20,
                 recurrent_units: int = 48, num_layers: int = 1):
        super().__init__()
        self.num_classes = num_classes
        self.backbone = RecurrentStack(self.cell_type, feature_size,
                                       recurrent_units, num_layers)
        self.score_predict = Dense(recurrent_units, num_classes)

    def forward(self, x, compute_dtype=torch.float32):
        """(B, T, D) features -> (B, num_classes) float32 logits."""
        return self.score_predict(self.backbone(x, compute_dtype),
                                  compute_dtype)


class SimpleGRU(_SimpleRNN):
    """Reference SimpleGRU: stacked Keras GRU(48) -> Dense head (logits)."""

    cell_type = "gru"


class SimpleLSTM(_SimpleRNN):
    """Reference SimpleLSTM: stacked Keras LSTM(48) -> Dense head (logits)."""

    cell_type = "lstm"
