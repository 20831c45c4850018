"""Model factory (counterpart of `tpu_speech_commands/models/factory.py`).

CNN models take (B, n_features, feature_size, 1) features (or the same
without the channel axis); RNN models take (B, n_features, feature_size).
All models return logits (B, num_classes), and `score_fn` applies the
reference's `score_predict` softmax.
"""
from __future__ import annotations

import numpy as np
import torch

from ..params import pr
from .cnn import SimpleCNN, SimpleCNNLite
from .rnn import SimpleGRU, SimpleLSTM

MODEL_TYPES = ("simple_cnn", "simple_cnn_lite", "simple_gru", "simple_lstm")
CNN_MODEL_TYPES = ("simple_cnn", "simple_cnn_lite")


def is_cnn(model_type: str) -> bool:
    return model_type in CNN_MODEL_TYPES


def get_model(model_type: str, num_classes: int, num_layers: int = 1,
              feature_size: int | None = None, n_features: int | None = None,
              bn_momentum: float = 0.99, dropout_rate: float | None = None):
    """Build a model for `model_type`; feature_size and n_features default
    to pr's (the config the checkpoint injected).  num_layers stacks RNN
    layers; CNNs reject num_layers != 1.  dropout_rate None keeps the
    model's own (0.2 RNN, 0.5 CNN); bn_momentum is the CNNs' BatchNorm's."""
    if is_cnn(model_type) and num_layers != 1:
        raise ValueError(f"num_layers only applies to RNN models, not {model_type}")
    if num_layers < 1:
        raise ValueError(f"num_layers must be >= 1, got {num_layers}")
    feature_size = feature_size or pr.feature_size
    drop = {} if dropout_rate is None else {"dropout_rate": dropout_rate}
    if is_cnn(model_type):
        cls = SimpleCNN if model_type == "simple_cnn" else SimpleCNNLite
        return cls(num_classes, n_features or pr.n_features, feature_size,
                   bn_momentum=bn_momentum, **drop)
    if model_type == "simple_gru":
        return SimpleGRU(num_classes, feature_size, 48, num_layers, **drop)
    if model_type == "simple_lstm":
        return SimpleLSTM(num_classes, feature_size, 48, num_layers, **drop)
    raise ValueError(f"Unsupported model type {model_type!r}")


def input_shape(model_type: str, batch_size: int | None = None, params=None):
    """Model input shape: 4-D for CNNs, 3-D for RNNs."""
    p = params or pr
    base = (p.n_features, p.feature_size)
    shape = base + (1,) if is_cnn(model_type) else base
    return (batch_size,) + shape if batch_size else shape


def _lecun_normal(t: torch.Tensor, fan_in: int, gen: torch.Generator) -> None:
    """flax's default kernel init: a normal truncated at 2 stddev, scaled so
    its variance is 1 / fan_in."""
    std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
    with torch.no_grad():
        t.copy_(torch.nn.init.trunc_normal_(torch.empty(t.shape), std=std,
                                            a=-2.0 * std, b=2.0 * std,
                                            generator=gen))


def _initialise(model: torch.nn.Module, gen: torch.Generator) -> None:
    """The JAX modules' initialisers, each parameter by its name: conv and
    dense kernels lecun_normal (fan_in the kernel's input taps), an RNN
    cell's kernel glorot_uniform and recurrent kernel orthogonal, biases
    zero (the LSTM's forget gate one), BatchNorm at identity."""
    for name, t in model.named_parameters():
        leaf = name.split(".")[-1]
        cell = ".backbone." in f".{name}" and leaf in ("kernel",
                                                      "recurrent_kernel")
        with torch.no_grad():
            if cell and leaf == "kernel":
                torch.nn.init.xavier_uniform_(t, generator=gen)
            elif cell:
                torch.nn.init.orthogonal_(t, generator=gen)
            elif leaf == "kernel":
                _lecun_normal(t, int(np.prod(t.shape[:-1])), gen)
            elif leaf == "scale":
                t.fill_(1.0)
            else:
                t.zero_()
            if leaf == "bias" and name.startswith("backbone.lstm_unit_"):
                units = t.shape[0] // 4
                t[units:2 * units] = 1.0  # unit forget bias


def init_model(model_type: str, num_classes: int, seed: int = 0,
               params=None, num_layers: int = 1, bn_momentum: float | None = None,
               dropout_rate: float | None = None):
    """Build and initialise on the CPU from `seed`; returns (model,
    variables), variables the JAX-layout tree of numpy arrays, with the
    names and shapes of the JAX `init_model`'s."""
    p = params or pr
    kwargs = {} if bn_momentum is None else {"bn_momentum": bn_momentum}
    model = get_model(model_type, num_classes, num_layers=num_layers,
                      feature_size=p.feature_size, n_features=p.n_features,
                      dropout_rate=dropout_rate, **kwargs)
    _initialise(model, torch.Generator().manual_seed(int(seed)))
    return model, model.variables()


def features_to_input(features: torch.Tensor, model_type: str) -> torch.Tensor:
    """(B, T, F) frontend output -> model input (a channel axis for CNNs)."""
    if is_cnn(model_type) and features.ndim == 3:
        return features[..., None]
    return features


def score_fn(logits: torch.Tensor) -> torch.Tensor:
    """Reference-compatible `score_predict` softmax output."""
    return torch.softmax(logits, dim=-1)
