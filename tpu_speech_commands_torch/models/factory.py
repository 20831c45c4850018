"""Model factory (counterpart of `tpu_speech_commands/models/factory.py`).

CNN models take (B, n_features, feature_size, 1) features (or the same
without the channel axis); RNN models take (B, n_features, feature_size).
All models return logits (B, num_classes), and `score_fn` applies the
reference's `score_predict` softmax.
"""
from __future__ import annotations

import torch

from ..params import pr
from .cnn import SimpleCNN, SimpleCNNLite
from .rnn import SimpleGRU, SimpleLSTM

MODEL_TYPES = ("simple_cnn", "simple_cnn_lite", "simple_gru", "simple_lstm")
CNN_MODEL_TYPES = ("simple_cnn", "simple_cnn_lite")


def is_cnn(model_type: str) -> bool:
    return model_type in CNN_MODEL_TYPES


def get_model(model_type: str, num_classes: int, num_layers: int = 1,
              feature_size: int | None = None, n_features: int | None = None):
    """Build a model for `model_type`; feature_size and n_features default
    to pr's (the config the checkpoint injected).  num_layers stacks RNN
    layers; CNNs reject num_layers != 1."""
    if is_cnn(model_type) and num_layers != 1:
        raise ValueError(f"num_layers only applies to RNN models, not {model_type}")
    if num_layers < 1:
        raise ValueError(f"num_layers must be >= 1, got {num_layers}")
    feature_size = feature_size or pr.feature_size
    if is_cnn(model_type):
        cls = SimpleCNN if model_type == "simple_cnn" else SimpleCNNLite
        return cls(num_classes, n_features or pr.n_features, feature_size)
    if model_type == "simple_gru":
        return SimpleGRU(num_classes, feature_size, 48, num_layers)
    if model_type == "simple_lstm":
        return SimpleLSTM(num_classes, feature_size, 48, num_layers)
    raise ValueError(f"Unsupported model type {model_type!r}")


def features_to_input(features: torch.Tensor, model_type: str) -> torch.Tensor:
    """(B, T, F) frontend output -> model input (a channel axis for CNNs)."""
    if is_cnn(model_type) and features.ndim == 3:
        return features[..., None]
    return features


def score_fn(logits: torch.Tensor) -> torch.Tensor:
    """Reference-compatible `score_predict` softmax output."""
    return torch.softmax(logits, dim=-1)
