"""Model factory (counterpart of `tpu_speech_commands/models/factory.py`).

RNN models take (B, n_features, feature_size) features; all models return
logits (B, num_classes), and `score_fn` applies the reference's
`score_predict` softmax.  The CNN families are not ported yet and are
refused explicitly.
"""
from __future__ import annotations

import torch

from ..params import pr
from .rnn import SimpleGRU, SimpleLSTM

MODEL_TYPES = ("simple_cnn", "simple_cnn_lite", "simple_gru", "simple_lstm")
CNN_MODEL_TYPES = ("simple_cnn", "simple_cnn_lite")


def is_cnn(model_type: str) -> bool:
    return model_type in CNN_MODEL_TYPES


def get_model(model_type: str, num_classes: int, num_layers: int = 1,
              feature_size: int | None = None):
    """Build a model for `model_type`; feature_size defaults to
    pr.feature_size (the config the checkpoint injected)."""
    if num_layers < 1:
        raise ValueError(f"num_layers must be >= 1, got {num_layers}")
    if is_cnn(model_type):
        raise NotImplementedError(
            f"{model_type} is not ported to PyTorch yet: see ROADMAP.md, "
            "'Modules to port', item 3 (CNN models and the CNN classifier "
            "kernel K4)"
        )
    feature_size = feature_size or pr.feature_size
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
