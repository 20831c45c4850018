"""Classification losses (counterpart of `tpu_speech_commands/losses.py`).

Models emit logits; the losses take log_softmax, as the JAX package does.
"""
from __future__ import annotations

import numpy as np
import torch


def sparse_categorical_crossentropy(labels: torch.Tensor, logits: torch.Tensor,
                                    ignore_index: int | None = None
                                    ) -> torch.Tensor:
    """Per-sample CE: labels (B,) int, logits (B, C); an optional ignore
    mask zeroes the loss of `ignore_index` labels."""
    log_probs = torch.log_softmax(logits, dim=-1)
    losses = -torch.gather(log_probs, -1, labels[:, None].long())[:, 0]
    if ignore_index is not None:
        losses = losses * (labels != ignore_index).to(losses.dtype)
    return losses


def weighted_sparse_categorical_crossentropy(
        labels: torch.Tensor, logits: torch.Tensor, class_weights,
        ignore_index: int | None = None) -> torch.Tensor:
    """Per-sample CE scaled by the label's class weight."""
    losses = sparse_categorical_crossentropy(labels, logits, ignore_index)
    weights = torch.as_tensor(class_weights, dtype=losses.dtype,
                              device=losses.device)
    return losses * weights[labels.long()]


def background_bias_weights(bias: float, num_classes: int) -> np.ndarray:
    """Class-weight vector for --background_bias: [bias] + [(1 - bias) /
    (C - 1)] * (C - 1)."""
    if not 0.0 < bias < 1.0:  # not assert: python -O must still reject
        raise ValueError("background_bias should be in (0, 1)")
    if num_classes < 2:
        raise ValueError("background_bias needs at least 2 classes")
    rest = (1.0 - bias) / (num_classes - 1)
    return np.array([bias] + [rest] * (num_classes - 1), dtype=np.float32)


def make_loss_fn(num_classes: int, background_bias: float | None = None):
    """Per-sample loss closure (labels, logits) -> (B,) used by the train
    step (the trainer applies the padded-batch mask and reduces)."""
    if background_bias is not None:
        weights = background_bias_weights(background_bias, num_classes)

        def loss_fn(labels, logits):
            return weighted_sparse_categorical_crossentropy(labels, logits,
                                                            weights)
    else:

        def loss_fn(labels, logits):
            return sparse_categorical_crossentropy(labels, logits)

    return loss_fn
