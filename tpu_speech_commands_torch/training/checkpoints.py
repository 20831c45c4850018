"""Checkpoint writing with the reference's policy (counterpart of
`tpu_speech_commands/training/checkpoints.py`).

- per-epoch checkpoints named
  ``ep{epoch:03d}-loss{loss:.3f}-accuracy{acc:.3f}-val_loss{vl:.3f}-val_accuracy{va:.3f}.npz``
  saved only on a new best val_accuracy
- newest `max_keep` kept, older ``ep*.npz`` deleted (by mtime)
- final ``trained_final.npz``

The format is the JAX package's flat ``.npz``: every parameter and batch
statistic under a '/'-joined path key plus a ``__meta__`` JSON blob, so
either package (and the export tools) reads what the other wrote.  The one
reader is `tpu_speech_commands_torch/checkpoints.py::load_checkpoint`.
"""
from __future__ import annotations

import json
import os
from glob import glob

import numpy as np
import torch

from ..checkpoints import load_checkpoint
from ..convert import torch_state_from_jax


def _flatten(tree: dict, prefix: str) -> dict[str, np.ndarray]:
    flat = {}
    for key in sorted(tree):
        value = tree[key]
        path = f"{prefix}/{key}"
        if isinstance(value, dict):
            flat.update(_flatten(value, path))
        else:
            flat[path] = np.asarray(value)
    return flat


def flatten_variables(variables: dict) -> dict[str, np.ndarray]:
    """{'params': ..., 'batch_stats': ...} tree -> the 'section/a/b' flat
    dict of the checkpoint file."""
    flat: dict[str, np.ndarray] = {}
    for section in ("params", "batch_stats"):
        tree = variables.get(section)
        if tree is not None:
            flat.update(_flatten(tree, section))
    return flat


def save_checkpoint(path: str, model_or_variables, meta: dict | None = None
                    ) -> None:
    """Write a model's parameters (+ BatchNorm statistics), or a JAX-layout
    variables tree, with `meta` as the ``__meta__`` blob."""
    variables = (model_or_variables.variables()
                 if isinstance(model_or_variables, torch.nn.Module)
                 else model_or_variables)
    payload = flatten_variables(variables)
    payload["__meta__"] = np.frombuffer(json.dumps(meta or {}).encode(),
                                        dtype=np.uint8)
    np.savez(path, **payload)


def restore_state(model: torch.nn.Module, path: str, model_type: str
                  ) -> torch.nn.Module:
    """Load a checkpoint's tensors into `model` in place (shape-checked:
    ValueError on a missing, unknown or mis-shaped tensor)."""
    variables, _ = load_checkpoint(path)
    state = torch_state_from_jax(variables, model_type)
    want = model.state_dict()
    if set(state) != set(want):
        raise ValueError(f"checkpoint tensors {sorted(set(state) ^ set(want))} "
                         f"do not match the {model_type} model")
    for key, value in state.items():
        if value.shape != want[key].shape:
            raise ValueError(f"checkpoint tensor shape {tuple(value.shape)} "
                             f"!= state {tuple(want[key].shape)} ({key})")
        with torch.no_grad():
            want[key].copy_(value)
    return model


class CheckpointManager:
    """Best-on-val-accuracy epoch checkpoints with keep-newest-N cleanup."""

    def __init__(self, log_dir: str, max_keep: int = 5, meta: dict | None = None):
        self.log_dir = log_dir
        self.max_keep = max_keep
        self.meta = meta or {}
        os.makedirs(log_dir, exist_ok=True)

    def save_epoch(self, model, em) -> str:
        name = (
            f"ep{em.epoch:03d}-loss{em.loss:.3f}-accuracy{em.accuracy:.3f}"
            f"-val_loss{em.val_loss:.3f}-val_accuracy{em.val_accuracy:.3f}.npz"
        )
        path = os.path.join(self.log_dir, name)
        save_checkpoint(path, model, {**self.meta, "epoch": em.epoch})
        self._clean()
        return path

    def save_final(self, model) -> str:
        path = os.path.join(self.log_dir, "trained_final.npz")
        save_checkpoint(path, model, self.meta)
        return path

    @staticmethod
    def _by_recency(paths):
        """Newest last, by modification time: a filename order would keep
        stale checkpoints after --resume restarts the epoch counter."""
        return sorted(paths, key=os.path.getmtime)

    def _clean(self):
        ckpts = self._by_recency(glob(os.path.join(self.log_dir, "ep*.npz")))
        stales = ckpts[: -self.max_keep] if self.max_keep > 0 else ckpts
        for stale in stales:
            os.remove(stale)

    def latest(self) -> str | None:
        ckpts = self._by_recency(glob(os.path.join(self.log_dir, "ep*.npz")))
        return ckpts[-1] if ckpts else None
