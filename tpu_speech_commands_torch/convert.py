"""Carry the JAX package's parameter trees over to the port's modules.

The port keeps the Keras layouts and names the JAX package uses
(`models/rnn.py`): a GRU layer holds `kernel (D, 3U)`,
`recurrent_kernel (U, 3U)`, `bias_input (3U,)` and `bias_recurrent (3U,)`
with gates side by side in the order [z, r, h]; an LSTM layer `kernel
(D, 4U)`, `recurrent_kernel (U, 4U)` and `bias (4U,)` in the order
[i, f, c, o]; the head `score_predict/kernel (U, C)` and `bias (C,)`.  The
mapping is therefore a renaming ('/' paths to '.' state-dict keys) plus a
check that the shapes fit together.
"""
from __future__ import annotations

import numpy as np
import torch

from .models.factory import CNN_MODEL_TYPES, MODEL_TYPES, get_model

_CELL_FIELDS = {
    "gru": ("kernel", "recurrent_kernel", "bias_input", "bias_recurrent"),
    "lstm": ("kernel", "recurrent_kernel", "bias"),
}
_GATES = {"gru": 3, "lstm": 4}


def _expect(name: str, arr: np.ndarray, shape: tuple) -> None:
    if tuple(arr.shape) != tuple(shape):
        raise ValueError(
            f"checkpoint tensor {name} has shape {tuple(arr.shape)}, "
            f"expected {tuple(shape)}"
        )


def torch_state_from_jax(variables: dict, model_type: str) -> dict:
    """JAX `{'params': ...}` tree of numpy arrays -> port state dict of
    float32 CPU tensors.  Raises ValueError on missing, unknown or
    mis-shaped tensors."""
    if model_type not in MODEL_TYPES:
        raise ValueError(f"unknown model type {model_type!r}")
    if model_type in CNN_MODEL_TYPES:
        get_model(model_type, 1)  # raises NotImplementedError naming the item
    cell = "gru" if model_type == "simple_gru" else "lstm"
    params = variables["params"]
    backbone = params.get("backbone", {})
    prefix = f"{cell}_unit_"
    layer_names = sorted(
        (k for k in backbone if k.startswith(prefix)),
        key=lambda k: int(k[len(prefix):]),
    )
    if not layer_names or set(layer_names) != set(backbone) or layer_names != [
        f"{prefix}{i}" for i in range(len(layer_names))
    ]:
        raise ValueError(
            f"backbone layers {sorted(backbone)} are not "
            f"{prefix}0..{prefix}N-1 for {model_type}"
        )
    unknown = set(params) - {"backbone", "score_predict"}
    if unknown:
        raise ValueError(f"unknown parameter groups {sorted(unknown)}")

    n_gates = _GATES[cell]
    state = {}
    units = None
    for name in layer_names:
        layer = backbone[name]
        if set(layer) != set(_CELL_FIELDS[cell]):
            raise ValueError(
                f"{name} holds {sorted(layer)}, expected "
                f"{sorted(_CELL_FIELDS[cell])}"
            )
        kernel = np.asarray(layer["kernel"])
        if kernel.ndim != 2 or kernel.shape[1] % n_gates:
            raise ValueError(f"{name}/kernel has shape {kernel.shape}")
        u = kernel.shape[1] // n_gates
        units = units or u
        _expect(f"{name}/kernel", kernel, (kernel.shape[0], n_gates * units))
        _expect(f"{name}/recurrent_kernel", layer["recurrent_kernel"],
                (units, n_gates * units))
        for field in _CELL_FIELDS[cell][2:]:
            _expect(f"{name}/{field}", layer[field], (n_gates * units,))
        for field in _CELL_FIELDS[cell]:
            state[f"backbone.{name}.{field}"] = torch.tensor(
                np.asarray(layer[field], np.float32)
            )
    head = params.get("score_predict", {})
    if set(head) != {"kernel", "bias"}:
        raise ValueError(f"score_predict holds {sorted(head)}")
    head_w = np.asarray(head["kernel"])
    if head_w.ndim != 2:
        raise ValueError(f"score_predict/kernel has shape {head_w.shape}")
    _expect("score_predict/kernel", head_w, (units, head_w.shape[1]))
    _expect("score_predict/bias", head["bias"], (head_w.shape[1],))
    for field in ("kernel", "bias"):
        state[f"score_predict.{field}"] = torch.tensor(
            np.asarray(head[field], np.float32)
        )
    return state
