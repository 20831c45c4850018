"""Carry the JAX package's parameter trees over to the port's modules.

The port keeps the Keras layouts and names the JAX package uses
(`models/rnn.py`, `models/cnn.py`): a GRU layer holds `kernel (D, 3U)`,
`recurrent_kernel (U, 3U)`, `bias_input (3U,)` and `bias_recurrent (3U,)`
with gates side by side in the order [z, r, h]; an LSTM layer `kernel
(D, 4U)`, `recurrent_kernel (U, 4U)` and `bias (4U,)` in the order
[i, f, c, o]; the head `score_predict/kernel (U, C)` and `bias (C,)`.  A CNN
block holds `conv/kernel (3, 3, Cin, Cout)`, or `depthwise/kernel (3, 3, 1,
Cin)` with `pointwise/kernel (1, 1, Cin, Cout)` and `pointwise/bias`, and
`bn/scale`, `bn/bias`; its BatchNorm running statistics come from
`batch_stats/blockN/bn/{mean, var}` and become the buffers `blockN.bn.mean`
and `.var`.  The mapping is therefore a renaming ('/' paths to '.'
state-dict keys) plus a check that the shapes fit together.
"""
from __future__ import annotations

import numpy as np
import torch

from .models.cnn import BLOCKS, FEATURE_DENSE
from .models.factory import CNN_MODEL_TYPES, MODEL_TYPES

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


def _fields(name: str, group: dict, fields: tuple) -> None:
    if not isinstance(group, dict) or set(group) != set(fields):
        held = sorted(group) if isinstance(group, dict) else type(group).__name__
        raise ValueError(f"{name} holds {held}, expected {sorted(fields)}")


def _put(state: dict, key: str, arr) -> None:
    state[key] = torch.tensor(np.asarray(arr, np.float32))


def _dense(state: dict, params: dict, name: str, in_dim: int | None) -> int:
    """Copy a Keras Dense group (kernel (in, out), bias (out,)); returns out.
    in_dim None takes whatever input width the kernel has."""
    group = params.get(name, {})
    _fields(name, group, ("kernel", "bias"))
    kernel = np.asarray(group["kernel"])
    if kernel.ndim != 2:
        raise ValueError(f"{name}/kernel has shape {kernel.shape}")
    _expect(f"{name}/kernel", kernel, (in_dim or kernel.shape[0], kernel.shape[1]))
    _expect(f"{name}/bias", group["bias"], (kernel.shape[1],))
    for field in ("kernel", "bias"):
        _put(state, f"{name}.{field}", group[field])
    return kernel.shape[1]


def _cnn_state(variables: dict, model_type: str) -> dict:
    separable = model_type == "simple_cnn_lite"
    params = variables["params"]
    stats = variables.get("batch_stats")
    if stats is None:
        raise ValueError(f"{model_type} needs batch_stats (BatchNorm running "
                         "statistics), the tree has none")
    names = [name for name, *_ in BLOCKS]
    want = set(names) | {"feature_dense", "score_predict"}
    if set(params) != want:
        raise ValueError(f"parameter groups {sorted(params)} are not "
                         f"{sorted(want)} for {model_type}")
    if set(stats) != set(names):
        raise ValueError(f"batch_stats groups {sorted(stats)} are not "
                         f"{sorted(names)}")
    state = {}
    cin = 1
    for name, cout, _, _ in BLOCKS:
        block = params[name]
        convs = ({"depthwise": ((3, 3, 1, cin),),
                  "pointwise": ((1, 1, cin, cout), (cout,))}
                 if separable else {"conv": ((3, 3, cin, cout),)})
        _fields(name, block, tuple(convs) + ("bn",))
        for group, shapes in convs.items():
            fields = ("kernel", "bias")[:len(shapes)]
            _fields(f"{name}/{group}", block[group], fields)
            for field, shape in zip(fields, shapes):
                _expect(f"{name}/{group}/{field}", block[group][field], shape)
                _put(state, f"{name}.{group}.{field}", block[group][field])
        _fields(f"batch_stats/{name}", stats[name], ("bn",))
        for bn, fields in ((block["bn"], ("scale", "bias")),
                           (stats[name]["bn"], ("mean", "var"))):
            _fields(f"{name}/bn", bn, fields)
            for field in fields:
                _expect(f"{name}/bn/{field}", bn[field], (cout,))
                _put(state, f"{name}.bn.{field}", bn[field])
        cin = cout
    hidden = _dense(state, params, "feature_dense", None)
    if hidden != FEATURE_DENSE:
        raise ValueError(f"feature_dense has {hidden} units, expected "
                         f"{FEATURE_DENSE}")
    _dense(state, params, "score_predict", hidden)
    return state


def torch_state_from_jax(variables: dict, model_type: str) -> dict:
    """JAX `{'params': ...[, 'batch_stats': ...]}` tree of numpy arrays ->
    port state dict of float32 CPU tensors.  Raises ValueError on missing,
    unknown or mis-shaped tensors."""
    if model_type not in MODEL_TYPES:
        raise ValueError(f"unknown model type {model_type!r}")
    if model_type in CNN_MODEL_TYPES:
        return _cnn_state(variables, model_type)
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
            _put(state, f"backbone.{name}.{field}", layer[field])
    _dense(state, params, "score_predict", units)
    return state
