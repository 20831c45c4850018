"""Reader for the flat `.npz` checkpoint (counterpart of
`tpu_speech_commands/training/checkpoints.py::load_checkpoint`).

The file holds every parameter and batch statistic under a '/'-joined path
key (`params/backbone/gru_unit_0/kernel`, `batch_stats/...`) plus a
`__meta__` JSON blob.  Reading it needs numpy only.
"""
from __future__ import annotations

import json

import numpy as np


def _unflatten(flat: dict[str, np.ndarray], prefix: str):
    tree: dict = {}
    pfx = prefix + "/"
    for key, value in flat.items():
        if not key.startswith(pfx):
            continue
        node = tree
        parts = key[len(pfx):].split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value
    return tree or None


def load_checkpoint(path: str):
    """Returns (variables, meta): variables is {'params': tree[,
    'batch_stats': tree]} of numpy arrays, meta the decoded JSON dict."""
    with np.load(path, allow_pickle=False) as data:
        flat = {k: data[k] for k in data.files}
    meta = json.loads(
        bytes(flat.pop("__meta__", np.array([], np.uint8))) or b"{}"
    )
    variables = {"params": _unflatten(flat, "params")}
    batch_stats = _unflatten(flat, "batch_stats")
    if batch_stats is not None:
        variables["batch_stats"] = batch_stats
    return variables, meta
