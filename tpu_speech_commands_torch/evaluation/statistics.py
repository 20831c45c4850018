"""Model statistics: parameters and FLOPs (counterpart of
`tpu_speech_commands/evaluation/statistics.py`, with the same keys).

The JAX package reads its FLOPs from XLA's cost analysis of the compiled
forward, which has no counterpart here.  The port counts the products of
the plain forward on the CPU with `torch.utils.flop_counter.FlopCounterMode`:
2 x the multiply-accumulates of every matmul and convolution, and nothing
else (no activation, normalisation, pooling or softmax), so its figure sits
below XLA's, which also counts the elementwise work.
"""
from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from ..models import init_model, input_shape


def clever_format(value: float, fmt: str = "%.3f") -> str:
    """Human units (T, G, M, K, else B)."""
    for unit, scale in (("T", 1e12), ("G", 1e9), ("M", 1e6), ("K", 1e3)):
        if value >= scale:
            return (fmt % (value / scale)) + unit
    return (fmt % value) + "B"


def count_params(model: torch.nn.Module) -> int:
    """The trainable parameters (the JAX tree's `params`; BatchNorm's
    running statistics are buffers and do not count)."""
    return sum(p.numel() for p in model.parameters())


def model_flops(model: torch.nn.Module, model_type: str,
                batch_size: int = 1) -> float:
    """2 x the multiply-accumulates of one inference forward at
    `batch_size`, counted on the CPU."""
    x = torch.zeros((batch_size,) + input_shape(model_type))
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        model.eval()(x)
    return float(counter.get_total_flops())


def get_model_statistics(model_type: str, num_classes: int,
                         batch_size: int = 1) -> dict:
    """{model_type, num_classes, batch_size, params, flops, params_str,
    flops_str} of a freshly built model at the current `pr`."""
    model, _ = init_model(model_type, num_classes)
    n_params = count_params(model)
    flops = model_flops(model, model_type, batch_size)
    return {
        "model_type": model_type,
        "num_classes": num_classes,
        "batch_size": batch_size,
        "params": n_params,
        "flops": flops,
        "params_str": clever_format(n_params),
        "flops_str": clever_format(flops),
    }
