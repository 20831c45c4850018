"""The frontend inside the train and eval steps (counterpart of
`tpu_speech_commands/ops/training_frontend.py`).

The JAX package runs its fused Pallas kernel inside the jitted step where
the config and the mesh allow, else the XLA chain.  Here a CUDA device takes
`MfccFrontend` for every config: the frontend kernel of the route
`frontend_route` picks (the FFT kernel, route ct's kernels, or the plain
chain on the card where the JAX scorer, too, runs XLA), named as
`serving.py`'s `.paths` names it.  The CPU takes the plain chain, and says
so.  There is no mesh and no shard_map: the port trains on one device.
"""
from __future__ import annotations

import torch

from ..device import DEFAULT_DEVICE, resolve_device
from ..params import ListenerParams
from .frontend_kernel import MfccFrontend


def select_training_frontend(p: ListenerParams, feature_type: str,
                             batch_size: int, device=DEFAULT_DEVICE,
                             verbose: bool = True):
    """Build the frontend used inside the train / eval step.  Returns
    (frontend_fn, kind): frontend_fn (audio, gain=None) -> (B, n_features,
    feature_size) float32 features, int16 audio decoded before the gain,
    run without autograd (the frontend has no parameters); kind names the
    kernel ("cuda-mfcc", "cuda-ct[(body)]", "torch(xla-route)") or "torch"
    on the CPU.  Raises ValueError on CUDA for a config the route's kernel
    cannot take, RuntimeError without CUDA."""
    del batch_size  # every batch takes the kernel: no tile constraint
    device = resolve_device(device)
    fe = MfccFrontend(p, feature_type, device)
    kind = fe.path

    def frontend(audio: torch.Tensor, gain=None) -> torch.Tensor:
        with torch.no_grad():
            return fe(audio, gain)

    if verbose:
        where = ("the plain chain on the CPU" if device.type == "cpu" else
                 f"MfccFrontend route {fe.route}"
                 + (f", body {fe.body}" if fe.body else ""))
        print(f"frontend: {kind} ({where})")
    return frontend, kind
