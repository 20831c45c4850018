"""The frontend inside the train and eval steps (counterpart of
`tpu_speech_commands/ops/training_frontend.py`).

The JAX package runs its fused Pallas kernel inside the jitted step where
the config and the mesh allow, else the XLA chain.  Here a CUDA device takes
`MfccFrontend` for every config: the frontend kernel of the route
`frontend_route` picks (the FFT kernel, route ct's kernels, or the plain
chain on the card where the JAX scorer, too, runs XLA), named as
`serving.py`'s `.paths` names it.  The CPU takes the plain chain, and says
so.  Under a process mesh (one rank a device, `parallel/`) each rank runs
the frontend on its own rows of the batch, on its own device: the
counterpart of the JAX `'pallas+shard_map'`, named "<kind>+ranks".
"""
from __future__ import annotations

import torch

from ..device import DEFAULT_DEVICE, resolve_device
from ..params import ListenerParams
from .frontend_kernel import MfccFrontend


def select_training_frontend(p: ListenerParams, feature_type: str,
                             batch_size: int, device=DEFAULT_DEVICE,
                             verbose: bool = True, mesh=None):
    """Build the frontend used inside the train / eval step.  Returns
    (frontend_fn, kind): frontend_fn (audio, gain=None) -> (B, n_features,
    feature_size) float32 features, int16 audio decoded before the gain,
    run without autograd (the frontend has no parameters); kind names the
    kernel ("cuda-mfcc", "cuda-ct[(body)]", "torch(xla-route)") or "torch"
    on the CPU, with "+ranks" under a process `mesh` of more than one batch
    shard (each rank's frontend on its rows; `device` is the rank's).
    Raises ValueError on CUDA for a config the route's kernel cannot take,
    RuntimeError without CUDA."""
    del batch_size  # every batch takes the kernel: no tile constraint
    device = resolve_device(device)
    n_data = mesh.n_batch if mesh is not None else 1
    fe = MfccFrontend(p, feature_type, device)
    kind = fe.path + ("+ranks" if n_data > 1 else "")

    def frontend(audio: torch.Tensor, gain=None) -> torch.Tensor:
        with torch.no_grad():
            return fe(audio, gain)

    if verbose:
        where = ("the plain chain on the CPU" if device.type == "cpu" else
                 f"MfccFrontend route {fe.route}"
                 + (f", body {fe.body}" if fe.body else ""))
        if n_data > 1:
            where += f" over {n_data}-device data mesh"
        print(f"frontend: {kind} ({where})")
    return frontend, kind
