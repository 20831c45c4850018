"""The device an entry point of the port runs on."""
from __future__ import annotations

import torch

# Entry points run on the card unless the caller asks for the CPU.
DEFAULT_DEVICE = "cuda"


def resolve_device(device) -> torch.device:
    """`torch.device(device)`; raises RuntimeError for a CUDA device when CUDA
    is not available.  Nothing falls back to the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not available")
    return device
