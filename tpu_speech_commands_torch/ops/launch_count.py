"""Launch counts of the frontend and classifier kernels: each wrapper adds
one to its count where it launches its kernel, and nowhere else."""
from __future__ import annotations


class LaunchCount:
    """The launch count of one instantiation."""

    def __init__(self):
        self.launches = 0


# launches of a register or wide body of either route (csrc/
# register_fft.cuh) in log-mel mode: its tail, and its first tail
# (`_partial_sums=True`, the A/B)
LOGMEL = LaunchCount()
PARTIAL_SUMS = LaunchCount()
