"""One process a device: start the ranks, rendezvous, and run a function in
each (the port's counterpart of JAX's single controller for training).

`launch(fn, devices, ...)` spawns one process per entry of `devices` with
`torch.multiprocessing` (start method `spawn`: a child starts from a fresh
import, so it inherits no JAX state and no CUDA context), initialises the
default process group through a `file://` store in a new temporary
directory, with a timeout, and calls `fn(rank, device, *args)` in each; `fn`
is pickled by its import path, so it lives in a module of this package.
When any rank fails, `torch.multiprocessing` stops the others and the
parent raises.  Under `torchrun` (`WORLD_SIZE` set) `init_from_env` joins
the group it describes instead.

NCCL serves distinct cards; gloo serves the CPU and ranks that share a card
(NCCL refuses two ranks on one card).  CPU ranks run one thread each.
"""
from __future__ import annotations

import datetime
import os
import tempfile

import torch
import torch.distributed as dist

RENDEZVOUS_TIMEOUT = datetime.timedelta(seconds=300)


def default_backend(devices) -> str:
    """nccl for distinct cards, gloo otherwise."""
    devices = [torch.device(d) for d in devices]
    if all(d.type == "cuda" for d in devices) and \
            len(set(devices)) == len(devices):
        return "nccl"
    return "gloo"


def _check_backend(backend: str, devices) -> None:
    devices = [torch.device(d) for d in devices]
    if backend == "nccl" and (any(d.type != "cuda" for d in devices)
                              or len(set(devices)) != len(devices)):
        raise ValueError(f"nccl needs one distinct card a rank, got {devices}")


def _enter_device(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.set_device(device)
    else:
        torch.set_num_threads(1)


def _rank_main(rank, fn, devices, backend, init_method, args):
    device = torch.device(devices[rank])
    _enter_device(device)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=len(devices),
                            timeout=RENDEZVOUS_TIMEOUT)
    try:
        fn(rank, device, *args)
    finally:
        dist.destroy_process_group()


def launch(fn, devices, backend: str | None = None, args: tuple = ()) -> None:
    """Run fn(rank, device, *args) in one spawned process a device (rank r on
    devices[r]) and wait for all; raises when any rank fails."""
    import torch.multiprocessing as mp

    devices = [str(torch.device(d)) for d in devices]
    backend = backend or default_backend(devices)
    _check_backend(backend, devices)
    with tempfile.TemporaryDirectory(prefix="tsc_rendezvous_") as tmp:
        init_method = "file://" + os.path.join(tmp, "store")
        mp.start_processes(_rank_main, nprocs=len(devices), join=True,
                           start_method="spawn",
                           args=(fn, devices, backend, init_method, args))


def init_from_env(devices) -> tuple[int, torch.device]:
    """Join the process group `torchrun` describes (RANK, WORLD_SIZE,
    MASTER_ADDR, MASTER_PORT), rank r on devices[r]; returns (rank, device)."""
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    if world != len(devices):
        raise ValueError(f"WORLD_SIZE {world} != {len(devices)} mesh devices")
    device = torch.device(devices[rank])
    _enter_device(device)
    backend = default_backend(devices)
    dist.init_process_group(backend, init_method="env://", rank=rank,
                            world_size=world, timeout=RENDEZVOUS_TIMEOUT)
    return rank, device
