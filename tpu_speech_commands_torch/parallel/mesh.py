"""Device meshes and process meshes (counterpart of
`tpu_speech_commands/parallel/mesh.py`).

JAX drives every device of a mesh from one process, and XLA inserts the
collectives that the declared shardings imply.  The port splits this the
way PyTorch users do:

- one process over local devices, for serving and standalone evaluation:
  a `Mesh` is an array of `torch.device` shaped over the axis names.  The
  batch splits over its batch axes and each shard runs on its device with
  no collective, as the JAX scorer's `shard_map` is collective-free;
- one process per device, for training: a `ProcessMesh` is this rank's
  place in the same axes under `torch.distributed`, with the process groups
  the train step reduces over (`tensor_parallel.py`, `training/trainer.py`).

Axes:
- 'replica': slice-parallel data parallelism (only on hybrid meshes from
  `make_hybrid_mesh`); it carries only the once-per-step gradient and
  metric reduction;
- 'data': batch-parallel (gradients summed over the batch group);
- 'model': tensor-parallel for the dense pair (`param_spec`).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

REPLICA_AXIS = "replica"
DATA_AXIS = "data"
MODEL_AXIS = "model"
PROCESS_AXES = (REPLICA_AXIS, DATA_AXIS, MODEL_AXIS)


class Mesh:
    """Devices over named axes.  `devices` is a numpy object array of
    `torch.device` (or, for `make_hybrid_mesh`'s slice rule, of objects with
    a `slice_index`) whose shape is the axes' sizes; `shape` maps each axis
    name to its size, in order, as `jax.sharding.Mesh.shape` does."""

    def __init__(self, devices: np.ndarray, axis_names: tuple[str, ...]):
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, devices.shape))

    def batch_devices(self) -> list:
        """The device of each batch shard, outermost batch axis first: every
        (replica, data) coordinate at model index 0."""
        devs = self.devices
        if MODEL_AXIS in self.axis_names:
            devs = np.take(devs, 0, axis=self.axis_names.index(MODEL_AXIS))
        return list(devs.reshape(-1))

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={list(self.devices.reshape(-1))})"


def _device_list(devices) -> list:
    """The devices a mesh may take: every visible card by default (none
    without CUDA), else the given list, strings made `torch.device`; a
    device may appear more than once (several shards on one device)."""
    if devices is None:
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device(d) if isinstance(d, str) else d for d in devices]


def _object_array(items: list, shape: tuple[int, ...]) -> np.ndarray:
    arr = np.empty(len(items), dtype=object)
    for i, item in enumerate(items):
        arr[i] = item
    return arr.reshape(shape)


def make_mesh(n_data: int | None = None, n_model: int = 1,
              devices=None) -> Mesh:
    """Build a ('data', 'model') mesh over the devices.

    Default: every visible card on the data axis.  Devices are taken in
    order and reshaped row-major, so the 'model' axis is the fast one."""
    devices = _device_list(devices)
    if n_data is None:
        n_data = len(devices) // n_model
    if n_data < 1 or n_model < 1 or n_data * n_model > len(devices):
        # n_data floors to 0 when n_model > device count — a zero-device
        # mesh fails confusingly far downstream, so reject it here
        raise ValueError(
            f"mesh {n_data}x{n_model} does not fit {len(devices)} devices"
        )
    dev_array = _object_array(devices[: n_data * n_model], (n_data, n_model))
    return Mesh(dev_array, (DATA_AXIS, MODEL_AXIS))


def make_hybrid_mesh(n_replica: int, n_data: int | None = None,
                     n_model: int = 1, devices=None) -> Mesh:
    """Build a ('replica', 'data', 'model') mesh.

    'replica' is the cross-slice axis; 'data' and 'model' stay inside a
    slice, so the tensor-parallel reduction never crosses it.  Devices that
    carry a `slice_index` from more than one slice are grouped by slice,
    one slice a replica row; any other device list is reshaped row-major
    (the axis semantics are the same, only the slice boundary is not
    physical)."""
    devices = _device_list(devices)
    if n_data is None:
        n_data = len(devices) // (n_replica * n_model)
    if min(n_replica, n_data, n_model) < 1 or \
            n_replica * n_data * n_model > len(devices):
        raise ValueError(
            f"hybrid mesh {n_replica}x{n_data}x{n_model} does not fit "
            f"{len(devices)} devices"
        )
    slice_ids = {getattr(d, "slice_index", None) for d in devices}
    if len(slice_ids) > 1 and None not in slice_ids:
        if n_replica * n_data * n_model != len(devices):
            # a slice-aware assignment must cover the device list exactly:
            # a prefix would break the slice boundaries
            raise ValueError(
                f"hybrid mesh {n_replica}x{n_data}x{n_model} uses "
                f"{n_replica * n_data * n_model} of {len(devices)} "
                "multi-slice devices; pass devices= with exactly the "
                "devices to use (slice-aware assignment cannot pick a "
                "prefix)"
            )
        if len(slice_ids) != n_replica:
            raise ValueError(f"hybrid mesh {n_replica}x{n_data}x{n_model}: "
                             f"{len(slice_ids)} slices, one a replica needed")
        devices = sorted(devices, key=lambda d: d.slice_index)
    dev_array = _object_array(devices[: n_replica * n_data * n_model],
                              (n_replica, n_data, n_model))
    return Mesh(dev_array, (REPLICA_AXIS, DATA_AXIS, MODEL_AXIS))


def batch_axes(mesh) -> tuple[str, ...]:
    """Mesh axes the batch dimension shards over, outermost first."""
    return tuple(a for a in (REPLICA_AXIS, DATA_AXIS) if a in mesh.axis_names)


def batch_shards(mesh) -> int:
    """Total way-count of the batch split (replica x data)."""
    if mesh is None:
        return 1
    return math.prod(mesh.shape[a] for a in batch_axes(mesh))


def param_spec(path, leaf=None) -> tuple:
    """Tensor-parallel partition rule for a parameter, by its path (a tuple
    of names or a dotted state-dict key): one entry a dimension, the axis it
    splits over or None, () for replicated.

    The hidden 'feature_dense' projection splits by column and the
    'score_predict' head by row over 'model' (a megatron pair: the
    activation stays split between them and one reduction follows the
    head).  Everything else (convs, BatchNorm, RNN cells, the head's bias)
    is replicated."""
    del leaf  # the JAX rule's signature; the rule reads the path only
    names = tuple(path.split(".")) if isinstance(path, str) else tuple(path)
    if "feature_dense" in names and names[-1] == "kernel":
        return (None, MODEL_AXIS)
    if "feature_dense" in names and names[-1] == "bias":
        return (MODEL_AXIS,)
    if "score_predict" in names and names[-1] == "kernel":
        return (MODEL_AXIS, None)
    return ()


def shard_spec(path, shape: tuple[int, ...], mesh) -> tuple:
    """`param_spec` where the mesh has a model axis of more than one device
    and every split dimension divides by it, else () (replicated): the
    per-parameter rule of the JAX `state_sharding`."""
    n_model = mesh.shape.get(MODEL_AXIS, 1)
    if n_model > 1:
        spec = param_spec(path)
        if len(spec) <= len(shape) and all(
                axis is None or dim % mesh.shape[axis] == 0
                for dim, axis in zip(shape, spec)):
            return spec
    return ()


def all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    """Sum `t` in place over `group`.  gloo on a CUDA tensor goes through
    the host: gloo documents only broadcast and all_reduce for CUDA
    tensors, and several gloo ranks may share one card."""
    if group is None:
        return t
    if t.is_cuda and dist.get_backend(group) == "gloo":
        host = t.cpu()
        dist.all_reduce(host, group=group)
        t.copy_(host)
    else:
        dist.all_reduce(t, group=group)
    return t


@dataclass(eq=False)
class ProcessMesh:
    """This rank's place in a ('replica', 'data', 'model') mesh of ranks,
    one rank a device: its device, the `DeviceMesh`, the batch group (the
    ranks of its model index over replica x data, flattened, outermost
    first) and the model group (the ranks that share its batch rows).
    Ranks are laid out row-major over the axes."""

    shape: dict
    rank: int
    device: torch.device
    device_mesh: object
    batch_group: object
    model_group: object

    @property
    def n_batch(self) -> int:
        return self.shape[REPLICA_AXIS] * self.shape[DATA_AXIS]

    @property
    def n_model(self) -> int:
        return self.shape[MODEL_AXIS]

    @property
    def batch_rank(self) -> int:
        return self.rank // self.n_model

    @property
    def model_rank(self) -> int:
        return self.rank % self.n_model

    def batch_rows(self, global_batch: int) -> slice:
        """This rank's rows of a global batch; ValueError unless the batch
        divides by the batch shards."""
        if global_batch % self.n_batch:
            raise ValueError(f"batch {global_batch} not divisible by the "
                             f"{self.n_batch}-device data axis")
        local = global_batch // self.n_batch
        return slice(self.batch_rank * local, (self.batch_rank + 1) * local)

    def __deepcopy__(self, memo):
        # a model copied for evaluation or averaging shares its mesh
        return self


def init_process_mesh(n_replica: int, n_data: int, n_model: int,
                      device) -> ProcessMesh:
    """Build this rank's `ProcessMesh` in an initialised default process
    group of n_replica x n_data x n_model ranks.  Every rank calls it, in
    the same order, for every mesh it builds."""
    world, rank = dist.get_world_size(), dist.get_rank()
    if n_replica * n_data * n_model != world:
        raise ValueError(f"process mesh {n_replica}x{n_data}x{n_model} "
                         f"needs {n_replica * n_data * n_model} ranks, the "
                         f"process group has {world}")
    from torch.distributed.device_mesh import init_device_mesh

    # the DeviceMesh only holds the groups here: its device type follows
    # the backend (gloo is the CPU's, even for ranks that share a card)
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    device_mesh = init_device_mesh(device_type, (n_replica, n_data, n_model),
                                   mesh_dim_names=PROCESS_AXES)
    batch_group = None
    for m in range(n_model):  # every rank creates every group, in order
        group = dist.new_group(list(range(m, world, n_model)))
        if rank % n_model == m:
            batch_group = group
    return ProcessMesh({REPLICA_AXIS: n_replica, DATA_AXIS: n_data,
                        MODEL_AXIS: n_model}, rank, torch.device(device),
                       device_mesh, batch_group,
                       device_mesh.get_group(MODEL_AXIS))

