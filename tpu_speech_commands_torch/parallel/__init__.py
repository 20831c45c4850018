"""Meshes, process meshes and tensor parallelism (counterpart of
`tpu_speech_commands/parallel/`)."""
from .mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    REPLICA_AXIS,
    Mesh,
    ProcessMesh,
    all_reduce_,
    batch_axes,
    batch_shards,
    init_process_mesh,
    make_hybrid_mesh,
    make_mesh,
    param_spec,
    shard_spec,
)

__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "REPLICA_AXIS",
    "Mesh",
    "ProcessMesh",
    "all_reduce_",
    "batch_axes",
    "batch_shards",
    "init_process_mesh",
    "make_hybrid_mesh",
    "make_mesh",
    "param_spec",
    "shard_spec",
]
