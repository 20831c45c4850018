"""The megatron pair and the batch reductions of the sharded train step, as
explicit autograd functions over a `ProcessMesh`'s groups (what XLA inserts
from the JAX package's shardings).

- `copy_to_model`: identity forward, gradient summed over 'model' backward;
  it stands before the column-split `feature_dense` (and before the row
  slice a replicated input takes into a row-split head), where every model
  rank's columns contribute to the input's gradient;
- `reduce_from_model`: sum over 'model' forward, identity backward; it
  follows the row-split `score_predict`, whose partial products add up to
  the logits.  The head's bias is replicated and added once, after it.
  (`torch.distributed.nn.functional.all_reduce` would sum the gradient
  again in its backward and multiply it by the model ranks.)
- `sum_over_batch`: sum over the batch group both ways, for BatchNorm's
  per-channel sums: every rank's rows feed every rank's statistics.

`shard_model` cuts a model's dense pair into this rank's shards by
`mesh.shard_spec` and hands each module that reads it the mesh;
`gather_model` puts the shards back together into an unsharded copy, for
validation and checkpoints.
"""
from __future__ import annotations

import copy

import torch
from torch import nn

from .mesh import MODEL_AXIS, all_reduce_, shard_spec


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_(grad.clone(), ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _SumOverGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_(grad.clone(), ctx.group), None


def copy_to_model(x: torch.Tensor, mesh) -> torch.Tensor:
    return _CopyToModel.apply(x, mesh.model_group)


def reduce_from_model(x: torch.Tensor, mesh) -> torch.Tensor:
    return _ReduceFromModel.apply(x, mesh.model_group)


def sum_over_batch(x: torch.Tensor, mesh) -> torch.Tensor:
    return _SumOverGroup.apply(x, mesh.batch_group)


def shard_tensor(full: torch.Tensor, dim: int, mesh) -> torch.Tensor:
    """This rank's block of `full` along `dim`, split over 'model'."""
    size = full.shape[dim] // mesh.n_model
    return full.narrow(dim, mesh.model_rank * size, size).contiguous()


def gather_tensor(shard: torch.Tensor, dim: int, mesh) -> torch.Tensor:
    """The full tensor from every model rank's block along `dim` (a
    collective over 'model'): each rank writes its block into zeros and
    the blocks are summed, which gloo can do on a shared card."""
    shape = list(shard.shape)
    shape[dim] *= mesh.n_model
    full = shard.new_zeros(shape)
    full.narrow(dim, mesh.model_rank * shard.shape[dim],
                shard.shape[dim]).copy_(shard)
    return all_reduce_(full, mesh.model_group)


def parallel_dense(dense, x: torch.Tensor, mm, compute_dtype) -> torch.Tensor:
    """A split `Dense` (`dense.parallel` "column" or "row") on this rank's
    shard of its weights; `mm(x, w, compute_dtype)` is the model's matmul."""
    mesh = dense.mesh
    if dense.parallel == "column":
        return mm(copy_to_model(x, mesh), dense.kernel, compute_dtype) + \
            dense.bias
    rows = dense.kernel.shape[0]
    if x.shape[-1] != rows:  # a replicated input: take this rank's columns
        x = copy_to_model(x, mesh).narrow(-1, mesh.model_rank * rows, rows)
    return reduce_from_model(mm(x, dense.kernel, compute_dtype), mesh) + \
        dense.bias


def _split_dims(dense) -> dict[str, int]:
    """The dimension each of a split Dense's parameters is split along."""
    if dense.parallel == "column":
        return {"kernel": 1, "bias": 0}
    return {"kernel": 0}


def shard_model(model: nn.Module, mesh) -> nn.Module:
    """Split `model`'s dense pair over the mesh's model axis in place, by
    `shard_spec` (kernel column-split and its bias for `feature_dense`, the
    kernel row-split for `score_predict`; replicated where a dimension does
    not divide), and give every module that reads a mesh (BatchNorm's
    global statistics, dropout's global mask, a split Dense) this one."""
    for module in model.modules():
        if hasattr(module, "mesh"):
            module.mesh = mesh
    for name, module in model.named_modules():
        if not hasattr(module, "parallel"):
            continue
        spec = shard_spec(f"{name}.kernel", tuple(module.kernel.shape), mesh)
        if not spec:
            continue
        module.parallel = "column" if spec[1] == MODEL_AXIS else "row"
        for leaf, dim in _split_dims(module).items():
            setattr(module, leaf, nn.Parameter(
                shard_tensor(getattr(module, leaf).detach(), dim, mesh)))
    return model


def gather_model(model: nn.Module, mesh) -> nn.Module:
    """An unsharded copy of a `shard_model` model, with no mesh: the split
    parameters gathered over 'model' (every model rank calls it)."""
    full = copy.deepcopy(model)
    for module in full.modules():
        if getattr(module, "parallel", None):
            for leaf, dim in _split_dims(module).items():
                setattr(module, leaf, nn.Parameter(
                    gather_tensor(getattr(module, leaf).detach(), dim, mesh)))
            module.parallel = None
        if hasattr(module, "mesh"):
            module.mesh = None
    return full
