"""Tensor (model) parallelism over a 2-D (data, model) mesh (counterpart of
`dmcnet_tpu/parallel/tensor.py`, where GSPMD derives the collectives from
the kernels' placement).

`make_mesh_2d(data, model)` is a DeviceMesh with named dims (data, model)
over every rank, adjacent ranks on `model` (rank r at (r // model,
r % model)), as the JAX package's mesh.  `shard_model_tp` shards, by the
JAX package's rule (`tp_spec`), every convolution and linear layer whose
weight holds at least `DEFAULT_MIN_SIZE` elements and whose output
channels divide `model`: each rank of a model row keeps its slice of the
output channels (dim 0 of torch's (O, I, ...) weight) as a DTensor,
`Shard(0)` over the `model` dim, so that checkpoints see the shards and
FSDP2 can shard them again over `data`.  Biases, BN and small layers stay
replicated.

A sharded layer runs Megatron's f/g pair by hand:

  * f: identity forward; backward all-reduces the input gradient over
    `model` (each rank's gradient is the part through its channels);
  * the layer on its output channels;
  * g: forward all-gathers the channels over `model`; backward takes this
    rank's slice of the output gradient.  That gradient is the same on
    every rank of the row (everything after g is replicated), so slicing
    is exact; `torch.distributed.nn.functional.all_gather` sums it over
    the ranks instead, which makes every sharded weight's gradient `model`
    times too large.

The batch splits over `data` (`multihost.local_shard_indices(n, tp)`): the
ranks of one model row step on the same rows.  So the BN statistics reduce over the data group
(`parallel.mesh.use_global_batchnorm(model, data_group)`), the sharded
gradients average over it (`sync_gradients(..., sharded_group=data)`:
averaging over every rank would mix different shards), and the replicated
gradients average over every rank, which keeps the replicas identical.
"""

from __future__ import annotations

import types

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from dmcnet_tpu_torch.parallel.multihost import all_gather, all_reduce

DEFAULT_MIN_SIZE = 2 ** 14


def make_mesh_2d(data, model, device_type):
    """(data, model) DeviceMesh over every rank of the process group."""
    from torch.distributed.device_mesh import init_device_mesh

    if data * model != dist.get_world_size():
        raise ValueError(f"{data}x{model} mesh over "
                         f"{dist.get_world_size()} ranks")
    return init_device_mesh(device_type, (data, model),
                            mesh_dim_names=("data", "model"))


def tp_plan(model, n_model):
    """Names of the convolutions and linear layers `shard_model_tp`
    shards: weight of `DEFAULT_MIN_SIZE` elements or more, output channels
    divisible by `n_model`."""
    return [name for name, m in model.named_modules()
            if isinstance(m, (nn.Conv2d, nn.Conv3d, nn.Linear))
            and m.weight.numel() >= DEFAULT_MIN_SIZE
            and m.weight.shape[0] % n_model == 0]


class _CopyToModel(torch.autograd.Function):
    """f: identity; the backward all-reduces over the model group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dx):
        return all_reduce(dx.contiguous(), ctx.group), None


class _GatherChannels(torch.autograd.Function):
    """g: all-gather of dim 1 over the model group; the backward takes this
    rank's slice of the (replicated) output gradient."""

    @staticmethod
    def forward(ctx, y, group):
        ctx.rank, ctx.width = dist.get_rank(group), y.shape[1]
        return torch.cat(all_gather(y, group), dim=1)

    @staticmethod
    def backward(ctx, dy):
        return dy.narrow(1, ctx.rank * ctx.width, ctx.width), None


def _tp_forward(group):
    def forward(self, x):
        w = self.weight.to_local()
        x = _CopyToModel.apply(x, group)
        if isinstance(self, nn.Linear):
            y = F.linear(x, w)
        else:
            y = self._conv_forward(x, w, None)
        y = _GatherChannels.apply(y, group)
        if self.bias is not None:
            y = y + self.bias.view([1, -1] + [1] * (y.dim() - 2))
        return y

    return forward


def shard_model_tp(model, mesh):
    """Shard the layers of `tp_plan` over `mesh`'s `model` dim in place,
    from the full weights every rank holds.  Build the optimizers after
    this call: it replaces the weights.  Returns the sharded layers'
    names."""
    from torch.distributed.tensor import DTensor, Shard

    sub = mesh["model"]
    n, r = sub.size(), sub.get_local_rank()
    group = sub.get_group()
    modules = dict(model.named_modules())
    names = tp_plan(model, n)
    for name in names:
        m = modules[name]
        local = m.weight.detach().chunk(n, dim=0)[r].clone()
        m.weight = nn.Parameter(DTensor.from_local(
            local, sub, [Shard(0)], run_check=False))
        m.forward = types.MethodType(_tp_forward(group), m)
    return names
