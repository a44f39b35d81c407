"""Data parallelism over the process group (counterpart of
`dmcnet_tpu/parallel/mesh.py`, whose jitted step sees the global batch
with replicated state and lets XLA emit the collectives).

Each rank keeps a replica of the state and steps on its rows of the global
batch.  Three pieces make its step the single-process step on the global
batch:

  * `use_global_batchnorm` swaps `GlobalBatchNorm` into a model's BN
    modules: in train mode its forward all-reduces each channel's count
    and sum, then the centred sum of squares, so the statistics (and the
    running statistics) are the global batch's; its backward all-reduces
    the two gradient sums.  `torch.nn.SyncBatchNorm` does this on CUDA
    only; this one runs on gloo and NCCL alike.  Eval mode reads the
    running statistics, with no collective.  A remat recompute
    all-reduces again (as JAX's remat re-runs its `psum`) and leaves the
    running statistics alone.
  * `sync_gradients` registers a pre-step hook on each optimizer that
    averages the `.grad` of its replicated parameters over the ranks, in
    one flat all-reduce per dtype, just before that optimizer steps.  So
    only the optimizers that step reduce, and parameters that take a
    gradient no optimizer uses in that step (the generator in the GAN's D
    step, the discriminator in its G step) cost nothing; FSDP2's sharded
    parameters (`parallel/fsdp.py`) are left to its reduce-scatter.  This
    is the explicit all-reduce in place of DDP, whose hooks would reduce
    every parameter with a gradient and need `find_unused_parameters`.
  * `all_reduce_mean` / `all_reduce_sum` for the metrics: the train
    meters and the eval sums, so that Prec@1 is the global one.

Each rank's losses are means over its rows and the ranks' rows are equally
many, so the mean of the ranks' gradients is the gradient of the global
batch's loss.  A collective that fails raises: nothing drops the global BN
or the all-reduce to carry on.

Everything reduces over every rank, with two exceptions for tensor
parallelism (`parallel/tensor.py`), where the ranks of one `model` row hold
the same rows: `use_global_batchnorm` takes the `data` group for the BN
statistics (the unbiased running variance counts each row once), and the
gradient averaging takes it as `sharded_group` for the channel-sharded
parameters (averaging them over every rank would mix different shards).
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from dmcnet_tpu_torch.models.layers import recomputing
from dmcnet_tpu_torch.parallel.multihost import all_reduce


class _GlobalBNFunction(torch.autograd.Function):
    """Batch normalization over every rank's batch of one channel layout
    (N, C, *): the forward all-reduces [count, sum] and then the centred
    sum of squares (two passes, as exact as a local BN's variance); the
    backward all-reduces [sum(dy), sum(dy * xhat)].  The weight and bias
    gradients stay each rank's own sums: `sync_gradients` averages them
    with every other gradient."""

    @staticmethod
    def forward(ctx, x, weight, bias, running_mean, running_var, momentum,
                eps, group):
        ctx.in_dtype = x.dtype
        x = x.to(torch.promote_types(x.dtype, weight.dtype))
        c = x.shape[1]
        dims = [0] + list(range(2, x.dim()))
        count = torch.full((1,), x.numel() // c, dtype=x.dtype,
                           device=x.device)
        packed = torch.cat([count, x.sum(dims)])
        all_reduce(packed, group)
        n, mean = packed[0], packed[1:] / packed[0]
        shape = [1, c] + [1] * (x.dim() - 2)
        xc = x - mean.view(shape)
        sq = (xc * xc).sum(dims)
        all_reduce(sq, group)
        var = sq / n
        invstd = torch.rsqrt(var + eps)
        xhat = xc * invstd.view(shape)
        if running_mean is not None:
            with torch.no_grad():
                unbiased = sq / (n - 1).clamp(min=1)
                running_mean.mul_(1 - momentum).add_(
                    mean.to(running_mean.dtype), alpha=momentum)
                running_var.mul_(1 - momentum).add_(
                    unbiased.to(running_var.dtype), alpha=momentum)
        ctx.save_for_backward(xhat, invstd, weight)
        ctx.n, ctx.group = n, group
        return xhat * weight.view(shape) + bias.view(shape)

    @staticmethod
    def backward(ctx, dy):
        xhat, invstd, weight = ctx.saved_tensors
        c = xhat.shape[1]
        dims = [0] + list(range(2, xhat.dim()))
        shape = [1, c] + [1] * (xhat.dim() - 2)
        dy = dy.to(xhat.dtype)
        sum_dy = dy.sum(dims)
        sum_dy_xhat = (dy * xhat).sum(dims)
        packed = torch.cat([sum_dy, sum_dy_xhat])
        all_reduce(packed, ctx.group)
        mean_dy = (packed[:c] / ctx.n).view(shape)
        mean_dy_xhat = (packed[c:] / ctx.n).view(shape)
        dx = (weight * invstd).view(shape) * (dy - mean_dy
                                              - xhat * mean_dy_xhat)
        return (dx.to(ctx.in_dtype), sum_dy_xhat.to(weight.dtype),
                sum_dy.to(weight.dtype), None, None, None, None, None)


class GlobalBatchNorm(nn.modules.batchnorm._BatchNorm):
    """A BatchNorm1d/2d/3d whose train-mode statistics are those of the
    batch over the ranks of `self.group` (None: every rank)."""

    group = None

    def forward(self, x):
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0,
                                self.eps)
        if not (self.affine and self.track_running_stats):
            raise ValueError("GlobalBatchNorm needs affine BN modules that "
                             "track running statistics")
        if recomputing():
            # a remat recompute (`models.layers.remat_call`): the same
            # collectives, and the running statistics left as they are
            momentum = 0.0
        else:
            self.num_batches_tracked.add_(1)
            momentum = (1.0 / float(self.num_batches_tracked)
                        if self.momentum is None else self.momentum)
        return _GlobalBNFunction.apply(
            x, self.weight, self.bias, self.running_mean, self.running_var,
            momentum, self.eps, self.group)


def use_global_batchnorm(model, group=None):
    """Swap `GlobalBatchNorm` over `group` into every BatchNorm module of
    `model` in place; parameters and buffers are the same objects, so
    optimizers built before or after the swap hold them.  Returns
    `model`."""
    for name, child in list(model.named_children()):
        if isinstance(child, nn.modules.batchnorm._BatchNorm) and \
                not isinstance(child, GlobalBatchNorm):
            bn = GlobalBatchNorm.__new__(GlobalBatchNorm)
            bn.__dict__.update(child.__dict__)
            bn.group = group
            setattr(model, name, bn)
        else:
            use_global_batchnorm(child, group)
    return model


def _is_dtensor(t):
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def _average(grads, group=None):
    """Average `grads` (plain tensors) in place over `group` (None: every
    rank): one flat all-reduce per dtype and device."""
    buckets = {}
    for g in grads:
        buckets.setdefault((g.dtype, g.device), []).append(g)
    size = dist.get_world_size(group)
    for gs in buckets.values():
        flat = torch.cat([g.reshape(-1) for g in gs])
        all_reduce(flat, group)
        flat.div_(size)
        offset = 0
        for g in gs:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()


def average_gradients(params, sharded_group=None):
    """Average the `.grad` of `params` over every rank.  A
    DTensor parameter is FSDP2's, whose reduce-scatter averages it, unless
    `sharded_group` is given: then its local shard of `.grad` averages
    over that group (tensor parallelism's `data` group)."""
    plain, sharded = [], []
    for p in params:
        if p.grad is None:
            continue
        if not _is_dtensor(p):
            plain.append(p.grad)
        elif sharded_group is not None:
            sharded.append(p.grad.to_local())
    _average(plain)
    if sharded:
        _average(sharded, sharded_group)


def sync_gradients(optimizers, sharded_group=None):
    """Average each optimizer's gradients (`average_gradients`, DTensors
    over `sharded_group`) just before it steps (a step pre-hook).  Returns
    the hooks' handles."""
    def hook(opt, args, kwargs):
        average_gradients([p for g in opt.param_groups for p in g["params"]],
                          sharded_group)

    return [opt.register_step_pre_hook(hook) for opt in optimizers]


def all_reduce_sum(values):
    """Sums over every rank of a list of 0-d tensors or floats
    (one all-reduce, float64 on the tensors' device); returns floats, the
    values themselves when there is no process group."""
    if not (values and dist.is_available() and dist.is_initialized()):
        return [float(v) for v in values]
    device = next((v.device for v in values if isinstance(v, torch.Tensor)),
                  torch.device("cpu"))
    flat = torch.stack([torch.as_tensor(v, dtype=torch.float64)
                        .to(device).reshape(()) for v in values])
    all_reduce(flat)
    return flat.tolist()


def all_reduce_mean(values):
    """Means over every rank of a list of 0-d tensors or floats."""
    size = dist.get_world_size() if dist.is_initialized() else 1
    return [v / size for v in all_reduce_sum(values)]
