"""Sharded parameters and optimizer states, FSDP2 (`fully_shard`) over the
ranks (counterpart of `dmcnet_tpu/parallel/fsdp.py`, ZeRO-3 by GSPMD
sharding constraints).

`shard_model` applies `fully_shard` module by module: a module is sharded
when one of its own parameters holds at least `DEFAULT_MIN_SIZE` elements
(the JAX package's `DEFAULT_MIN_SIZE = 2**14`, `fsdp.py:26-64`: gathering a
small BN bias costs more in collective latency than its copy costs in
memory); every other module stays replicated, its gradients averaged by
`parallel.mesh.sync_gradients`.  FSDP2 shards dim 0 of each parameter
(the JAX package picks the largest divisible one) and turns it into a
DTensor; optimizers built afterwards keep their moments sharded the same
way, and each rank writes its shards to a directory checkpoint
(`train.checkpoints.save_checkpoint_dcp`).  As in the JAX package, a
multi-process `--fsdp` run needs that directory backend: a torch file
holds the full state.  `gather_state` assembles that full state (every
rank takes part) for the rank-0 files that are still written, such as
`--save-reference-ckpt`.
"""

from __future__ import annotations

DEFAULT_MIN_SIZE = 2 ** 14


def shard_model(model):
    """`fully_shard` every module of `model` that owns a parameter of at
    least `DEFAULT_MIN_SIZE` elements, over a 1-D DeviceMesh of every rank
    on the parameters' device type.  Build the optimizers after this call:
    it replaces the parameters.  Returns the sharded modules' names."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.fsdp import fully_shard

    device = next(model.parameters()).device
    mesh = init_device_mesh(device.type, (dist.get_world_size(),))
    names = [name for name, module in model.named_modules()
             if any(p.numel() >= DEFAULT_MIN_SIZE
                    for p in module.parameters(recurse=False))]
    modules = dict(model.named_modules())
    for name in names:
        fully_shard(modules[name], mesh=mesh, reshard_after_forward=True)
    return names


def loop_optimizers(optimizers):
    """Step `optimizers` one parameter at a time (torch's single-tensor
    implementation, `foreach=False`): the foreach kernels take no list
    that mixes sharded DTensors with replicated plain tensors."""
    for opt in optimizers:
        for group in opt.param_groups:
            group["foreach"] = False


def gather_state(model):
    """A copy of the model's state dict on the CPU, every sharded tensor
    gathered whole; every rank must call it (the gathers are
    collectives)."""
    from torch.distributed.tensor import DTensor

    return {k: (v.full_tensor() if isinstance(v, DTensor) else v)
            .detach().to("cpu", copy=True)
            for k, v in model.state_dict().items()}
