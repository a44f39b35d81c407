"""Helpers shared by the `train`, `train_i3d`, `test`, `serve` and
`evaluate_video_i3d` commands: the class count of a dataset, the torch
device of `--device` / `--gpus`, the refusal of flags whose slice is not
ported yet, the placement of a model across processes, and the reference
score dump."""

import dataclasses

import numpy as np
import torch

from dmcnet_tpu_torch import resolve_device


def num_classes_for(data_name):
    table = {"ucf101": 101, "hmdb51": 51, "kinetics400": 400}
    if data_name not in table:
        raise ValueError("Unknown dataset " + str(data_name))
    return table[data_name]


def device_for(args):
    """`--device`, with `--gpus N` selecting cuda:N; a CUDA device raises
    when CUDA is unavailable."""
    if args.device.startswith("cuda"):
        resolve_device()
        if getattr(args, "gpus", None):
            return torch.device(f"cuda:{args.gpus[0]}")
    return torch.device(args.device)


def refuse_unported(refusals):
    """SystemExit for the first (condition, flag, ROADMAP item) whose
    condition holds: a flag of a slice not ported yet is never ignored."""
    for bad, flag, item in refusals:
        if bad:
            raise SystemExit(f"{flag} is not ported yet (ROADMAP {item})")


def save_scores_npz(path, outputs, labels, name_list):
    """Bit-compatible with reference test.py:183-198: reorder everything by
    sorted(video name) and savez object arrays."""
    order_dict = {e: i for i, e in enumerate(sorted(name_list))}
    n = len(outputs)
    reorder_output = [None] * n
    reorder_label = [None] * n
    reorder_name = [None] * n
    for i in range(n):
        idx = order_dict[name_list[i]]
        reorder_output[idx] = outputs[i]
        reorder_label[idx] = labels[i]
        reorder_name[idx] = name_list[i]
    scores = np.empty(n, dtype=object)
    scores[:] = reorder_output
    np.savez(path, scores=scores, labels=reorder_label, names=reorder_name)


@dataclasses.dataclass
class Placement:
    """How a training run's model lies across the processes: `parallel`
    (more than one rank), the tensor-parallel degree `tp` with its 2-D
    `mesh` (None without), `fsdp`, and the groups its gradients average
    over (`parallel.mesh.sync_gradients`)."""
    parallel: bool = False
    tp: int = 1
    fsdp: bool = False
    mesh: object = None
    sharded_group: object = None

    def prepare(self, optimizers):
        """Hook `optimizers` (a sequence or a dict, built after `place`, or
        fresh ones at a stage swap) to average their gradients before each
        step; returns them."""
        if self.parallel:
            from dmcnet_tpu_torch.parallel.fsdp import loop_optimizers
            from dmcnet_tpu_torch.parallel.mesh import sync_gradients

            opts = list(optimizers.values() if isinstance(optimizers, dict)
                        else optimizers)
            if self.fsdp or self.tp > 1:
                loop_optimizers(opts)
            sync_gradients(opts, self.sharded_group)
        return optimizers

    def average_carry(self, model):
        """Average every carried `.grad` of `model` over the ranks in
        place, so that a checkpoint (which keeps one rank's copy) holds
        the carry of the global batch; by linearity the next step is the
        same."""
        if self.parallel:
            from dmcnet_tpu_torch.parallel.mesh import average_gradients

            average_gradients(model.parameters(), self.sharded_group)


def place(model, *, fsdp=False, tp=1):
    """Across processes: global-batch BN swapped into `model` (over the
    `data` group under tensor parallelism), the layers of
    `parallel.tensor.tp_plan` sharded over `model` with `tp` > 1, FSDP2
    with `fsdp` (over `data` under tensor parallelism).  Build the
    optimizers after this call and pass them to `Placement.prepare`."""
    from dmcnet_tpu_torch.parallel.multihost import world

    size = world()[1]
    tp = max(tp or 1, 1)
    out = Placement(parallel=size > 1, tp=tp, fsdp=bool(fsdp) and size > 1)
    if not out.parallel:
        return out
    from dmcnet_tpu_torch.parallel.mesh import use_global_batchnorm

    data_group = None
    if tp > 1:
        from dmcnet_tpu_torch.parallel.tensor import (
            make_mesh_2d,
            shard_model_tp,
        )

        out.mesh = make_mesh_2d(size // tp, tp,
                                next(model.parameters()).device.type)
        data_group = out.mesh["data"].get_group()
        shard_model_tp(model, out.mesh)
        if not out.fsdp:   # FSDP2 averages what it shards
            out.sharded_group = data_group
    use_global_batchnorm(model, data_group)
    if out.fsdp:
        from dmcnet_tpu_torch.parallel.fsdp import shard_model

        shard_model(model, out.mesh["data"] if tp > 1 else None)
    return out


def check_parallel_flags(n_proc, batch_size, tp, fsdp, directory):
    """The JAX commands' divisibility and checkpoint rules for `n_proc`
    processes: SystemExit when they do not hold."""
    tp = max(tp or 1, 1)
    if tp > 1 and n_proc % tp:
        raise SystemExit(f"--tp {tp} must divide the number of processes "
                         f"({n_proc}): each rank holds 1/{tp} of the "
                         "sharded layers")
    if batch_size % (n_proc // tp):
        raise SystemExit(
            f"--batch-size {batch_size} must be divisible by the data axis "
            f"({n_proc // tp} = {n_proc} processes / tp {tp})")
    if n_proc > 1 and (fsdp or tp > 1) and not directory:
        raise SystemExit(
            f"{'--fsdp' if fsdp else '--tp'} across processes requires "
            "--ckpt-backend orbax (a torch file holds the full state, which "
            "no process holds)")
