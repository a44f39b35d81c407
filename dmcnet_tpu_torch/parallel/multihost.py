"""Process-group start-up and per-rank data sharding (counterpart of
`dmcnet_tpu/parallel/multihost.py`).

The JAX package runs one program over every process's devices and feeds
each process its shard of the global batch; here each process drives one
card (or the CPU), holds a replica or a shard of the state, and assembles
its own rows of the global batch.  `initialize_distributed` keeps the JAX
contract (`multihost.py:17-31`): nothing happens for 1 or None processes,
a coordinator without a process count raises, and otherwise it starts the
process group, with NCCL for CUDA tensors and gloo for CPU tensors (DCP's
host-side plans and `dcp.async_save`'s writes need gloo).  On the CPU
(`device="cpu"`) the group is gloo alone.  A failed start raises.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

_CKPT_GROUP = None


def initialize_distributed(coordinator_address=None, num_processes=None,
                           process_id=None, device="cuda"):
    """Start the default process group at `tcp://<coordinator_address>`
    with `num_processes` ranks, this one `process_id`; no-op (False) for a
    single process.  `device` picks the backends: "cuda" (the default)
    "cpu:gloo,cuda:nccl", "cpu" gloo alone."""
    if num_processes in (None, 1):
        if coordinator_address is not None and num_processes is None:
            # ignoring the coordinator would run N unsynchronised trainings
            # that overwrite each other's checkpoints
            raise ValueError(
                "--dist-coordinator given without --dist-num-processes; "
                "pass both (and --dist-process-id) to run multi-process")
        return False
    if coordinator_address is None or process_id is None:
        raise ValueError("multi-process training needs --dist-coordinator "
                         "and --dist-process-id")
    cuda = torch.device(device).type == "cuda"
    if cuda and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: a multi-process run on "
                           "the CPU needs --device cpu")
    dist.init_process_group(
        "cpu:gloo,cuda:nccl" if cuda else "gloo",
        init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id)
    return True


def world():
    """(rank, world size): (0, 1) without a process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def checkpoint_group():
    """A gloo group over every rank for checkpoint I/O, created on first
    use (every rank reaches it at the same save or load)."""
    global _CKPT_GROUP
    if _CKPT_GROUP is None:
        _CKPT_GROUP = dist.new_group(backend="gloo")
    return _CKPT_GROUP


def shutdown():
    """Destroy the process group (and the checkpoint group with it)."""
    global _CKPT_GROUP
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    _CKPT_GROUP = None


def process_seed(base_seed):
    """Per-rank seed offset (reference train_model.py:38-40)."""
    return base_seed + world()[0]


def local_shard_indices(global_batch):
    """Index range of this rank's rows of a length-`global_batch` batch."""
    rank, size = world()
    per = global_batch // size
    return range(rank * per, (rank + 1) * per)


def effective_lr_step_divisor(batch_size):
    """lr-step division by batch * world size (train_model.py:217-222):
    one card per rank."""
    return max(1, batch_size * world()[1])
