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
`all_reduce` and `all_gather` are the collectives of the parallel modules:
NCCL carries CUDA tensors, and on a gloo group (several ranks on one card)
they go through the host.  `spawn_ranks` starts one process per card.
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


def _through_host(t, group):
    """Whether a collective on `t` goes through the host: a CUDA tensor on
    a group without NCCL (gloo alone, e.g. several ranks on one card)."""
    return t.is_cuda and "nccl" not in str(dist.get_backend(group))


def all_reduce(t, group=None):
    """`dist.all_reduce(t)` (sum, in place) over `group`, a CUDA tensor on
    a gloo group through the host; returns `t`."""
    if _through_host(t, group):
        host = t.cpu()
        dist.all_reduce(host, group=group)
        return t.copy_(host)
    dist.all_reduce(t, group=group)
    return t


def all_gather(t, group=None):
    """[every rank's `t`] over `group` (equal shapes), through the host for
    a CUDA tensor on a gloo group."""
    n = dist.get_world_size(group)
    src = t.cpu() if _through_host(t, group) else t.contiguous()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    return [p.to(t.device) for p in parts]


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


def process_seed(base_seed, tp=1):
    """Per-rank seed offset (reference train_model.py:38-40); under tensor
    parallelism of degree `tp` per data row (rank // tp: adjacent ranks
    share a row), whose ranks must draw the same rows and masks."""
    return base_seed + world()[0] // max(tp, 1)


def local_shard_indices(global_batch, tp=1):
    """Index range of this rank's rows of a length-`global_batch` batch:
    its data row's share, the same on the `tp` ranks of a row."""
    rank, size = world()
    tp = max(tp, 1)
    per = global_batch // (size // tp)
    return range(rank // tp * per, (rank // tp + 1) * per)


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank, entry, argv, gpus, kwargs, port, results):
    argv = list(argv) + [
        "--gpus", str(gpus[rank]), "--dist-coordinator",
        f"localhost:{port}", "--dist-num-processes", str(len(gpus)),
        "--dist-process-id", str(rank)]
    out = entry(argv, **kwargs)
    if rank == 0:
        results.put(out)


def spawn_ranks(entry, argv, gpus, **kwargs):
    """Several `--gpus` ids: one process per id on this host, rank r
    running `entry(argv + [--gpus gpus[r], --dist-* flags], **kwargs)` (a
    module-level command `main`; with `--device cpu`, gloo processes on
    the CPU), joined at a free local port.  Returns rank 0's result; a
    rank that fails raises, and the others are stopped."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.SimpleQueue()
    port = _free_port()
    procs = [ctx.Process(target=_rank_main, args=(
        r, entry, argv, gpus, kwargs, port, results))
        for r in range(len(gpus))]
    for p in procs:
        p.start()
    failed = []
    while any(p.is_alive() for p in procs) and not failed:
        procs[0].join(timeout=0.5)
        failed = [r for r, p in enumerate(procs) if p.exitcode not in
                  (None, 0)]
    for p in procs:  # a failed rank leaves the others at a collective
        if failed and p.is_alive():
            p.terminate()
        p.join()
    failed = [r for r, p in enumerate(procs) if p.exitcode != 0]
    if failed:
        raise SystemExit(f"ranks {failed} of {len(gpus)} failed")
    return results.get()


def effective_lr_step_divisor(batch_size):
    """lr-step division by batch * world size (train_model.py:217-222):
    one card per rank."""
    return max(1, batch_size * world()[1])
