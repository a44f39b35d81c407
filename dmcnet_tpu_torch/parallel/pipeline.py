"""GPipe pipeline parallelism over a (stage, data) grid of devices
(counterpart of `dmcnet_tpu/parallel/pipeline.py`).

n stages on n devices, the batch cut into m microbatches: at schedule step
t (of m + n - 1) stage i works on microbatch t - i, so stage 0 takes
microbatch t at step t and the last stage gives microbatch t's output at
step t + n - 1.  The bubble is (n - 1) / (m + n - 1) of the steps; m must
divide the batch and defaults to n.

One process drives every stage, as the JAX `--pp` is one program over the
local devices: `Pipeline` holds the stage modules, each on its stage's
device, and its host loop walks the schedule in order.  CUDA launches
return before the work is done, so a card starts microbatch j + 1 while
the next card still runs microbatch j.  An activation hops to the next
stage's device with `.to(device, non_blocking=True)`; autograd carries the
backward pass back across the same hops, so gradients through the schedule
are the serial model's and this trains as well as it scores.
`remat=True` runs each (stage, microbatch) under `torch.utils.checkpoint`:
the backward pass recomputes the stage's activations instead of keeping
them.

With `make_stage_mesh(devices, data=k)` each stage is replicated k ways
and each microbatch's rows split over the replicas.  Replica r > 0 runs its
stage through `torch.func.functional_call` on the parameters and buffers
copied to its device; the copies are differentiable, so the replicas'
gradients sum into the one parameter, as the JAX gradient sums over
`data`.

A device may appear in the grid more than once, so that one card, or the
CPU in tests, can carry several stages.  The JAX module's stacked
parameter axis (`stack_stage_params`, `shard_stage_params`), its flat f32
activation plane and `flatten_tree` make its stages one SPMD program with
one activation shape; here each stage is its own module, so the same-shape
and the heterogeneous schedules are one (`make_pipeline_apply`,
`make_hetero_pipeline_apply`).
"""

from __future__ import annotations

import torch
from torch import nn
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from dmcnet_tpu_torch import resolve_device


def make_stage_mesh(devices=None, data=1):
    """The (stage, data) grid as a list of rows of `torch.device`s: row i
    holds stage i's `data` replicas, adjacent devices in one row, as the
    JAX mesh puts adjacent ids on `data`.  `devices` None means every
    visible card (and raises without CUDA)."""
    if devices is None:
        resolve_device()
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    if data < 1 or n % data:
        raise ValueError(f"{n} devices not divisible by data={data}")
    return [devices[i:i + data] for i in range(0, n, data)]


class Pipeline(nn.Module):
    """`forward(x)` equals applying `stages` one after another to the whole
    batch, computed by the GPipe schedule over `mesh`
    (`make_stage_mesh`); stage i is moved to `mesh[i][0]` and the output
    lies there for the last stage.  The stages may be modules of one model
    (`pp_resnet.resnet18_stage_split`), which then lies across the
    stages' devices.  Train-mode BatchNorm would see microbatch statistics
    and update buffers the replicas only copy: run stages that hold
    BatchNorm in eval mode."""

    def __init__(self, stages, mesh, n_microbatches=None, remat=False):
        super().__init__()
        if len(stages) != len(mesh):
            raise ValueError(f"{len(stages)} stages for a {len(mesh)}-stage "
                             "mesh")
        self.stages = nn.ModuleList(stages)
        self.mesh = [list(row) for row in mesh]
        self.n_microbatches = n_microbatches or len(mesh)
        self.remat = remat
        for stage, row in zip(self.stages, self.mesh):
            stage.to(row[0])

    def _replica(self, i, r):
        """Stage i's parameters and buffers on replica r's device (None for
        replica 0, which runs the module itself)."""
        if r == 0:
            return None
        dev = self.mesh[i][r]
        stage = self.stages[i]
        return {name: t.to(dev, non_blocking=True) for name, t in
                list(stage.named_parameters()) + list(stage.named_buffers())}

    def _apply(self, i, weights, x):
        stage = self.stages[i]
        if weights is None:
            fn = stage
        else:
            def fn(z):
                return functional_call(stage, weights, (z,))
        if self.remat and torch.is_grad_enabled():
            return checkpoint(fn, x, use_reentrant=False)
        return fn(x)

    def forward(self, x):
        n, m, k = len(self.stages), self.n_microbatches, len(self.mesh[0])
        b = x.shape[0]
        if b % m:
            raise ValueError(f"batch {b} not divisible by {m} microbatches")
        if (b // m) % k:
            raise ValueError(f"microbatch {b // m} not divisible by "
                             f"data={k}")
        # lanes[j][r]: replica r's rows of microbatch j
        lanes = [mb.chunk(k) for mb in x.chunk(m)]
        weights = [[self._replica(i, r) for r in range(k)] for i in range(n)]
        inbox = {}      # (stage, microbatch, replica) -> its input
        outs = [[None] * k for _ in range(m)]
        for t in range(m + n - 1):
            for i in range(max(0, t - m + 1), min(n, t + 1)):
                j = t - i
                for r in range(k):
                    dev = self.mesh[i][r]
                    inp = lanes[j][r].to(dev, non_blocking=True) if i == 0 \
                        else inbox.pop((i, j, r))
                    y = self._apply(i, weights[i][r], inp)
                    if i == n - 1:
                        outs[j][r] = y
                    else:   # the hop to the next stage, read at step t + 1
                        inbox[i + 1, j, r] = y.to(self.mesh[i + 1][r],
                                                  non_blocking=True)
        out_dev = self.mesh[-1][0]
        return torch.cat([y.to(out_dev) for row in outs for y in row])


def make_pipeline_apply(stages, mesh, n_microbatches=None, remat=False):
    """The GPipe schedule over `stages` (`make_pipeline_apply` of the JAX
    package, whose stages must keep the activation's shape, and its
    `make_hetero_pipeline_apply`, whose stages need not): a `Pipeline`."""
    return Pipeline(stages, mesh, n_microbatches=n_microbatches, remat=remat)


# One schedule serves both: each stage is a module of its own, with no
# shared activation plane to keep one shape.
make_hetero_pipeline_apply = make_pipeline_apply
