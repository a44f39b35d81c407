"""Training and evaluation over several devices (counterpart of
`dmcnet_tpu/parallel`): `multihost` starts the process group, shards the
batch's rows and spawns one process per card, `mesh` is data parallelism
with global-batch BatchNorm and averaged gradients, `fsdp` shards
parameters and optimizer states with FSDP2, `tensor` shards the large
layers' output channels over a (data, model) mesh, and `temporal` splits an
I3D clip's T axis over the ranks with halo exchanges.  Two need no process
group: `pipeline` runs a GPipe schedule over a (stage, data) grid of
devices from one process, and `pp_resnet` cuts ResNet-18 into its stages
(`cli/test.py --pp`); serving over several cards is
`serving.DMCPredictor(mesh=...)`, a replica on each device."""

from dmcnet_tpu_torch.parallel.pipeline import (
    Pipeline,
    make_hetero_pipeline_apply,
    make_pipeline_apply,
    make_stage_mesh,
)
from dmcnet_tpu_torch.parallel.pp_resnet import (
    make_pp_resnet18,
    resnet18_stage_split,
)

__all__ = ["Pipeline", "make_hetero_pipeline_apply", "make_pipeline_apply",
           "make_stage_mesh", "make_pp_resnet18", "resnet18_stage_split"]
