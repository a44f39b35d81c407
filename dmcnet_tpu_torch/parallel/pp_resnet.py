"""Pipeline-parallel ResNet-18 (counterpart of
`dmcnet_tpu/parallel/pp_resnet.py`): the port's `models/resnet.ResNet`
cut along its residual stages, where the activation's geometry and the
parameters change, and run through the GPipe schedule
(`parallel/pipeline.py`):

    4 stages: [stem + layer1] [layer2] [layer3] [layer4 + avgpool + fc]
    2 stages: [stem + layer1 + layer2] [layer3 + layer4 + head]

The stages are the model's own modules, not copies, so the pipeline scores
with the model's weights and its gradients land in the model.  The scoring
forward of `cli/test.py --pp` runs in eval mode (BatchNorm on its running
statistics); gradients through the schedule equal the serial model's
(tests/test_torch_pipeline.py)."""

from __future__ import annotations

from torch import nn

from dmcnet_tpu_torch.parallel.pipeline import Pipeline


def resnet18_stage_split(model, n_stages=4):
    """`model`'s modules as `n_stages` (4 or 2) sequential stages at the
    JAX package's cut points."""
    stem = [model.conv1, model.bn1, model.relu, model.maxpool]
    head = [model.avgpool, nn.Flatten(1), model.fc]
    if n_stages == 4:
        parts = [stem + [model.layer1], [model.layer2], [model.layer3],
                 [model.layer4] + head]
    elif n_stages == 2:
        parts = [stem + [model.layer1, model.layer2],
                 [model.layer3, model.layer4] + head]
    else:
        raise ValueError(f"unsupported ResNet-18 split: {n_stages} stages")
    return [nn.Sequential(*p) for p in parts]


def make_pp_resnet18(model, mesh, n_microbatches=None):
    """A `Pipeline` of `model`'s eval-mode forward over `mesh`
    (`make_stage_mesh`, one row per stage, optionally x data), which moves
    each stage's modules to its device; call it on (N, C, H, W) clips for
    (N, num_classes) logits."""
    model.eval()
    return Pipeline(resnet18_stage_split(model, len(mesh)), mesh,
                    n_microbatches=n_microbatches)
