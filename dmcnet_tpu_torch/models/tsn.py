"""DMCNet in eval mode: generator + TSN classifier (counterpart of
`dmcnet_tpu/models/tsn.py:53-56, 84-138`).

Tensors are NCHW.  `generate` runs the estimator on concat(MV, residual)
and, with `gen_flow_or_delta=1`, adds the MV back so the generator predicts
a delta (reference model.py:345-346); `classify` runs the backbone on the
cue.  The discriminator, downsampled generation and training are not ported
yet.
"""

from __future__ import annotations

import torch
from torch import nn

from dmcnet_tpu_torch.models.generators import make_estimator
from dmcnet_tpu_torch.models.resnet import resnet18, resnet34

_BACKBONES = {"resnet18": resnet18, "resnet34": resnet34}


def _flatten_segments(x):
    """(B, S, C, H, W) or (B, C, H, W) -> (B*S, C, H, W)."""
    return x.reshape((-1,) + tuple(x.shape[-3:]))


def segment_consensus(logits, num_segments):
    """TSN consensus: mean of per-segment logits (reference
    train.py:239-241)."""
    return logits.reshape((-1, num_segments) + tuple(logits.shape[1:])) \
        .mean(dim=1)


class DMCNet(nn.Module):
    """`forward(input_mv, input_residual)` -> (logits, gen_flow), like the
    reference `Model.forward` without a discriminator."""

    def __init__(self, num_class, num_segments=1, arch="resnet18",
                 arch_estimator="DenseNetTiny", gen_flow_or_delta=0):
        super().__init__()
        if arch not in _BACKBONES:
            raise ValueError(f"unsupported base model {arch!r}")
        self.num_class = num_class
        self.num_segments = num_segments
        self.gen_flow_or_delta = gen_flow_or_delta
        self.gen_flow_model = make_estimator(arch_estimator)
        self.base_model = _BACKBONES[arch](num_class, in_channels=2)

    def generate(self, input_mv, input_residual):
        input_mv = _flatten_segments(input_mv)
        input_residual = _flatten_segments(input_residual)
        gen_flow = self.gen_flow_model(
            torch.cat([input_mv, input_residual], dim=1))
        if self.gen_flow_or_delta == 1:
            gen_flow = gen_flow + input_mv
        return gen_flow

    def classify(self, gen_flow):
        return self.base_model(gen_flow)

    def forward(self, input_mv, input_residual):
        gen_flow = self.generate(input_mv, input_residual)
        return self.classify(gen_flow), gen_flow
