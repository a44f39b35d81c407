"""DMCNet: generator + TSN classifier, and the plain TSN (counterpart of
`dmcnet_tpu/models/tsn.py`).

Tensors are NCHW; segment stacks (B, S, C, H, W) are flattened to
(B*S, C, H, W).  `DMCNet.generate` runs the estimator on concat(MV,
residual), optionally on inputs average-pooled by `gen_flow_ds_factor`
(reference model.py:326-337); with `gen_flow_or_delta=1` it adds the MV
back so the generator predicts a delta (model.py:345-346); a downsampled
cue is TILED back to full size, as the reference's torch `.repeat` does
(model.py:348), not upsampled.

Without a discriminator (`arch_d=None`, the dmcnet variant) `classify`
runs the backbone on the detached cue, so the generator learns from the
reconstruction loss only (model.py:352).  With one (the dmcnet_GAN
variant) the gradient flows from the classifier into the generator
(dmcnet_GAN/model.py:560), and the discriminator scores the cue, stacked
with the real flow when one is given (dmcnet_GAN/model.py:553-561).  Train
or eval mode is the module's own (`.train()` / `.eval()`).  `packed_gen=s`
runs a dense estimator in the space-to-depth packed layout
(`generators._DenseEstimator`), same parameters.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from dmcnet_tpu_torch.models.discriminators import make_discriminator
from dmcnet_tpu_torch.models.generators import make_estimator
from dmcnet_tpu_torch.models.resnet import (
    resnet18,
    resnet34,
    resnet50,
    resnet101,
    resnet152,
)
from dmcnet_tpu_torch.utils.profiling import span

_BACKBONES = {"resnet18": resnet18, "resnet34": resnet34,
              "resnet50": resnet50, "resnet101": resnet101,
              "resnet152": resnet152}


def _backbone(arch, num_class, in_channels):
    if arch not in _BACKBONES:
        raise ValueError(f"unsupported base model {arch!r}")
    return _BACKBONES[arch](num_class, in_channels=in_channels)


def _flatten_segments(x):
    """(B, S, C, H, W) or (B, C, H, W) -> (B*S, C, H, W)."""
    return x.reshape((-1,) + tuple(x.shape[-3:]))


def segment_consensus(logits, num_segments):
    """TSN consensus: mean of per-segment logits (reference
    train.py:239-241)."""
    return logits.reshape((-1, num_segments) + tuple(logits.shape[1:])) \
        .mean(dim=1)


class PlainTSN(nn.Module):
    """Plain CoViAR-style TSN: the backbone classifies the modality input
    directly, no generator (`cli/test.py --plain 1`).  `in_channels` is the
    modality's: 3 for iframe and residual, 2 for mv.  The backbone runs
    inside the span `tsn.backbone` (with its stream time and its
    `clips`)."""

    def __init__(self, num_class, arch="resnet18", in_channels=3):
        super().__init__()
        self.base_model = _backbone(arch, num_class, in_channels)

    def forward(self, x):
        x = _flatten_segments(x)
        with span("tsn.backbone", device=x.device, clips=x.shape[0]):
            return self.base_model(x)


class DMCNet(nn.Module):
    """`forward(input_mv, input_residual, input_flow=None)` -> (logits,
    gen_flow[, validity][, att_flow]), like the reference `Model.forward`.

    `arch_d` names a discriminator (None: none), built for the cue's
    spatial size at the classifier, `input_size`.  Its `validity` (N, 2)
    scores cat([gen_flow, flow], 0) in one forward when `input_flow` is
    given, so that its BatchNorm sees fake and real in one batch, and
    gen_flow alone otherwise."""

    def __init__(self, num_class, num_segments=1, arch="resnet18",
                 arch_estimator="DenseNetTiny", gen_flow_or_delta=0,
                 gen_flow_ds_factor=0, att=0, arch_d=None, input_size=224,
                 packed_gen=0):
        super().__init__()
        self.num_class = num_class
        self.num_segments = num_segments
        self.gen_flow_or_delta = gen_flow_or_delta
        self.gen_flow_ds_factor = gen_flow_ds_factor
        self.att = att
        self.arch_d = arch_d
        self.gen_flow_model = make_estimator(arch_estimator, att,
                                             gen_flow_ds_factor,
                                             packed=packed_gen)
        self.base_model = _backbone(arch, num_class, in_channels=2)
        if arch_d:
            self.discriminator = make_discriminator(arch_d, input_size)

    def generate(self, input_mv, input_residual):
        """-> gen_flow, or (gen_flow, att_flow) with `att`; inside the
        `serving.generator` span (`utils.profiling.span`, with its stream
        time), as `classify` is inside the `serving.classifier` one: the
        serving stages of the unfolded forward, recorded in training
        too."""
        with span("serving.generator", device=input_mv.device):
            input_mv = _flatten_segments(input_mv)
            input_residual = _flatten_segments(input_residual)
            f = self.gen_flow_ds_factor
            if f:
                input_mv = F.avg_pool2d(input_mv, f, f)
                input_residual = F.avg_pool2d(input_residual, f, f)
            out = self.gen_flow_model(torch.cat([input_mv, input_residual],
                                                dim=1))
            gen_flow, att_flow = out if self.att else (out, None)
            if self.gen_flow_or_delta == 1:
                gen_flow = gen_flow + input_mv
            if f:
                gen_flow = gen_flow.repeat(1, 1, f, f)
            return (gen_flow, att_flow) if self.att else gen_flow

    def classify(self, gen_flow):
        with span("serving.classifier", device=gen_flow.device):
            return self.base_model(gen_flow if self.arch_d
                                   else gen_flow.detach())

    def forward(self, input_mv, input_residual, input_flow=None):
        out = self.generate(input_mv, input_residual)
        gen_flow, att_flow = out if self.att else (out, None)
        result = [self.classify(gen_flow), gen_flow]
        if self.arch_d:
            d_in = gen_flow if input_flow is None else torch.cat(
                [gen_flow, _flatten_segments(input_flow)], dim=0)
            result.append(self.discriminator(d_in))
        if self.att:
            result.append(att_flow)
        return tuple(result)
