"""DMC generator networks (counterpart of
`dmcnet_tpu/models/generators.py`).

MV (2 ch) + residual (3 ch) -> a 2-channel discriminative motion cue.
Module names follow the reference torch keys
(`dmcnet_tpu/models/export_torch.py:91-110`), so reference checkpoints load
with `load_state_dict` directly.  Families:

  * ContextNetwork(-Att): seven dilated 3x3 stages, each conv (no bias) +
    BN + LeakyReLU(0.1), the last 2-channel one included; dilations
    1-2-4-8-16-1-1, or 1-2-4-8-1-1-1 when the cue is generated at reduced
    resolution (`gen_flow_ds_factor`).  Keys `conv_context.{i}.0/.1`; the
    attention variant ends in `predict_flow.0/.1` and `predict_att.0.0/
    .0.1` heads, the attention one followed by ReLU (reference
    model.py:45-104).
  * Dense family: five stages, each a 3x3 conv + LeakyReLU(0.1) whose
    output is concatenated IN FRONT of everything before it ([y, x]), then
    a bare 3x3 `predict_flow` conv; channel plans 128/128/96/64/32,
    32/32/24/16/8 and 8/8/6/4/2 (model.py:122-194).  Keys `conv_{i}.0`.
  * Tiny early fusion: separate 3x3 stems for MV (`conv_0_mv.0`) and
    residual (`conv_0_r.0`), merged by sum or stack, then the Tiny plan's
    last four dense stages (model.py:197-250).

`packed=s` (s > 1, `--packed-gen s`) runs a dense estimator through the
space-to-depth packed layout of `ops/packed_generator.py`, an exact
reparameterization of the same parameters.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from dmcnet_tpu_torch.models.layers import batch_norm, conv3x3
from dmcnet_tpu_torch.ops.packed_generator import (
    depth_to_space,
    pack_conv3x3_torch,
    space_to_depth,
)

_LEAKY_SLOPE = 0.1
_CONTEXT_WIDTHS = (32, 128, 128, 96, 64, 32, 2)


def _leaky():
    return nn.LeakyReLU(_LEAKY_SLOPE)


def _dilated_stage(c_in, c_out, dilation=1):
    """conv(3x3, dilated, no bias) + BN + LeakyReLU(0.1) (reference
    conv_dilation)."""
    return nn.Sequential(conv3x3(c_in, c_out, dilation=dilation, bias=False),
                         batch_norm(c_out), _leaky())


def _context_trunk(dilations, in_channels=5):
    stages, c = [], in_channels
    for w, d in zip(_CONTEXT_WIDTHS, dilations):
        stages.append(_dilated_stage(c, w, d))
        c = w
    return nn.Sequential(*stages)


class ContextNetwork(nn.Module):
    def __init__(self, gen_flow_ds_factor=0):
        super().__init__()
        dilations = (1, 2, 4, 8, 1, 1, 1) if gen_flow_ds_factor else (
            1, 2, 4, 8, 16, 1, 1)
        self.conv_context = _context_trunk(dilations)

    def forward(self, x):
        return self.conv_context(x)


class ContextNetworkAtt(nn.Module):
    """ContextNetwork's first six stages + a flow head and an attention
    head; forward returns (flow, attention)."""

    def __init__(self, gen_flow_ds_factor=0):
        super().__init__()
        dilations = (1, 2, 4, 8, 1, 1) if gen_flow_ds_factor else (
            1, 2, 4, 8, 16, 1)
        self.conv_context = _context_trunk(dilations)
        c = _CONTEXT_WIDTHS[len(dilations) - 1]
        self.predict_flow = _dilated_stage(c, 2)
        self.predict_att = nn.Sequential(_dilated_stage(c, 2), nn.ReLU())

    def forward(self, x):
        x = self.conv_context(x)
        return self.predict_flow(x), self.predict_att(x)


class _DenseEstimator(nn.Module):
    """Dense connectivity: each stage takes the concat of every earlier
    activation and the input.

    `packed=s` (s > 1) runs the same parameters through the packed layout:
    each forward packs the weights with `pack_conv3x3_torch`, so gradients
    reach the unpacked parameters, state_dict keys stay the same and
    checkpoints are interchangeable; the result equals the unpacked path's
    up to float round-off.  Inputs whose H or W does not divide by s take
    the unpacked path."""

    widths = ()

    def __init__(self, in_channels=5, packed=0):
        super().__init__()
        self.packed = packed
        c = in_channels
        for i, w in enumerate(self.widths):
            self.add_module(f"conv_{i}", nn.Sequential(conv3x3(c, w),
                                                       _leaky()))
            c += w
        self.predict_flow = conv3x3(c, 2)

    def forward(self, x):
        s = self.packed
        if s > 1 and x.shape[2] % s == 0 and x.shape[3] % s == 0:
            return self._packed(x, s)
        for i in range(len(self.widths)):
            x = torch.cat([getattr(self, f"conv_{i}")(x), x], dim=1)
        return self.predict_flow(x)

    def _packed(self, x, s):
        convs = [getattr(self, f"conv_{i}")[0]
                 for i in range(len(self.widths))] + [self.predict_flow]
        segments = [x.shape[1]]
        h = space_to_depth(x, s)
        for i, conv in enumerate(convs):
            wp, bp = pack_conv3x3_torch(conv.weight, conv.bias, s, segments)
            y = F.conv2d(h, wp, bp, padding=1)
            if i < len(convs) - 1:
                h = torch.cat([F.leaky_relu(y, _LEAKY_SLOPE), h], dim=1)
                segments = [conv.out_channels] + segments
        return depth_to_space(y, s)


class EstimatorDenseNet(_DenseEstimator):
    widths = (128, 128, 96, 64, 32)


class EstimatorDenseNetSmall(_DenseEstimator):
    widths = (32, 32, 24, 16, 8)


class EstimatorDenseNetTiny(_DenseEstimator):
    widths = (8, 8, 6, 4, 2)


class _EarlyFusionTiny(nn.Module):
    fusion = ""  # 'sum' | 'stack'
    widths = (8, 6, 4, 2)

    def __init__(self):
        super().__init__()
        self.conv_0_mv = nn.Sequential(conv3x3(2, 8), _leaky())
        self.conv_0_r = nn.Sequential(conv3x3(3, 8), _leaky())
        c = 8 if self.fusion == "sum" else 16
        for i, w in enumerate(self.widths, start=1):
            self.add_module(f"conv_{i}", nn.Sequential(conv3x3(c, w),
                                                       _leaky()))
            c += w
        self.predict_flow = conv3x3(c, 2)

    def forward(self, x):
        x_mv = self.conv_0_mv(x[:, :2])
        x_r = self.conv_0_r(x[:, 2:])
        x = x_mv + x_r if self.fusion == "sum" else torch.cat([x_mv, x_r], 1)
        for i in range(1, len(self.widths) + 1):
            x = torch.cat([getattr(self, f"conv_{i}")(x), x], dim=1)
        return self.predict_flow(x)


class EstimatorDenseNetTinyEarlyFusionSum(_EarlyFusionTiny):
    fusion = "sum"


class EstimatorDenseNetTinyEarlyFusionStack(_EarlyFusionTiny):
    fusion = "stack"


_ESTIMATORS = {
    "DenseNet": EstimatorDenseNet,
    "DenseNetSmall": EstimatorDenseNetSmall,
    "DenseNetTiny": EstimatorDenseNetTiny,
    "DenseNetTinyEarlyFusionSum": EstimatorDenseNetTinyEarlyFusionSum,
    "DenseNetTinyEarlyFusionStack": EstimatorDenseNetTinyEarlyFusionStack,
}


def make_estimator(arch_estimator, att=0, gen_flow_ds_factor=0, packed=0):
    """Estimator by reference name (model.py:311-325).  `att` selects
    ContextNetworkAtt; only the ContextNetwork family has an attention
    head.  `packed`: the dense family's space-to-depth factor
    (`_DenseEstimator`); the other families ignore it."""
    if arch_estimator == "ContextNetwork":
        cls = ContextNetworkAtt if att else ContextNetwork
        return cls(gen_flow_ds_factor=gen_flow_ds_factor)
    if att:
        raise ValueError(f"att=1 needs arch_estimator ContextNetwork, not "
                         f"{arch_estimator!r}")
    try:
        cls = _ESTIMATORS[arch_estimator]
    except KeyError:
        raise ValueError(
            f"unknown arch_estimator {arch_estimator!r}; choose one of "
            f"{sorted(_ESTIMATORS) + ['ContextNetwork']}") from None
    return cls(packed=packed) if issubclass(cls, _DenseEstimator) else cls()
