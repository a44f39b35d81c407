"""DMC generator networks, dense family (counterpart of
`dmcnet_tpu/models/generators.py:110-178, 225-248`).

MV (2 ch) + residual (3 ch) -> a 2-channel discriminative motion cue.  Five
dense stages, each a 3x3 conv + LeakyReLU(0.1) whose output is concatenated
IN FRONT of everything before it ([y, x]), then a bare 3x3 `predict_flow`
conv (reference model.py:122-194).  Channel plans 128/128/96/64/32,
32/32/24/16/8 and 8/8/6/4/2.  Module names follow the reference torch keys
(`conv_0.0.weight`, ..., `predict_flow.weight`).

ContextNetwork and the early-fusion variants are not ported yet.
"""

from __future__ import annotations

import torch
from torch import nn

from dmcnet_tpu_torch.models.layers import conv3x3

_LEAKY_SLOPE = 0.1


class _DenseEstimator(nn.Module):
    widths = ()

    def __init__(self, in_channels=5):
        super().__init__()
        c = in_channels
        for i, w in enumerate(self.widths):
            self.add_module(f"conv_{i}", nn.Sequential(
                conv3x3(c, w), nn.LeakyReLU(_LEAKY_SLOPE)))
            c += w
        self.predict_flow = conv3x3(c, 2)

    def forward(self, x):
        for i in range(len(self.widths)):
            x = torch.cat([getattr(self, f"conv_{i}")(x), x], dim=1)
        return self.predict_flow(x)


class EstimatorDenseNet(_DenseEstimator):
    widths = (128, 128, 96, 64, 32)


class EstimatorDenseNetSmall(_DenseEstimator):
    widths = (32, 32, 24, 16, 8)


class EstimatorDenseNetTiny(_DenseEstimator):
    widths = (8, 8, 6, 4, 2)


_ESTIMATORS = {
    "DenseNet": EstimatorDenseNet,
    "DenseNetSmall": EstimatorDenseNetSmall,
    "DenseNetTiny": EstimatorDenseNetTiny,
}


def make_estimator(arch_estimator):
    """Estimator by reference name (model.py:311-325); the dense family
    only."""
    try:
        return _ESTIMATORS[arch_estimator]()
    except KeyError:
        raise ValueError(
            f"arch_estimator {arch_estimator!r} is not ported; choose one "
            f"of {sorted(_ESTIMATORS)}") from None
