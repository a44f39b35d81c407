"""Layer helpers with torch's own defaults (counterpart of
`dmcnet_tpu/models/layers.py`).

The JAX package spells out torch-style symmetric padding (`torch_pad`) and
torch BatchNorm semantics because flax's defaults differ; here they are
PyTorch's native behaviour, so the helpers only fix the constants.
"""

from __future__ import annotations

from torch import nn

# torch BatchNorm2d defaults: eps=1e-5, momentum=0.1.
BN_EPS = 1e-5
BN_MOMENTUM = 0.1


def conv3x3(c_in, c_out, stride=1, dilation=1, bias=True):
    """3x3 conv with symmetric padding of `dilation` pixels: SAME at stride
    1, torch's floor-mode geometry ((H + 2p - 3) // 2 + 1) at stride 2."""
    return nn.Conv2d(c_in, c_out, 3, stride=stride, padding=dilation,
                     dilation=dilation, bias=bias)


def batch_norm(features, eps=BN_EPS):
    return nn.BatchNorm2d(features, eps=eps, momentum=BN_MOMENTUM)
