"""Layer helpers with torch's own defaults (counterpart of
`dmcnet_tpu/models/layers.py`).

The JAX package spells out torch-style symmetric padding (`torch_pad`) and
torch BatchNorm semantics because flax's defaults differ; here they are
PyTorch's native behaviour, so the helpers only fix the constants.

I3D is the other way round: the reference emulates TensorFlow's `SAME`
padding in torch (network/i3d.py:299-325), which XLA's `SAME` is natively.
`same_pad_3d` gives that split explicitly, for an unpadded `Conv3d` or a
max pool behind `F.pad`.  A symmetric `padding=` would shift every output
of a stride-2 layer on an even size by one pixel (the 7x7x7 stem, the
(3,3,3)/(2,2,2) pools).
"""

from __future__ import annotations

import torch.nn.functional as F
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


def batch_norm3d(features, eps=BN_EPS):
    return nn.BatchNorm3d(features, eps=eps, momentum=BN_MOMENTUM)


def same_pad_3d(sizes, kernel, stride):
    """XLA's `SAME` split for the (T, H, W) axes, as the `F.pad` tuple
    (w_lo, w_hi, h_lo, h_hi, t_lo, t_hi): per axis total = max((ceil(n/s)
    - 1) * s + k - n, 0), lo = total // 2, the odd pixel at the end."""
    pads = []
    for n, k, s in zip(sizes, kernel, stride):
        total = max((-(-n // s) - 1) * s + k - n, 0)
        pads.append((total // 2, total - total // 2))
    return tuple(p for lo_hi in reversed(pads) for p in lo_hi)


def window3d(x, kernel, stride, op, shard=None, same=True, pad_value=0.0):
    """`op`, an unpadded window of `kernel` and `stride`, on (B, C, T, H,
    W) padded with `pad_value` to `SAME` (`same_pad_3d`), or not at all
    (VALID).  With a `shard` (`parallel.temporal.TimeShard`), `x` is this
    rank's `Frames` of a clip split along T and the T window runs through
    `shard.window`, which pads from the global T."""
    if shard is not None:
        return shard.window(x, kernel, stride, op, same, pad_value)
    if same:
        x = F.pad(x, same_pad_3d(x.shape[2:], kernel, stride),
                  value=pad_value)
    return op(x)


def max_pool3d_same(x, kernel, stride, shard=None):
    """Max pool with `SAME` padding on (B, C, T, H, W).  The padding is
    -inf, as XLA pads a max window, so any input pools exactly."""
    return window3d(x, kernel, stride,
                    lambda v: F.max_pool3d(v, kernel, stride), shard,
                    pad_value=float("-inf"))
