"""Packed-stem, BN-folded ResNet-18 for serving: the port's counterpart of
`dmcnet_tpu/ops/packed_resnet.py`.

Two exact rewrites of `models.resnet.ResNet` (the reference TSN classifier,
code/dmcnet/model.py:283-327) for the inference forward:

1. **Space-to-depth stem.**  The 7x7 stride-2 pad-3 conv over the 2-channel
   cue becomes a 4x4 stride-1 conv over the s=2 packed input (the layout
   `ops.packed_generator` produces, channel (qy*2 + qx)*C_in + c), with
   asymmetric padding (2, 1) per spatial dim reproducing torch's pad-3
   floor-mode geometry:

       y[i] = sum_a w[a] x[2i + a - 3]        (original, stride 2, pad 3)
       x[2u + q] = p[u, q]                    (packed input)
       => y[i] = sum_{du, q} w[2 du + q + 3] p[i + du, q],  du in [-2, 1]

2. **BN folding.**  Inference BatchNorm is an affine map, folded into the
   conv before it once at build time:
       w' = w * gamma / sqrt(var + eps),  b' = beta - mean * that.

Both are exact in float32; serving runs them in bfloat16.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from dmcnet_tpu_torch.models.layers import BN_EPS


def pack_stem_conv(w, s=2):
    """(C_out, C_in, 7, 7) stride-2 pad-3 conv -> (C_out, s*s*C_in, 4, 4)
    stride-1 conv on the s=2 packed input, padded (2, 1) per dim; numpy."""
    c_out, c_in, kh, kw = w.shape
    if s != 2 or (kh, kw) != (7, 7):
        raise ValueError(f"a 7x7 stem at s=2, not {w.shape} at s={s}")
    wp = np.zeros((c_out, s * s * c_in, 4, 4), w.dtype)
    for du in range(-2, 2):
        for dv in range(-2, 2):
            for qy in range(s):
                for qx in range(s):
                    a, b = 2 * du + qy + 3, 2 * dv + qx + 3
                    if 0 <= a < 7 and 0 <= b < 7:
                        q = (qy * s + qx) * c_in
                        wp[:, q:q + c_in, du + 2, dv + 2] = w[:, :, a, b]
    return wp


def fold_bn(w, bn, eps=BN_EPS):
    """Fold the inference BatchNorm `bn` into the conv weight `w` (C_out,
    ...) before it: (w', b') as float32 numpy, computed in float64."""
    def f64(t):
        return t.detach().cpu().numpy().astype(np.float64)

    k = f64(bn.weight) / np.sqrt(f64(bn.running_var) + eps)
    w = np.asarray(w.detach().cpu().numpy() if torch.is_tensor(w) else w,
                   np.float64)
    return ((w * k.reshape((-1,) + (1,) * (w.ndim - 1))).astype(np.float32),
            (f64(bn.bias) - f64(bn.running_mean) * k).astype(np.float32))


class PackedResNet18(nn.Module):
    """Inference twin of a BasicBlock `models.resnet.ResNet` (ResNet-18)
    that takes the s=2 packed input (B, 4*C_in, H/2, W/2), e.g. the packed
    generator's output with the mv delta fused.  Built from the module's
    weights and running statistics; the folded weights are buffers in
    `dtype`, so `.to(device)` moves them."""

    def __init__(self, resnet, s=2, dtype=torch.bfloat16):
        super().__init__()
        self.dtype = dtype

        def keep(name, wb):
            for suffix, a in zip(("w", "b"), wb):
                self.register_buffer(f"{name}_{suffix}",
                                     torch.from_numpy(a).to(dtype))

        w1, b1 = fold_bn(resnet.conv1.weight, resnet.bn1)
        keep("stem", (pack_stem_conv(w1, s), b1))
        self.blocks = []   # (name, stride, has downsample)
        for stage in range(resnet.n_stages):
            for j, block in enumerate(getattr(resnet, f"layer{stage + 1}")):
                name = f"layer{stage + 1}_{j}"
                keep(f"{name}_conv1", fold_bn(block.conv1.weight, block.bn1))
                keep(f"{name}_conv2", fold_bn(block.conv2.weight, block.bn2))
                if block.downsample is not None:
                    keep(f"{name}_down", fold_bn(block.downsample[0].weight,
                                                 block.downsample[1]))
                self.blocks.append((name, block.conv1.stride[0],
                                    block.downsample is not None))
        keep("fc", (resnet.fc.weight.detach().float().cpu().numpy(),
                    resnet.fc.bias.detach().float().cpu().numpy()))

    def _conv(self, name, x, stride=1, pad=1):
        return F.conv2d(x, getattr(self, f"{name}_w"),
                        getattr(self, f"{name}_b"), stride, pad)

    def forward(self, x_packed):
        # packed stem: 4x4 stride 1, padding (2, 1) == the 7x7/2 pad-3 conv
        x = self._conv("stem", F.pad(x_packed.to(self.dtype), (2, 1, 2, 1)),
                       pad=0)
        x = F.pad(F.relu(x), (1, 1, 1, 1), value=float("-inf"))
        x = F.max_pool2d(x, 3, 2)
        for name, stride, down in self.blocks:
            y = F.relu(self._conv(f"{name}_conv1", x, stride))
            y = self._conv(f"{name}_conv2", y)
            identity = self._conv(f"{name}_down", x, stride, 0) if down \
                else x
            x = F.relu(y + identity)
        return F.linear(x.mean((2, 3)), self.fc_w, self.fc_b)
