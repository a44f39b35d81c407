"""I3D (Inflated Inception-3D) with the embedded DMC generator and
discriminator (counterpart of `dmcnet_tpu/models/i3d.py`), in the
reference's NCTHW layout (B, C, T, H, W):

  * Unit3D = conv3d + BN + ReLU with TF-SAME padding (`layers.same_pad_3d`
    in front of an unpadded `Conv3d`; reference Unit3Dpy, i3d.py:328-403);
  * max pools with TF-SAME padding (`layers.max_pool3d_same`);
  * stem 7x7x7/s2 -> pools -> mixed_3b..5c -> AvgPool3d((2,7,7), s1) ->
    conv3d_0c_1x1 (1024 -> 400, bias, no BN) -> mean over time ->
    Dropout(dropout_prob) -> Linear(400, C) (i3d.py:502-560); the dropout
    is element-wise on (B, 400), kept values scaled by 1 / (1 - p), and the
    identity in eval;
  * the per-frame DMC generator on (B*T, 5, H, W), which in NCTHW needs a
    permute each way (i3d.py:568-571);
  * `node` multiplexing: 'logit' | 'flow+logit' | 'gen_flow' | 'D'
    (i3d.py:563-601), and `detach` before the stem.

Module names are the reference keys that the JAX package's importer reads
(`dmcnet_tpu/models/import_torch_i3d.py:28-69`): `conv3d_1a_7x7.conv3d` /
`.batch3d`, `mixed_3b.branch_0`, `branch_1.{0,1}`, `branch_2.{0,1}`,
`branch_3.1` (`branch_3.0` is the pool), `conv3d_0c_1x1.conv3d`,
`classifier`, `gen_flow_model`, `discriminator`.

The JAX package's TPU lowerings (`unroll_time`, `remat`, `packed_gen`) are
not ported: they change neither parameters nor results.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from dmcnet_tpu_torch.models.discriminators import make_discriminator
from dmcnet_tpu_torch.models.generators import make_estimator
from dmcnet_tpu_torch.models.layers import (
    batch_norm3d,
    max_pool3d_same,
    same_pad_3d,
)


class Unit3D(nn.Module):
    """conv3d (TF-SAME) [+ BN] [+ ReLU]."""

    def __init__(self, c_in, c_out, kernel=(1, 1, 1), stride=(1, 1, 1),
                 activation="relu", use_bias=False, use_bn=True):
        super().__init__()
        self.kernel, self.stride = tuple(kernel), tuple(stride)
        self.conv3d = nn.Conv3d(c_in, c_out, self.kernel, self.stride,
                                bias=use_bias)
        self.batch3d = batch_norm3d(c_out) if use_bn else None
        self.relu = activation == "relu"

    def forward(self, x):
        x = self.conv3d(F.pad(x, same_pad_3d(x.shape[2:], self.kernel,
                                             self.stride)))
        if self.batch3d is not None:
            x = self.batch3d(x)
        return F.relu(x) if self.relu else x


class MaxPool3dSame(nn.Module):
    def __init__(self, kernel, stride):
        super().__init__()
        self.kernel, self.stride = tuple(kernel), tuple(stride)

    def forward(self, x):
        return max_pool3d_same(x, self.kernel, self.stride)


class Mixed(nn.Module):
    """Inception block: 1x1 / 1x1-3x3 / 1x1-3x3 / pool-1x1 branches
    concatenated on channels (reference i3d.py:421-455)."""

    def __init__(self, c_in, out_channels):
        super().__init__()
        b0, b1a, b1b, b2a, b2b, b3 = out_channels
        self.branch_0 = Unit3D(c_in, b0)
        self.branch_1 = nn.Sequential(Unit3D(c_in, b1a),
                                      Unit3D(b1a, b1b, (3, 3, 3)))
        self.branch_2 = nn.Sequential(Unit3D(c_in, b2a),
                                      Unit3D(b2a, b2b, (3, 3, 3)))
        self.branch_3 = nn.Sequential(MaxPool3dSame((3, 3, 3), (1, 1, 1)),
                                      Unit3D(c_in, b3))

    def forward(self, x):
        return torch.cat([self.branch_0(x), self.branch_1(x),
                          self.branch_2(x), self.branch_3(x)], dim=1)


_MIXED_PLAN = {
    "mixed_3b": [64, 96, 128, 16, 32, 32],
    "mixed_3c": [128, 128, 192, 32, 96, 64],
    "mixed_4b": [192, 96, 208, 16, 48, 64],
    "mixed_4c": [160, 112, 224, 24, 64, 64],
    "mixed_4d": [128, 128, 256, 24, 64, 64],
    "mixed_4e": [112, 144, 288, 32, 64, 64],
    "mixed_4f": [256, 160, 320, 32, 128, 128],
    "mixed_5b": [256, 160, 320, 32, 128, 128],
    "mixed_5c": [384, 192, 384, 48, 128, 128],
}

# Pools between the blocks: (after this module, kernel, stride).
_POOLS = {
    "conv3d_1a_7x7": ((1, 3, 3), (1, 2, 2)),
    "conv3d_2c_3x3": ((1, 3, 3), (1, 2, 2)),
    "mixed_3c": ((3, 3, 3), (2, 2, 2)),
    "mixed_4f": ((2, 2, 2), (2, 2, 2)),
}


def mixed_width(plan):
    return plan[0] + plan[2] + plan[4] + plan[5]


class I3D(nn.Module):
    """Inception-3D classifier with an optional embedded DMC generator
    (`arch_estimator`) and GAN discriminator (`arch_d`, built for frames of
    `input_size`)."""

    def __init__(self, num_classes, modality="rgb", arch_estimator=None,
                 arch_d=None, input_size=224, dropout_prob=0.0):
        super().__init__()
        self.modality = modality
        if arch_estimator:
            self.gen_flow_model = make_estimator(arch_estimator)
        else:
            self.gen_flow_model = None
        if arch_d:
            self.discriminator = make_discriminator(arch_d, input_size)
        else:
            self.discriminator = None
        self.conv3d_1a_7x7 = Unit3D(self.in_channels, 64, (7, 7, 7),
                                    (2, 2, 2))
        self.conv3d_2b_1x1 = Unit3D(64, 64)
        self.conv3d_2c_3x3 = Unit3D(64, 192, (3, 3, 3))
        c = 192
        for name, plan in _MIXED_PLAN.items():
            self.add_module(name, Mixed(c, plan))
            c = mixed_width(plan)
        self.conv3d_0c_1x1 = Unit3D(c, 400, activation=None, use_bias=True,
                                    use_bn=False)
        self.dropout = nn.Dropout(dropout_prob)
        self.classifier = nn.Linear(400, num_classes)

    @property
    def in_channels(self):
        return 2 if self.modality in ("flow", "mv", "flow+mp4") else 3

    def generate(self, x):
        """Per-frame DMC generation: (B, 5, T, H, W) -> (B, 2, T, H, W)."""
        b, c, t, h, w = x.shape
        frames = x.permute(0, 2, 1, 3, 4).reshape(b * t, c, h, w)
        gen = self.gen_flow_model(frames)
        return gen.reshape(b, t, -1, h, w).permute(0, 2, 1, 3, 4)

    def features_to_logits(self, x):
        names = ["conv3d_1a_7x7", "conv3d_2b_1x1", "conv3d_2c_3x3",
                 *_MIXED_PLAN]
        for name in names:
            x = getattr(self, name)(x)
            if name in _POOLS:
                x = max_pool3d_same(x, *_POOLS[name])
        # AvgPool3d((2, 7, 7), stride 1), VALID (i3d.py:549), its window
        # clipped to the feature shape so that inputs under 224 x 224 or 16
        # frames stay legal; at those sizes and above it is (2, 7, 7).
        win = tuple(min(k, n) for k, n in zip((2, 7, 7), x.shape[2:]))
        x = F.avg_pool3d(x, win, stride=1)
        x = self.conv3d_0c_1x1(x)
        # squeeze space, mean over time (Unit3Dpy, i3d.py:398-402)
        x = x.squeeze(4).squeeze(3).mean(2)
        return self.classifier(self.dropout(x))

    def forward(self, inp, node="logit", detach=False):
        if node == "D":
            return self.discriminator(inp)
        if self.gen_flow_model is not None:
            inp = self.generate(inp)
        if node == "gen_flow":
            return inp
        logits = self.features_to_logits(inp.detach() if detach else inp)
        if node == "flow+logit":
            return logits, inp
        return logits


def get_symbol(name, modality="rgb", num_classes=51, arch_estimator=None,
               arch_d=None, input_size=224, dropout_prob=0.0):
    """Factory and input config (reference network/symbol_builder.py:12-25,
    network/config.py:10-27: I3D mean = std = 0.5)."""
    if name.upper() != "I3D":
        raise ValueError(f"unknown network {name!r}")
    net = I3D(num_classes=num_classes, modality=modality,
              arch_estimator=arch_estimator, arch_d=arch_d,
              input_size=input_size, dropout_prob=dropout_prob)
    return net, {"mean": [0.5, 0.5, 0.5], "std": [0.5, 0.5, 0.5]}
