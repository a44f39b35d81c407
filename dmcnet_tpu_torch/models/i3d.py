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

Every op with a temporal window (the `Unit3D`s, the pools, the final
average) runs through `layers.window3d`, and the mean over T is the last
temporal op.  Given a `parallel.temporal.TimeShard`, `features_to_logits`
runs on one rank's frames of a clip split along T (`evaluate_video_i3d
--shard-time`); without one it is the plain forward.

`packed_gen=s` runs a dense generator in the space-to-depth packed layout
(`generators._DenseEstimator`), same parameters.

`remat` (the JAX package's Mixed-block rematerialization, `train_i3d
--remat`): True recomputes each Mixed block and the generator in the
backward; "dots" keeps each Mixed block's convolution outputs and
recomputes its BN/ReLU tails, pools and concatenation, and leaves the
generator alone (`layers.remat_call`).  Without grad nothing is
rematerialized.  `unroll_time` runs every conv with kt > 1 and temporal
stride 1 (`conv3d_2c_3x3` and the Mixed blocks' 3x3x3 convs) as kt 2D
convs (`layers.TimeUnrolledConv3d`).  Neither changes a parameter or a
state-dict key, nor a result beyond float round-off.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from dmcnet_tpu_torch.models.discriminators import make_discriminator
from dmcnet_tpu_torch.models.generators import make_estimator
from dmcnet_tpu_torch.models.layers import (
    TimeUnrolledConv3d,
    batch_norm3d,
    max_pool3d_same,
    remat_call,
    window3d,
)
from dmcnet_tpu_torch.utils.profiling import span


class Unit3D(nn.Module):
    """conv3d (TF-SAME) [+ BN] [+ ReLU]; `unroll_time` unrolls a conv of
    kt > 1 and temporal stride 1 into kt 2D convs."""

    def __init__(self, c_in, c_out, kernel=(1, 1, 1), stride=(1, 1, 1),
                 activation="relu", use_bias=False, use_bn=True,
                 unroll_time=False):
        super().__init__()
        self.kernel, self.stride = tuple(kernel), tuple(stride)
        conv = TimeUnrolledConv3d if (unroll_time and self.kernel[0] > 1
                                      and self.stride[0] == 1) else nn.Conv3d
        self.conv3d = conv(c_in, c_out, self.kernel, self.stride,
                           bias=use_bias)
        self.batch3d = batch_norm3d(c_out) if use_bn else None
        self.relu = activation == "relu"

    def _unpadded(self, x):
        x = self.conv3d(x)
        if self.batch3d is not None:
            x = self.batch3d(x)
        return F.relu(x) if self.relu else x

    def forward(self, x, shard=None):
        return window3d(x, self.kernel, self.stride, self._unpadded, shard)


class MaxPool3dSame(nn.Module):
    def __init__(self, kernel, stride):
        super().__init__()
        self.kernel, self.stride = tuple(kernel), tuple(stride)

    def forward(self, x, shard=None):
        return max_pool3d_same(x, self.kernel, self.stride, shard)


class Mixed(nn.Module):
    """Inception block: 1x1 / 1x1-3x3 / 1x1-3x3 / pool-1x1 branches
    concatenated on channels (reference i3d.py:421-455); `remat` False,
    True or "dots" (`layers.remat_call`)."""

    def __init__(self, c_in, out_channels, remat=False, unroll_time=False):
        super().__init__()
        self.remat = remat
        b0, b1a, b1b, b2a, b2b, b3 = out_channels
        self.branch_0 = Unit3D(c_in, b0)
        self.branch_1 = nn.Sequential(
            Unit3D(c_in, b1a), Unit3D(b1a, b1b, (3, 3, 3),
                                      unroll_time=unroll_time))
        self.branch_2 = nn.Sequential(
            Unit3D(c_in, b2a), Unit3D(b2a, b2b, (3, 3, 3),
                                      unroll_time=unroll_time))
        self.branch_3 = nn.Sequential(MaxPool3dSame((3, 3, 3), (1, 1, 1)),
                                      Unit3D(c_in, b3))

    def forward(self, x, shard=None):
        if self.remat:
            return remat_call(self._branches, x, shard,
                              dots=self.remat == "dots")
        return self._branches(x, shard)

    def _branches(self, x, shard):
        ys = [self.branch_0(x, shard)]
        for branch in (self.branch_1, self.branch_2, self.branch_3):
            y = x
            for layer in branch:
                y = layer(y, shard)
            ys.append(y)
        return torch.cat(ys, dim=1) if shard is None else shard.cat(ys)


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
    `input_size`); `packed_gen`, the dense generator's packing factor;
    `remat` False, True or "dots" and `unroll_time` as in the module
    docstring."""

    def __init__(self, num_classes, modality="rgb", arch_estimator=None,
                 arch_d=None, input_size=224, dropout_prob=0.0,
                 packed_gen=0, remat=False, unroll_time=False):
        super().__init__()
        if remat not in (False, True, "dots"):
            raise ValueError(f"remat must be False, True or 'dots', not "
                             f"{remat!r}")
        remat = remat if remat == "dots" else bool(remat)
        self.modality = modality
        if arch_estimator:
            self.gen_flow_model = make_estimator(arch_estimator,
                                                 packed=packed_gen,
                                                 remat=remat is True)
        else:
            self.gen_flow_model = None
        if arch_d:
            self.discriminator = make_discriminator(arch_d, input_size)
        else:
            self.discriminator = None
        self.conv3d_1a_7x7 = Unit3D(self.in_channels, 64, (7, 7, 7),
                                    (2, 2, 2))
        self.conv3d_2b_1x1 = Unit3D(64, 64)
        self.conv3d_2c_3x3 = Unit3D(64, 192, (3, 3, 3),
                                    unroll_time=unroll_time)
        c = 192
        for name, plan in _MIXED_PLAN.items():
            self.add_module(name, Mixed(c, plan, remat, unroll_time))
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

    def features_to_logits(self, x, shard=None):
        """Logits (B, C) of the flow or RGB clip `x`; with a `shard`, of
        this rank's `Frames` of it (the logits on every rank)."""
        names = ["conv3d_1a_7x7", "conv3d_2b_1x1", "conv3d_2c_3x3",
                 *_MIXED_PLAN]
        for name in names:
            x = getattr(self, name)(x, shard)
            if name in _POOLS:
                x = max_pool3d_same(x, *_POOLS[name], shard)
        # AvgPool3d((2, 7, 7), stride 1), VALID (i3d.py:549), its window
        # clipped to the (global) feature shape so that inputs under
        # 224 x 224 or 16 frames stay legal; at those sizes and above it
        # is (2, 7, 7).
        win = tuple(min(k, n) for k, n in zip((2, 7, 7), x.shape[2:]))
        x = window3d(x, win, (1, 1, 1),
                     lambda v: F.avg_pool3d(v, win, stride=1), shard,
                     same=False)
        x = self.conv3d_0c_1x1(x, shard)
        # squeeze space, mean over time (Unit3Dpy, i3d.py:398-402)
        x = x.squeeze(4).squeeze(3).mean(2) if shard is None else \
            shard.mean_t(x)
        return self.classifier(self.dropout(x))

    def forward(self, inp, node="logit", detach=False):
        """The `node` output of the clip `inp`.  The generator and the
        backbone each run inside a span with its stream time,
        `i3d.generator` and `i3d.backbone` (`utils.profiling.span`).
        Under `remat` the recompute runs in the backward, outside both
        spans, so a span's stream time holds the forward only."""
        if node == "D":
            return self.discriminator(inp)
        if self.gen_flow_model is not None:
            with span("i3d.generator", device=inp.device):
                inp = self.generate(inp)
        if node == "gen_flow":
            return inp
        with span("i3d.backbone", device=inp.device):
            logits = self.features_to_logits(inp.detach() if detach
                                             else inp)
        if node == "flow+logit":
            return logits, inp
        return logits


def get_symbol(name, modality="rgb", num_classes=51, arch_estimator=None,
               arch_d=None, input_size=224, dropout_prob=0.0, packed_gen=0,
               remat=False):
    """Factory and input config (reference network/symbol_builder.py:12-25,
    network/config.py:10-27: I3D mean = std = 0.5).  As the JAX
    package's, it passes `remat` and not `unroll_time`."""
    if name.upper() != "I3D":
        raise ValueError(f"unknown network {name!r}")
    net = I3D(num_classes=num_classes, modality=modality,
              arch_estimator=arch_estimator, arch_d=arch_d,
              input_size=input_size, dropout_prob=dropout_prob,
              packed_gen=packed_gen, remat=remat)
    return net, {"mean": [0.5, 0.5, 0.5], "std": [0.5, 0.5, 0.5]}
