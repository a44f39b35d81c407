"""Adversarial discriminators (counterpart of
`dmcnet_tpu/models/discriminators.py`).

Architectures of reference dmcnet_GAN/model.py:254-438: stacks of blocks
[conv3x3 (stride 2 to downsample, stride 1 to deepen) + LeakyReLU(0.2) +
Dropout2d(0.25) + BatchNorm] ending in a 2-logit `Linear` over the
flattened NCHW map (real/fake as a 2-class problem).  The first block has no
BN.  In train mode `Dropout2d` drops whole channels, as the JAX package's
`Dropout(broadcast_dims=(1, 2))` does on NHWC, and BN normalizes by the
batch's statistics.  The reference's `nn.BatchNorm2d(out, 0.8)` sets **eps = 0.8** (the
positional argument), a quirk kept so reference checkpoints score the same.

Module names are the reference keys (`dmcnet_tpu/models/import_torch.py:
131-146`): stage s (from 1) downsamples in `discriminator_block_{s}` and
deepens in `discriminator_block_{s}_{k}`, k = 2..depth; in each block the
conv is `.0` and the BN `.3`; the head is `adv_layer`.  The head's width
depends on the input size, so a discriminator is built for one
`input_size`.
"""

from __future__ import annotations

from torch import nn

from dmcnet_tpu_torch.models.layers import BN_MOMENTUM, conv3x3

_D_BN_EPS = 0.8  # reference dmcnet_GAN/model.py:263: eps, not momentum


def _block(c_in, c_out, stride, use_bn=True):
    layers = [conv3x3(c_in, c_out, stride=stride), nn.LeakyReLU(0.2),
              nn.Dropout2d(0.25)]
    if use_bn:
        layers.append(nn.BatchNorm2d(c_out, eps=_D_BN_EPS,
                                     momentum=BN_MOMENTUM))
    return nn.Sequential(*layers)


class _Discriminator(nn.Module):
    """`depth` blocks per stage (one stride-2, then stride-1 ones);
    `widths` are the stages' channel counts.  (N, in_channels, S, S) ->
    (N, 2) logits, S = `input_size`."""

    widths = (16, 32, 64, 128)
    depth = 1

    def __init__(self, input_size=224, in_channels=2):
        super().__init__()
        c, size = in_channels, input_size
        for s, w in enumerate(self.widths, start=1):
            self.add_module(f"discriminator_block_{s}",
                            _block(c, w, 2, use_bn=s > 1))
            for k in range(2, self.depth + 1):
                self.add_module(f"discriminator_block_{s}_{k}",
                                _block(w, w, 1))
            c, size = w, (size - 1) // 2 + 1  # conv3x3, pad 1, stride 2
        self.adv_layer = nn.Linear(c * size * size, 2)

    def forward(self, x):
        for s in range(1, len(self.widths) + 1):
            x = getattr(self, f"discriminator_block_{s}")(x)
            for k in range(2, self.depth + 1):
                x = getattr(self, f"discriminator_block_{s}_{k}")(x)
        return self.adv_layer(x.flatten(1))


class Discriminator(_Discriminator):
    pass


class Discriminator2(_Discriminator):
    depth = 2


class Discriminator3(_Discriminator):
    depth = 3


class Discriminator4(_Discriminator):
    widths = (8, 16, 32)


class Discriminator5(_Discriminator):
    depth = 5


_DISCRIMINATORS = {
    "Discriminator": Discriminator,
    "Discriminator2": Discriminator2,
    "Discriminator3": Discriminator3,
    "Discriminator4": Discriminator4,
    "Discriminator5": Discriminator5,
}


def make_discriminator(arch_d, input_size=224):
    try:
        cls = _DISCRIMINATORS[arch_d]
    except KeyError:
        raise ValueError(f"unknown arch_d {arch_d!r}") from None
    return cls(input_size=input_size)
