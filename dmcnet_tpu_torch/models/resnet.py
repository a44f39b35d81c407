"""ResNet classifiers in torchvision's layout: ResNet-18/34 (counterpart of
`dmcnet_tpu/models/resnet.py:23-108`) and the bottleneck ResNet-50/101/152
(He et al., arXiv 1512.03385; torchvision's "v1.5" graph, the stride on
the 3x3 conv), which CoViAR's I-frame TSN runs (`--arch resnet152`).

torchvision's graphs, with the TSN surgeries of the reference
(code/dmcnet/model.py:283-299): a stem conv of the modality's channels (2
for the generated cue) and a `num_classes` head.  Key names match
torchvision and the reference checkpoints (`conv1`, `bn1`,
`layer1.0.conv1`, `layer1.0.conv3`, `layer2.0.downsample.0`, `fc`).
Stride-2 convs and the 3x3/2 max pool use torch's floor-mode geometry, as
the JAX package reproduces it.  Each stage runs inside the span
`resnet.layer<k>` (`utils.profiling.span`, with its stream time, its
`blocks` and how many of them were `fused`).

In inference (eval mode, grad off, float32 weights, no autocast) a
bottleneck ResNet runs channels_last, and each of its convolutions is
followed by one pass of `ops.bn_epilogue` in place of the BatchNorm,
residual add and ReLU that follow it: the same modules and weights, each
BatchNorm a per-channel scale and shift from its running statistics, in
fewer passes over device memory.  Training, grad-enabled, autocast and
non-float32 forwards and BasicBlock ResNets run the modules one by one.
"""

from __future__ import annotations

import torch
from torch import nn

from dmcnet_tpu_torch.models.layers import batch_norm
from dmcnet_tpu_torch.ops.bn_epilogue import bn_epilogue
from dmcnet_tpu_torch.utils.profiling import span


def fuses(block):
    """True when `block` (a Bottleneck) runs its BatchNorms, add and ReLUs
    as epilogue passes: in eval mode with grad off, its weights float32
    on the CPU or a card and autocast off there, so that each
    convolution's output is the float32 tensor the epilogue takes."""
    if not isinstance(block, Bottleneck) or block.training \
            or torch.is_grad_enabled():
        return False
    w = block.conv1.weight
    return w.dtype == torch.float32 and w.device.type in ("cpu", "cuda") \
        and not torch.is_autocast_enabled(w.device.type)


class BasicBlock(nn.Module):
    """3x3-BN-ReLU-3x3-BN + identity or 1x1/BN downsample, then ReLU."""

    expansion = 1

    def __init__(self, c_in, features, stride=1):
        super().__init__()
        self.conv1 = nn.Conv2d(c_in, features, 3, stride, 1, bias=False)
        self.bn1 = batch_norm(features)
        self.relu = nn.ReLU(inplace=True)
        self.conv2 = nn.Conv2d(features, features, 3, 1, 1, bias=False)
        self.bn2 = batch_norm(features)
        self.downsample = None
        if stride != 1 or c_in != features:
            self.downsample = nn.Sequential(
                nn.Conv2d(c_in, features, 1, stride, bias=False),
                batch_norm(features))

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        y = self.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        return self.relu(y + identity)


class Bottleneck(nn.Module):
    """1x1-BN-ReLU, 3x3 (the block's stride)-BN-ReLU, 1x1 to 4 x `features`
    -BN, + identity or 1x1/BN downsample (with the stride), then ReLU."""

    expansion = 4

    def __init__(self, c_in, features, stride=1):
        super().__init__()
        c_out = features * self.expansion
        self.conv1 = nn.Conv2d(c_in, features, 1, bias=False)
        self.bn1 = batch_norm(features)
        self.conv2 = nn.Conv2d(features, features, 3, stride, 1, bias=False)
        self.bn2 = batch_norm(features)
        self.conv3 = nn.Conv2d(features, c_out, 1, bias=False)
        self.bn3 = batch_norm(c_out)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = None
        if stride != 1 or c_in != c_out:
            self.downsample = nn.Sequential(
                nn.Conv2d(c_in, c_out, 1, stride, bias=False),
                batch_norm(c_out))

    def forward(self, x):
        if fuses(self):
            return self._fused(x)
        identity = x if self.downsample is None else self.downsample(x)
        y = self.relu(self.bn1(self.conv1(x)))
        y = self.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        return self.relu(y + identity)

    def _fused(self, x):
        """The inference forward: each convolution then one epilogue pass,
        the downsample's BatchNorm folded into the last one's."""
        x = x.contiguous(memory_format=torch.channels_last)
        y = bn_epilogue(self.conv1(x), self.bn1)
        y = bn_epilogue(self.conv2(y), self.bn2)
        if self.downsample is None:
            return bn_epilogue(self.conv3(y), self.bn3, x)
        conv, bn = self.downsample
        return bn_epilogue(self.conv3(y), self.bn3, conv(x), bn)


class ResNet(nn.Module):
    """ResNet of `block`s (BasicBlock or Bottleneck); returns logits.
    torchvision's initialisation (Kaiming-normal fan-out convs, unit BN) so
    randomly initialised models keep O(1) activations."""

    def __init__(self, num_classes, stage_sizes=(2, 2, 2, 2),
                 widths=(64, 128, 256, 512), in_channels=2,
                 block=BasicBlock):
        super().__init__()
        self.conv1 = nn.Conv2d(in_channels, 64, 7, 2, 3, bias=False)
        self.bn1 = batch_norm(64)
        self.relu = nn.ReLU(inplace=True)
        self.maxpool = nn.MaxPool2d(3, 2, 1)
        c = 64
        for stage, (n, w) in enumerate(zip(stage_sizes, widths)):
            blocks = []
            for b in range(n):
                # first block of every non-first stage strides 2
                blocks.append(block(c, w, 2 if stage and not b else 1))
                c = w * block.expansion
            self.add_module(f"layer{stage + 1}", nn.Sequential(*blocks))
        self.n_stages = len(stage_sizes)
        self.avgpool = nn.AdaptiveAvgPool2d(1)
        self.fc = nn.Linear(c, num_classes)
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                nn.init.kaiming_normal_(m.weight, mode="fan_out",
                                        nonlinearity="relu")

    def forward(self, x):
        if fuses(self.layer1[0]):
            x = x.contiguous(memory_format=torch.channels_last)
            x = self.maxpool(bn_epilogue(self.conv1(x), self.bn1))
        else:
            x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        for stage in range(self.n_stages):
            layer = getattr(self, f"layer{stage + 1}")
            with span(f"resnet.layer{stage + 1}", device=x.device,
                      blocks=len(layer), fused=sum(map(fuses, layer))):
                x = layer(x)
        return self.fc(self.avgpool(x).flatten(1))


def resnet18(num_classes, in_channels=2):
    return ResNet(num_classes, (2, 2, 2, 2), in_channels=in_channels)


def resnet34(num_classes, in_channels=2):
    return ResNet(num_classes, (3, 4, 6, 3), in_channels=in_channels)


def resnet50(num_classes, in_channels=2):
    return ResNet(num_classes, (3, 4, 6, 3), in_channels=in_channels,
                  block=Bottleneck)


def resnet101(num_classes, in_channels=2):
    return ResNet(num_classes, (3, 4, 23, 3), in_channels=in_channels,
                  block=Bottleneck)


def resnet152(num_classes, in_channels=2):
    return ResNet(num_classes, (3, 8, 36, 3), in_channels=in_channels,
                  block=Bottleneck)
