"""ResNet-18/34 classifier in torchvision's layout (counterpart of
`dmcnet_tpu/models/resnet.py:23-108`).

torchvision's BasicBlock graph, with the TSN surgeries of the reference
(code/dmcnet/model.py:283-299): a 2-channel stem conv (the generated cue)
and a `num_classes` head.  Key names match torchvision and the reference
checkpoints (`conv1`, `bn1`, `layer1.0.conv1`, `layer2.0.downsample.0`,
`fc`).  Stride-2 convs and the 3x3/2 max pool use torch's floor-mode
geometry, as the JAX package reproduces it.
"""

from __future__ import annotations

from torch import nn

from dmcnet_tpu_torch.models.layers import batch_norm


class BasicBlock(nn.Module):
    """3x3-BN-ReLU-3x3-BN + identity or 1x1/BN downsample, then ReLU."""

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


class ResNet(nn.Module):
    """BasicBlock ResNet; returns logits.  torchvision's initialisation
    (Kaiming-normal fan-out convs, unit BN) so randomly initialised models
    keep O(1) activations."""

    def __init__(self, num_classes, stage_sizes=(2, 2, 2, 2),
                 widths=(64, 128, 256, 512), in_channels=2):
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
                blocks.append(BasicBlock(c, w, 2 if stage and not b else 1))
                c = w
            self.add_module(f"layer{stage + 1}", nn.Sequential(*blocks))
        self.n_stages = len(stage_sizes)
        self.avgpool = nn.AdaptiveAvgPool2d(1)
        self.fc = nn.Linear(c, num_classes)
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                nn.init.kaiming_normal_(m.weight, mode="fan_out",
                                        nonlinearity="relu")

    def forward(self, x):
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        for stage in range(self.n_stages):
            x = getattr(self, f"layer{stage + 1}")(x)
        return self.fc(self.avgpool(x).flatten(1))


def resnet18(num_classes, in_channels=2):
    return ResNet(num_classes, (2, 2, 2, 2), in_channels=in_channels)


def resnet34(num_classes, in_channels=2):
    return ResNet(num_classes, (3, 4, 6, 3), in_channels=in_channels)
