"""Host-side meters (the port's copy of part of
`dmcnet_tpu/train/metrics.py`; the I3D trainer's metric lists come with I3D
training).

`AverageMeter` mirrors the reference (code/dmcnet/train.py:380-395);
`topk_accuracy` scores whole-video evaluation.
"""

from __future__ import annotations

import numpy as np


def topk_accuracy(scores, labels, ks=(1,)):
    """NumPy top-k accuracy in percent over (N, C) scores."""
    scores = np.asarray(scores)
    labels = np.asarray(labels)
    ranks = np.argsort(-scores, axis=-1)
    return [100.0 * float(
        np.mean((ranks[:, :k] == labels[:, None]).any(axis=-1)))
        for k in ks]


class AverageMeter:
    """Stores current value and running average (reference
    train.py:380-395)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n=1):
        val = float(val)
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / self.count
