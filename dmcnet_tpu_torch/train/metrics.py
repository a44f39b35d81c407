"""Host-side meters (the port's copy of the dmcnet part of
`dmcnet_tpu/train/metrics.py`; the I3D trainer's metric lists come with the
I3D slice).

`AverageMeter` mirrors the reference (code/dmcnet/train.py:380-395).
"""

from __future__ import annotations


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
