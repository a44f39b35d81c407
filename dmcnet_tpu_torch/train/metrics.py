"""Host-side meters and composable metric lists (the port's copy of
`dmcnet_tpu/train/metrics.py`).

`AverageMeter` mirrors the reference (code/dmcnet/train.py:380-395);
`topk_accuracy` scores whole-video evaluation; `MetricList` and the
composable metrics mirror the I3D trainer's
(code/dmcnet_I3D/train/metric.py:11-133) with positional loss routing.
Inputs are numpy arrays or anything `np.asarray` reads (CPU tensors).
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


class EvalMetric:
    """Base metric: accumulates (sum, count) and reports the mean
    (reference train/metric.py:11-46)."""

    def __init__(self, name):
        self.name = name
        self.reset()

    def reset(self):
        self.sum_metric = 0.0
        self.num_inst = 0

    def update(self, preds, labels, losses):
        raise NotImplementedError

    def get(self):
        value = (self.sum_metric / self.num_inst if self.num_inst
                 else float("nan"))
        return self.name, value


class Loss(EvalMetric):
    """Tracks one positional loss (reference train/metric.py:119-133)."""

    def __init__(self, name="loss", loss_index=0):
        self.loss_index = loss_index
        super().__init__(name)

    def update(self, preds, labels, losses):
        del preds, labels
        self.sum_metric += float(np.asarray(losses[self.loss_index]).sum())
        self.num_inst += int(np.asarray(losses[self.loss_index]).size)


class Accuracy(EvalMetric):
    """Top-k accuracy over logits (reference train/metric.py:95-116)."""

    def __init__(self, name="acc", topk=1):
        self.topk = topk
        super().__init__(name)

    def update(self, preds, labels, losses):
        del losses
        preds = np.asarray(preds)
        labels = np.asarray(labels)
        ranks = np.argsort(-preds, axis=-1)[:, :self.topk]
        self.sum_metric += float((ranks == labels[:, None]).any(axis=-1).sum())
        self.num_inst += len(labels)


class MetricList:
    """Composable metric collection (reference train/metric.py:49-88)."""

    def __init__(self, *metrics):
        self.metrics = list(metrics)

    def reset(self):
        for m in self.metrics:
            m.reset()

    def update(self, preds, labels, losses):
        for m in self.metrics:
            m.update(preds, labels, losses)

    def get(self):
        return [m.get() for m in self.metrics]

    def format(self):
        return ", ".join(f"{n} = {v:.5f}" for n, v in self.get())
