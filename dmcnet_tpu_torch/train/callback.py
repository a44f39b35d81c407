"""Step-frequency training callbacks (the port's copy of
`dmcnet_tpu/train/callback.py`, which imports no JAX).

Mirrors the reference code/dmcnet_I3D/train/callback.py:27-121:
`CallbackList` composition, `SpeedMonitor` (samples/sec with optional
update-time share), `MetricPrinter`.
"""

from __future__ import annotations

import logging
import time


class Callback:
    def __call__(self, **kwargs):
        raise NotImplementedError


class CallbackList(Callback):
    def __init__(self, *callbacks, with_header=True):
        self.callbacks = [c for c in callbacks if c is not None]
        self.with_header = with_header

    def __call__(self, epoch=None, batch=None, silent=False, **kwargs):
        header = ""
        if self.with_header:
            if epoch is not None:
                header += f"Epoch[{epoch}]"
                if batch is not None:
                    header += f" Batch [{batch}]"
        lines = [cb(**kwargs) for cb in self.callbacks]
        msg = header + "\t" + "  ".join(str(x) for x in lines if x)
        if not silent:
            logging.info(msg)
        return msg


class SpeedMonitor(Callback):
    """samples/sec (+ optional fraction of time in the optimizer update)."""

    def __init__(self, with_header=False):
        self.with_header = with_header

    def __call__(self, sample_elapse=None, update_elapse=None,
                 sample_inst=None, **kwargs):
        if sample_elapse is None or not sample_inst:
            return ""
        speed = sample_inst / sample_elapse
        msg = f"Speed: {speed:.2f} samples/sec"
        if update_elapse is not None:
            msg += f" ({100. * update_elapse / sample_elapse:.1f}% update)"
        return msg


class MetricPrinter(Callback):
    def __call__(self, namevals=None, **kwargs):
        if not namevals:
            return ""
        return "  ".join(f"{name} = {value:.5f}"
                         for name, value in namevals)


class TimerDict:
    """Tiny helper for accumulating section timings."""

    def __init__(self):
        self.t = {}
        self._starts = {}

    def tic(self, name):
        self._starts[name] = time.time()

    def toc(self, name):
        self.t[name] = self.t.get(name, 0.0) + time.time() - \
            self._starts.pop(name)
        return self.t[name]
