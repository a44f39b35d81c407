"""Profiling and timing helpers on `torch.profiler` (counterpart of
`dmcnet_tpu/utils/profiling.py`):

    with trace("/tmp/prof") as prof:  # Chrome trace JSON in /tmp/prof
        for batch in batches:
            step(batch)
            prof.step()               # ProfilerStep#k around each step

    with step_timer(sync=x) as t:     # waits for x's device at the end
        out = model(x)
    print(t.elapsed)

`start_trace` / `stop_trace` are the two halves of `trace` for a window
that opens and closes inside a loop (`cli/train.py --profile-dir`).  The
trace is viewable in Perfetto or chrome://tracing.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch
from torch.profiler import ProfilerAction, ProfilerActivity, profile


def start_trace(device=None, first_step=0):
    """A running `torch.profiler.profile` of CPU activity, plus CUDA
    activity when `device` is a card (None: when CUDA is available).  Each
    `prof.step()` closes one `ProfilerStep#k` span and opens the next; the
    first is numbered `first_step`."""
    if device is None:
        cuda = torch.cuda.is_available()
    else:
        cuda = torch.device(device).type == "cuda"
    activities = [ProfilerActivity.CPU] + \
        ([ProfilerActivity.CUDA] if cuda else [])
    # a schedule that always records: the caller's window decides
    prof = profile(activities=activities,
                   schedule=lambda step: ProfilerAction.RECORD)
    prof.step_num = first_step
    prof.start()
    return prof


def stop_trace(prof, logdir):
    """Stop `prof` and write its Chrome trace into `logdir` (made if
    missing); returns the file's path."""
    prof.stop()
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    return path


@contextlib.contextmanager
def trace(logdir, device=None):
    """`start_trace` over the block, `stop_trace` into `logdir` after it;
    yields the profiler, whose `trace_path` names the file afterwards."""
    prof = start_trace(device)
    try:
        yield prof
    finally:
        prof.trace_path = stop_trace(prof, logdir)


class _Timer:
    elapsed = 0.0


@contextlib.contextmanager
def step_timer(sync=None):
    """Wall-clock timer whose stop waits for the devices of `sync`'s tensors
    (a tensor or a nested list, tuple or dict of them, given on entry: the
    work queued on their devices inside the block), so that CUDA's
    asynchronous launches do not fake the number."""
    t = _Timer()
    start = time.perf_counter()
    try:
        yield t
    finally:
        for dev in {x.device for x in _tensors(sync)}:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        t.elapsed = time.perf_counter() - start


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def annotate(name):
    """Named span on the profiler's timeline."""
    return torch.profiler.record_function(name)
