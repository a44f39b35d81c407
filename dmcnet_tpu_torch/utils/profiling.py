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

`span` is the port's one way to mark a stage of its own work:

    with span("serving.pack"):             # "dmc.serving.pack" in a trace
        arrays = pack(rows)
    with span("i3d.backbone", device=x.device):   # + its stream time
        logits = backbone(x)

It records only while a profiler runs; `read_spans` reads its log.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import os
import threading
import time

import torch
import torch.autograd.profiler as _profiler
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


class _Entry:
    """One span of the log: `index` (its place in the log's order),
    `name`, `start_ns` / `end_ns` (unix-epoch nanoseconds, the clock of
    kineto's events; `end_ns` None while open), `parent` (the index of
    the span open around it on its thread, None at a root), `root` (the
    index of its root span), `counts`, and the CUDA events at entry and
    exit (None without a card)."""

    __slots__ = ("index", "name", "start_ns", "end_ns", "parent", "root",
                 "counts", "events")


class _Span:
    __slots__ = ("_name", "_device", "_counts", "_range", "_entry",
                 "_stream")

    def __init__(self, name, device, counts):
        self._name, self._device, self._counts = name, device, counts

    def __enter__(self):
        self._range = torch.profiler.record_function("dmc." + self._name)
        self._range.__enter__()
        # stamped first, so that the entry lies inside its kineto event
        # by as little as the range's own call
        start_ns = time.time_ns()
        e = _Entry()
        e.start_ns = start_ns
        stack = _stack()
        e.index = next(_INDEX)
        e.name, e.counts, e.end_ns = self._name, self._counts, None
        e.parent = stack[-1].index if stack else None
        e.root = stack[0].index if stack else e.index
        e.events = None
        if self._device is not None and \
                torch.device(self._device).type == "cuda":
            self._stream = torch.cuda.current_stream(self._device)
            e.events = (torch.cuda.Event(enable_timing=True),
                        torch.cuda.Event(enable_timing=True))
            e.events[0].record(self._stream)
        stack.append(e)
        _LOG.append(e)
        self._entry = e

    def __exit__(self, *exc):
        e = self._entry
        if e.events is not None:
            e.events[1].record(self._stream)
        _stack().pop()
        e.end_ns = time.time_ns()
        self._range.__exit__(*exc)
        return False


def _stack():
    stack = getattr(_THREAD, "stack", None)
    if stack is None:
        stack = _THREAD.stack = []
    return stack


LOG_SIZE = 1 << 18
_LOG = collections.deque(maxlen=LOG_SIZE)
_INDEX = itertools.count()
_THREAD = threading.local()
_OFF = contextlib.nullcontext()


def span(name, device=None, **counts):
    """The port's span: a context manager around one stage of its work.

    While a `torch.profiler` runs in the process (the benchmark's traced
    run, `cli.train --profile-dir`, an operator's own), it opens
    `record_function("dmc." + name)` and logs the span in memory (the
    last `LOG_SIZE`): its start and end on the clock of kineto's events,
    both stamped inside the range, the index of the span open around it on
    this thread and of that thread's root span (a span opened on another
    thread starts a root of its own), and `counts`.  With `device` a CUDA
    device it also records a CUDA event on the device's current stream at
    entry and at exit; it never synchronizes, and the stream time between
    the two is resolved only when the log is read (`read_spans`).  With no
    profiler running it checks one flag and returns a shared no-op
    context."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, device, counts)


def read_spans(start_ns=None, end_ns=None):
    """The closed spans of the log that lie within [start_ns, end_ns]
    (either None: unbounded), in the order they opened, as dicts of
    `_Entry`'s fields with `device_ms`, the stream time between the
    span's CUDA events (None without them) in place of the events.  Read
    after the device has finished the spans' work: it waits for each end
    event."""
    out = []
    for e in list(_LOG):
        if e.end_ns is None or (start_ns is not None
                                and e.start_ns < start_ns) \
                or (end_ns is not None and e.end_ns > end_ns):
            continue
        ms = None
        if e.events is not None:
            e.events[1].synchronize()
            ms = e.events[0].elapsed_time(e.events[1])
        out.append({"index": e.index, "name": e.name,
                    "start_ns": e.start_ns, "end_ns": e.end_ns,
                    "parent": e.parent, "root": e.root,
                    "counts": dict(e.counts), "device_ms": ms})
    return out
