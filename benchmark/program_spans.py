"""Readers of the program's own spans (`dmcnet_tpu_torch.utils.profiling.
span`), which the port logs in memory while the harness's profiler runs.

`entries(run)` reads that log within the traced window.  `idle_by_stage`
puts each device idle stretch of the window on the serving stage open on
the host: a stage is a child span of `serving.request`, and idle under a
stage's own children (the generator and classifier inside
`serving.enqueue`) counts for the stage.  It labels the stretches with
`tracing.Trace`'s own `idle_gaps`, on a `Trace` built over the program's
spans.  Every reader returns None where the run has no such spans: no
trace, no device operation in it (the CPU), or a program that logs none.
"""

from __future__ import annotations

from benchmark.tracing import Trace

REQUEST = "serving.request"


def entries(run):
    """The program's span log entries inside the traced window (dicts:
    `name`, `start_ns`, `end_ns`, `index`, `parent`, `root`, `counts`,
    `device_ms`), or None."""
    if run.trace is None or not run.trace.busy:
        return None
    from dmcnet_tpu_torch.utils import profiling

    read = getattr(profiling, "read_spans", None)
    if read is None:
        return None
    return read(*run.trace.window) or None


def idle_by_stage(run):
    """{stage: idle seconds} over the window: each serving stage's, REQUEST
    for idle inside a request outside its stages, "host" outside every
    request; None without requests."""
    log = entries(run)
    requests = {e["index"] for e in log or () if e["name"] == REQUEST}
    if not requests:
        return None
    spans = [(e["name"], e["start_ns"], e["end_ns"]) for e in log
             if e["index"] in requests or e["parent"] in requests]
    trace = Trace(run.trace.device, spans, run.trace.window)
    return dict(trace.idle_gaps(n=None))


def idle_pct(run, *stages):
    """Device idle while one of `stages` is the open serving stage, as a
    share of the traced window."""
    idle = idle_by_stage(run)
    if idle is None:
        return None
    return 100.0 * sum(idle.get(s, 0.0) for s in stages) / run.trace.window_s


def stream_ms_per(run, name, counter):
    """Stream time of the `name` spans (their CUDA events) per unit of
    `counter`."""
    ms = [e["device_ms"] for e in entries(run) or ()
          if e["name"] == name and e["device_ms"] is not None]
    if not ms or not run.counters.get(counter):
        return None
    return sum(ms) / run.counters[counter]


def count_pct(run, name, part, whole):
    """100 x the sum of count `part` over the sum of count `whole` of the
    `name` spans."""
    log = [e["counts"] for e in entries(run) or () if e["name"] == name]
    total = sum(c.get(whole, 0) for c in log)
    if not total:
        return None
    return 100.0 * sum(c.get(part, 0) for c in log) / total
