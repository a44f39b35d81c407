#!/usr/bin/env python3
"""One traced benchmark run with an audit of the program's own spans:

    python3 tools/span_audit.py --workload <cell> --seed <n> --seconds 20

runs the cell as `benchmark/run.py --trace 1` does and prints its result
line, then one JSON line {"span_audit": ...}:

  * `idle_pct` of the window and, in a serving cell, `idle_pct_by_stage`:
    the card's idle time by the serving stage open on the host
    (`benchmark/program_spans.idle_by_stage`; `host` outside every
    request, `serving.request` inside one outside its stages), as shares
    of the window, with `stages_and_host`, the six stages and `host`
    summed, and `request_idle_after`: the idle inside a request outside
    its stages, by the stage that closed last before it ("start" before
    the first);
  * `stream_ms_per_unit`: each device span's stream time per request or
    video, beside `window_ms_per_unit`;
  * `counts_in_window`: the least and the most of each count of each span
    in the window (`pinned` of `data.i3d_h2d` says which copy route ran),
    and `host_ms_per_unit`: each span's host time in the window per unit;
  * the clock: each span-log entry against its own `dmc.*` kineto event
    (matched by name, in order): `outside_us`, the most any entry stands
    outside its event (0 when every entry lies inside), and `inside_us`,
    the most, the 99th percentile and the median by which its stamps lie
    inside.

Run from the root of a checkout, on a card; the audit only reads what the
traced run recorded."""

import bisect
import json
import os
import statistics
import sys
import time

T0 = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

STAGES = ("serving.gather", "serving.pack", "serving.h2d", "serving.enqueue",
          "serving.readback", "serving.reduce")


def clock_gaps(log, events):
    """{"outside_us", "inside_us": [max, p99, median], "matched"} of the log
    entries against the kineto events [(name, start_ns, end_ns)] of the
    same spans."""
    by_name = {}
    for name, a, b in sorted(events, key=lambda ev: ev[1]):
        by_name.setdefault(name, []).append((a, b))
    outside, inside, matched = 0, [], 0
    for name, evs in by_name.items():
        mine = [e for e in log if e["name"] == name]
        if len(mine) != len(evs):
            raise RuntimeError(f"{name}: {len(mine)} log entries against "
                               f"{len(evs)} kineto events")
        for e, (a, b) in zip(mine, evs):
            outside = max(outside, a - e["start_ns"], e["end_ns"] - b)
            inside += [e["start_ns"] - a, b - e["end_ns"]]
            matched += 1
    if matched != len(log):
        raise RuntimeError(f"{len(log) - matched} log entries have no event")
    inside = sorted(max(x, 0) for x in inside) or [0]
    return {"outside_us": outside * 1e-3, "matched": matched,
            "inside_us": [inside[-1] * 1e-3,
                          inside[int(0.99 * (len(inside) - 1))] * 1e-3,
                          statistics.median(inside) * 1e-3]}


def request_idle_after(run, log):
    """{stage: seconds} of the card's idle time inside a request but
    outside its stages, by the stage that closed last before it."""
    w0, w1 = run.trace.window
    gaps, cur = [], w0
    for a, b in run.trace.busy:
        if a > cur:
            gaps.append((cur, a))
        cur = max(cur, b)
    if cur < w1:
        gaps.append((cur, w1))
    ends = [b for _, b in gaps]
    requests = {e["index"]: e for e in log if e["name"] == "serving.request"}
    stages = {}
    for e in log:
        if e["parent"] in requests:
            stages.setdefault(e["parent"], []).append(e)
    out = {}
    for r, req in requests.items():
        cur, label, pieces = req["start_ns"], "start", []
        for k in sorted(stages.get(r, []), key=lambda e: e["start_ns"]):
            pieces.append((cur, k["start_ns"], label))
            cur, label = k["end_ns"], k["name"]
        pieces.append((cur, req["end_ns"], label))
        for a, b, label in pieces:
            j = bisect.bisect_right(ends, a)
            while j < len(gaps) and gaps[j][0] < b:
                cut = min(b, gaps[j][1]) - max(a, gaps[j][0])
                if cut > 0:
                    out[label] = out.get(label, 0) + cut * 1e-9
                j += 1
    return out


def audit(run, events):
    from benchmark import program_spans, readers
    from dmcnet_tpu_torch.utils.profiling import read_spans

    log = read_spans()
    units = run.counters.get("requests") or run.counters.get("videos")
    out = {"entries": len(log), "window_s": run.trace.window_s,
           "idle_pct": readers.idle_pct(run),
           "window_ms_per_unit": run.trace.window_s * 1e3 / units}
    idle = program_spans.idle_by_stage(run)
    if idle is not None:
        share = {k: 100.0 * v / run.trace.window_s for k, v in idle.items()}
        out["idle_pct_by_stage"] = share
        out["stages_and_host"] = sum(share.get(k, 0.0)
                                     for k in STAGES + ("host",))
        out["request_idle_after"] = {
            k: 100.0 * v / run.trace.window_s
            for k, v in request_idle_after(run, log).items()}
    stream = {}
    for e in log:
        if e["device_ms"] is not None:
            stream[e["name"]] = stream.get(e["name"], 0.0) + e["device_ms"]
    out["stream_ms_per_unit"] = {k: v / units for k, v in stream.items()}
    counts, host = {}, {}
    for e in read_spans(*run.trace.window):
        host[e["name"]] = host.get(e["name"], 0.0) + \
            (e["end_ns"] - e["start_ns"]) * 1e-6
        for k, v in e["counts"].items():
            lo, hi = counts.setdefault(e["name"], {}).get(k, (v, v))
            counts[e["name"]][k] = [min(lo, v), max(hi, v)]
    out["counts_in_window"] = counts
    out["host_ms_per_unit"] = {k: v / units for k, v in host.items()}
    out["clock"] = clock_gaps(log, events)
    return out


def main(argv):
    import importlib

    run_py = importlib.import_module("benchmark.run")  # its cache dirs
    from benchmark import harness, tracing

    args = run_py.parse(argv)
    args.trace = 1
    events, runs = [], []
    from_events = tracing.Trace.from_events.__func__

    def keep_events(cls, evs):
        evs = list(evs)
        events.extend((e.name()[4:], e.start_ns(),
                       e.start_ns() + e.duration_ns()) for e in evs
                      if tracing._kind(e) == "user_annotation"
                      and e.name().startswith("dmc."))
        return from_events(cls, evs)

    class Run(harness.Run):
        def __init__(self, *a):
            super().__init__(*a)
            runs.append(self)

    tracing.Trace.from_events = classmethod(keep_events)
    harness.Run = Run
    rc = harness.main(args, T0)
    if rc:
        return rc
    print(json.dumps({"span_audit": audit(runs[0], events)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
