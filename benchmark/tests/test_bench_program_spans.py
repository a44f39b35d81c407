"""The readers of the program's own spans (`benchmark/program_spans.py`)
on a hand-built trace and span log, and a traced run of each cell on the
CPU, where they have nothing to read."""

import pytest

from conftest import run_small

from benchmark import harness, program_spans
from benchmark.readers import idle_pct
from benchmark.tracing import Trace

NEW = {"serve.r18.batch8": ["idle_pack_pct.serve", "idle_copy_pct.serve",
                            "idle_launch_pct.serve", "generator_ms.serve",
                            "classifier_ms.serve"],
       "eval.i3d.clip250": ["h2d_kept_pct.eval", "generator_ms.eval",
                            "backbone_ms.eval"]}


def entry(index, name, a, b, parent=None, root=None, device_ms=None,
          **counts):
    return {"index": index, "name": name, "start_ns": a, "end_ns": b,
            "parent": parent, "root": index if root is None else root,
            "counts": counts, "device_ms": device_ms}


def request_log(r=0, t=0):
    """One request at [t + 10, t + 100] with its stages; the generator and
    classifier inside the enqueue."""
    k = lambda i: r + i  # noqa: E731
    return [entry(k(0), "serving.request", t + 10, t + 100),
            entry(k(1), "serving.gather", t + 10, t + 20, k(0), k(0)),
            entry(k(2), "serving.pack", t + 20, t + 30, k(0), k(0)),
            entry(k(3), "serving.h2d", t + 30, t + 40, k(0), k(0)),
            entry(k(4), "serving.enqueue", t + 40, t + 60, k(0), k(0)),
            entry(k(5), "serving.generator", t + 42, t + 50, k(4), k(0),
                  device_ms=1.5),
            entry(k(6), "serving.classifier", t + 50, t + 58, k(4), k(0),
                  device_ms=0.5),
            entry(k(7), "serving.readback", t + 60, t + 90, k(0), k(0)),
            entry(k(8), "serving.reduce", t + 90, t + 95, k(0), k(0))]


@pytest.fixture
def log(monkeypatch):
    """Sets the port's span log that the readers see."""
    from dmcnet_tpu_torch.utils import profiling

    held = []

    def read_spans(start_ns=None, end_ns=None):
        return [e for e in held if e["start_ns"] >= start_ns
                and e["end_ns"] <= end_ns]

    monkeypatch.setattr(profiling, "read_spans", read_spans)
    return held


def serve_run(busy=((45, 70),), window=(0, 120), requests=1):
    device = [("k", "kernel", a, b) for a, b in busy]
    return harness.Run(Trace(device, [], window), (window[1] - window[0])
                       * 1e-9, {"requests": requests, "videos": requests})


def test_idle_by_stage_splits_the_window(log):
    log += request_log()
    run = serve_run()
    # idle [0, 45] and [70, 120]: host 10, gather 10, pack 10, h2d 10,
    # enqueue 5 (under its generator 3 of them), readback 20, reduce 5,
    # the request outside its stages 5, host 20
    idle = program_spans.idle_by_stage(run)
    want = {"host": 30, "serving.gather": 10, "serving.pack": 10,
            "serving.h2d": 10, "serving.enqueue": 5, "serving.readback": 20,
            "serving.reduce": 5, "serving.request": 5}
    assert idle == pytest.approx({k: v * 1e-9 for k, v in want.items()})
    assert sum(idle.values()) / run.trace.window_s * 100 == \
        pytest.approx(idle_pct(run))
    for name, stage in [("idle_pack_pct.serve", 10),
                        ("idle_copy_pct.serve", 10),
                        ("idle_launch_pct.serve", 5)]:
        assert harness.load_reader(name)(run) == pytest.approx(
            100 * stage / 120)


def test_idle_outside_the_window_and_other_spans_left_out(log):
    """Entries outside the window are not read; a span with no request
    above it is no stage."""
    log += request_log() + request_log(r=9, t=200)
    log.append(entry(20, "serving.gather", 100, 110))
    run = serve_run()
    idle = program_spans.idle_by_stage(run)
    assert idle["host"] == pytest.approx(30e-9)
    assert set(idle) >= {"serving.pack", "serving.readback"}


def test_stream_time_per_unit(log):
    log += request_log() + request_log(r=9, t=100)
    log += [entry(30, "i3d.generator", 5, 8, device_ms=40.0),
            entry(31, "i3d.backbone", 8, 9, device_ms=60.0),
            entry(32, "i3d.generator", 205, 208, device_ms=40.0)]
    run = serve_run(window=(0, 220), requests=2)
    read = harness.load_reader
    assert read("generator_ms.serve")(run) == pytest.approx(1.5)
    assert read("classifier_ms.serve")(run) == pytest.approx(0.5)
    assert read("generator_ms.eval")(run) == pytest.approx(40.0)
    assert read("backbone_ms.eval")(run) == pytest.approx(30.0)


def test_h2d_kept_share(log):
    t, s, h, w, c = 250, 224, 360, 480, 7
    log += [entry(i, "data.i3d_h2d", 10 * i, 10 * i + 5, bytes=t * h * w * c,
                  kept=t * s * s * c) for i in range(3)]
    run = serve_run()
    assert harness.load_reader("h2d_kept_pct.eval")(run) == pytest.approx(
        100 * s * s / (h * w))


def test_none_where_nothing_is_recorded(log, monkeypatch):
    readers = [harness.load_reader(n) for names in NEW.values()
               for n in names]
    # no spans at all
    assert all(r(serve_run()) is None for r in readers)
    # spans without device events, a trace without device operations, no
    # trace, no counter
    log += request_log()
    for e in log:
        e["device_ms"] = None
    assert harness.load_reader("generator_ms.serve")(serve_run()) is None
    assert harness.load_reader("idle_pack_pct.serve")(serve_run()) \
        is not None
    assert all(r(serve_run(busy=())) is None for r in readers)
    no_trace = harness.Run(None, 1.0, {"requests": 1})
    assert all(r(no_trace) is None for r in readers)
    log[5]["device_ms"] = 1.0
    assert harness.load_reader("generator_ms.serve")(
        serve_run(requests=0)) is None
    # a program that logs no spans (before `read_spans` existed)
    from dmcnet_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "read_spans")
    assert all(r(serve_run()) is None for r in readers)


@pytest.mark.parametrize("cell", sorted(NEW))
def test_traced_cell_on_the_cpu(cell):
    """Still `correct` traced; no device operation here, so the new
    metrics are left out of the line."""
    r = run_small(cell, trace=1)
    assert r["correct"], r["checks"]
    assert not set(NEW[cell]) & set(r["metrics"])
