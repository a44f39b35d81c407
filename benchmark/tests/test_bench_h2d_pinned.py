"""The reader of `h2d_pinned_pct.serve` (`metrics/h2d_pinned_pct.serve.py`)
on hand-built span logs: the share of the `serving.h2d` spans' `bytes`
sent from pinned staging, and nothing where a program logs no such counts
or a run has no trace."""

import pytest

from benchmark import harness
from benchmark.tracing import Trace

READER = "h2d_pinned_pct.serve"


def entry(index, name, a, b, **counts):
    return {"index": index, "name": name, "start_ns": a, "end_ns": b,
            "parent": None, "root": index, "counts": counts,
            "device_ms": None}


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


def serve_run(busy=((45, 70),), window=(0, 120)):
    device = [("k", "kernel", a, b) for a, b in busy]
    return harness.Run(Trace(device, [], window),
                       (window[1] - window[0]) * 1e-9, {"requests": 1})


def test_share_of_bytes_sent_pinned(log):
    """Two chunks sent from pinned staging and a host-path copy that was
    not; another span's counts are not read; spans outside the window
    are not read."""
    log += [entry(0, "serving.h2d", 10, 15, bytes=300, pinned_bytes=300),
            entry(1, "serving.h2d", 20, 25, bytes=100, pinned_bytes=100),
            entry(2, "serving.h2d", 30, 35, bytes=200, pinned_bytes=0),
            entry(3, "data.i3d_h2d", 40, 45, bytes=900, pinned=1),
            entry(4, "serving.h2d", 200, 210, bytes=900, pinned_bytes=0)]
    read = harness.load_reader(READER)
    assert read(serve_run()) == pytest.approx(100 * 400 / 600)
    del log[2]
    assert read(serve_run()) == pytest.approx(100.0)


def test_none_without_the_counts(log, monkeypatch):
    """A parent's spans carry no counts; a run without device operations
    or without a trace has nothing to read."""
    read = harness.load_reader(READER)
    assert read(serve_run()) is None
    log += [entry(0, "serving.h2d", 10, 15), entry(1, "serving.pack", 5, 9)]
    assert read(serve_run()) is None
    log[0]["counts"] = {"bytes": 300, "pinned_bytes": 300}
    assert read(serve_run(busy=())) is None
    assert read(harness.Run(None, 1.0, {"requests": 1})) is None
    from dmcnet_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "read_spans")
    assert read(serve_run()) is None
