"""Structured training-metrics export, JSON lines (counterpart of
`dmcnet_tpu/utils/metrics_log.py`).

`--metrics-jsonl PATH` appends one self-describing JSON object per log
event beside the reference-format stdout lines, so a collector can read a
run without parsing the print format.  Writes are line-buffered appends: a
crash loses at most the last line, and a resumed run keeps appending to the
same file.  The port trains on one card, so there is one writer.
"""

from __future__ import annotations

import json
import os
import time


class MetricsLogger:
    """Append-only JSONL writer; a None path makes it a no-op."""

    def __init__(self, path=None):
        self._f = None
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)),
                        exist_ok=True)
            self._f = open(path, "a", buffering=1)
        self._t0 = time.time()

    def log(self, kind, **fields):
        if self._f is None:
            return
        record = {"kind": kind, "wall_s": round(time.time() - self._t0, 3)}
        for k, v in fields.items():
            if hasattr(v, "item"):  # numpy scalars, 0-d tensors
                v = v.item()
            record[k] = v
        self._f.write(json.dumps(record) + "\n")

    def close(self):
        if self._f is not None:
            self._f.close()
            self._f = None
