#!/usr/bin/env python3
"""Rates of a serving GOP chunk's way to the card, fresh against staged:

    python3 tools/serve_staging_rates.py [--gops 64] [--repeat 10]

on a chunk of `--gops` GOP rows at 256x320, 12 frames, 16-pixel cells and
3 picked 224x224 frames a GOP (46.6 MB at 64 GOPs), prints one JSON line
with the card's name and power limit and, each the median over `--repeat`
runs:

  * `pack_fresh_ms`: `DMCPredictor._pack_rows`, fresh arrays;
  * `fill_ms`: `DMCPredictor._fill_rows` into reused pinned views, the
    staged route's fill;
  * `pinned_copy_ms`: the `non_blocking` copies of those views (CUDA
    events), with `pinned_GBps`;
  * `fresh_ms` / `staged_ms`: `_pack_rows` + `_to_device` against
    `DMCPredictor._stage`, call to a synchronize.

Run from the root of a checkout, on a card."""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from dmcnet_tpu_torch.serving import DMCPredictor  # noqa: E402

H, W, T, CELL, PICKS, SIZE = 256, 320, 12, 16, 3, 224


def median_ms(fn, repeat):
    times = []
    for _ in range(repeat):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times) * 1e3


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--gops", type=int, default=64)
    ap.add_argument("--repeat", type=int, default=10)
    args = ap.parse_args()
    n, rep = args.gops, args.repeat
    rng = np.random.default_rng(0)
    rows = [(rng.integers(-32, 33, (T, H // CELL, W // CELL, 2),
                          dtype=np.int32), CELL,
             rng.integers(0, 256, (H, W, 3), dtype=np.uint8),
             rng.integers(0, 256, (PICKS, SIZE, SIZE, 3), dtype=np.uint8),
             np.array([1, 6, 11])) for _ in range(n)]
    pred = DMCPredictor(num_class=51, input_size=SIZE, device="cuda")
    dev = pred.device
    specs = pred._row_specs(T, H, W, CELL, PICKS)
    views = [torch.empty((n,) + s, dtype=dt, pin_memory=True)
             for s, dt, _ in specs]
    outs = [torch.empty((n,) + s, dtype=dt, device=dev)
            for s, dt, _ in specs]
    nbytes = sum(v.nbytes for v in views)
    host = [v.numpy() for v in views]

    start, end = torch.cuda.Event(True), torch.cuda.Event(True)
    dma = []
    for _ in range(rep):
        start.record()
        for o, v in zip(outs, views):
            o.copy_(v, non_blocking=True)
        end.record()
        end.synchronize()
        dma.append(start.elapsed_time(end))

    def stage():
        return pred._stage(rows, n, T, H, W, CELL, PICKS, dev)

    stage()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(json.dumps({
        "card": card.strip(), "cpus": os.cpu_count(), "gops": n,
        "chunk_MB": nbytes / 1e6,
        "pack_fresh_ms": median_ms(lambda: pred._pack_rows(
            rows, n, T, H, W, CELL, PICKS), rep),
        "fill_ms": median_ms(lambda: pred._fill_rows(host, rows, CELL), rep),
        "pinned_copy_ms": statistics.median(dma),
        "pinned_GBps": nbytes / statistics.median(dma) / 1e6,
        "fresh_ms": median_ms(lambda: pred._to_device(pred._pack_rows(
            rows, n, T, H, W, CELL, PICKS), dev), rep),
        "staged_ms": median_ms(stage, rep)}))


if __name__ == "__main__":
    main()
