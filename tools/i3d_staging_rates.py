#!/usr/bin/env python3
"""Rates of the I3D clip's copy to the card, one stage at a time:

    python3 tools/i3d_staging_rates.py [--frames 250] [--repeat 8] \
        [--slabs 2 4 8]

on u8 clips of (1, frames, 360, 480, 7), centre crop 224, prints one JSON
line with the card's name and power limit and, each the median over
`--repeat` runs on two clips in turn:

  * `pin_alloc_ms`: the first pinned allocation of the box's size;
  * `fill_torch_GBps` / `fill_numpy_GBps`: the host's fill of the crop's box
    (`transforms.crop_box`) into a pinned buffer by torch's `copy_` and by
    numpy's `copyto`;
  * `dma_pinned_GBps`: the box's `non_blocking` copy from the pinned buffer
    (CUDA events);
  * `pageable_whole_GBps`: the whole clip copied pageably, as the program
    did before it copied only the box (host clock to a synchronize);
  * `serial_ms` and `slabs_ms`: fill then copy of the box, against the box
    cut into slabs along time, slab k's copy queued while slab k+1 fills;
  * `augment_ms`: `data.video_iter.i3d_augment_batch` on the card, call to
    a synchronize.

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

from dmcnet_tpu_torch.data import transforms as T  # noqa: E402
from dmcnet_tpu_torch.data.video_iter import i3d_augment_batch  # noqa: E402

H, W, C, SIZE = 360, 480, 7, 224


def median_s(fn, repeat):
    times = []
    for i in range(repeat):
        t0 = time.perf_counter()
        fn(i)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=250)
    ap.add_argument("--repeat", type=int, default=8)
    ap.add_argument("--slabs", type=int, nargs="+", default=[2, 4, 8])
    args = ap.parse_args()
    dev = torch.device("cuda")
    clips = [torch.randint(0, 256, (1, args.frames, H, W, C), device=dev,
                           dtype=torch.uint8).cpu().numpy() for _ in range(2)]
    oh, ow = (H - SIZE) // 2, (W - SIZE) // 2
    scales = np.ones((1, 2), np.float32)
    trans = np.asarray([[-oh, -ow]], np.float32)
    y0, y1, x0, x1 = T.crop_box(scales, trans, SIZE, H, W)
    boxes = [c[:, :, y0:y1, x0:x1] for c in clips]
    nbytes = boxes[0].nbytes
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    host = torch.empty(boxes[0].shape, dtype=torch.uint8, pin_memory=True)
    pin_alloc = time.perf_counter() - t0
    out = torch.empty(boxes[0].shape, dtype=torch.uint8, device=dev)
    rep = args.repeat

    fill_torch = median_s(
        lambda i: host.copy_(torch.from_numpy(boxes[i % 2])), rep)
    fill_numpy = median_s(
        lambda i: np.copyto(host.numpy(), boxes[i % 2]), rep)
    start, end = torch.cuda.Event(True), torch.cuda.Event(True)
    dma = []
    for _ in range(rep):
        start.record()
        out.copy_(host, non_blocking=True)
        end.record()
        end.synchronize()
        dma.append(start.elapsed_time(end) * 1e-3)
    pageable = median_s(
        lambda i: torch.from_numpy(clips[i % 2]).to(dev), rep)

    def serial(i):
        host.copy_(torch.from_numpy(boxes[i % 2]))
        out.copy_(host, non_blocking=True)

    def slabbed(n):
        edges = np.linspace(0, args.frames, n + 1).astype(int)

        def run(i):
            for a, b in zip(edges[:-1], edges[1:]):
                host[:, a:b].copy_(torch.from_numpy(boxes[i % 2][:, a:b]))
                out[:, a:b].copy_(host[:, a:b], non_blocking=True)
        return run

    batch = {"frames": clips[0], "scales": scales, "translations": trans,
             "flips": np.zeros(1, bool), "label": np.zeros(1, np.int32)}
    aug = dict(ds_factor=16, input_size=SIZE, device="cuda")
    i3d_augment_batch(batch, **aug)
    augment = median_s(lambda i: i3d_augment_batch(
        dict(batch, frames=clips[i % 2]), **aug), rep)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(json.dumps({
        "card": card.strip(), "torch_threads": torch.get_num_threads(),
        "box": [y0, y1, x0, x1], "box_MB": nbytes / 1e6,
        "whole_MB": clips[0].nbytes / 1e6, "pin_alloc_ms": pin_alloc * 1e3,
        "fill_torch_GBps": nbytes / fill_torch / 1e9,
        "fill_numpy_GBps": nbytes / fill_numpy / 1e9,
        "dma_pinned_GBps": nbytes / statistics.median(dma) / 1e9,
        "pageable_whole_GBps": clips[0].nbytes / pageable / 1e9,
        "serial_ms": median_s(serial, rep) * 1e3,
        "slabs_ms": {n: median_s(slabbed(n), rep) * 1e3
                     for n in args.slabs},
        "augment_ms": augment * 1e3}))


if __name__ == "__main__":
    main()
