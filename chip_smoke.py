#!/usr/bin/env python3
"""Smoke run of dmcnet_tpu_torch on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Builds the port's CUDA kernels from this checkout, holds each bit for bit
against its plain PyTorch version on the card, then drives two paths at
full width and checks what comes out: the serving main path —
DenseNetTiny + ResNet-18 at 224x224, 51 classes, seeded random weights —
over one 64-GOP chunk of synthetic 256x320, 12-frame GOPs (192 clips), and
the input side — codec accumulation on the card and the data layer at the
HMDB-51 recipe's width (examples/hmdb51_gen_flow/run.sh: batch 40, 3
segments, mv, mv_minmaxnorm, input 224) through to logits.  Phases:

  1. device      card name, count, power limit (nvidia-smi); TF32 off
  2. build       nvcc of ops/csrc/backtrace_warp.cu, with ptxas' report
  3. kernel      B1 backtrace_warp_batch vs backtrace_warp_batch_ref on the
                 card, bit-equal: G=8, T=12, 256x320 at cell 16 and 8,
                 border motion at max_mv, the ragged shapes of RAGGED
                 (W 72-112, H 8-48, T 1, 2, 13),
                 G*T = 65544 past the first design's grid limit, and a
                 small GOP vs the numpy golden model
  4. gop kernel  B2 backtrace_gop_cells vs backtrace_gop_cells_ref and vs
                 B1's accu, bit-equal: synthetic 256x320, T=12 GOPs at cell
                 16 and 8, border motion at max_mv, the ragged shapes, a
                 small GOP vs the golden model; B2's own device time beside
                 the launch floor (a 1-element zero_() in the same queue),
                 its plain version's time and its bound
  5. main path   DMCPredictor._pack_rows -> _gop_program on the card;
                 launch counts read around the run; u8 outputs equal to the
                 same program with the plain back-trace; logits vs a CPU
                 run of the port; chunk time and clips/s; B1's own device
                 time (queued launches), its plain version's time and its
                 bound
  6. codec       gop_mv_residual_cuda on 256x320, T=12 GOPs equal to the
                 plain codec.accumulate.gop_mv_residual on the card and to
                 the golden load_like_coviar_numpy; the cell-16, cell-8 and
                 dense routes each taken; median times
  7. data        a dataset with CoviarDataset's item contract whose GOPs
                 are accumulated by gop_mv_residual_cuda -> BatchAssembler
                 -> augment_train_batch / augment_eval_batch (1 and 10
                 crops) on the card, each within tolerance of the CPU, the
                 eval batches through DMCNet to video logits; B2's launch
                 count read around the phase; median batch times; a real
                 CoviarDataset over two encoded clips when the native
                 decoder builds, otherwise one line says why not
  8. videos      encode_mpeg4 -> predict_videos(backend="device"), when the
                 native decoder builds (FFmpeg development files present);
                 otherwise one line says the phase did not run and why

Any failure raises and exits non-zero.  The last lines are a `kernels` JSON
object, a summary JSON object, the card's name and power limit, and
`{"ok": true, "device": {...}}`.  Needs no network; takes about two
minutes on an H100.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np

# Published H100 SXM peaks (NVIDIA data sheet; at the 700 W power limit).
HBM_BYTES_PER_S = 3.35e12
# 32-bit integer lane rate: 132 SMs x 64 INT32 lanes x 1.98 GHz (half the
# FP32 lanes behind the 67 TFLOP/s FP32 figure, which counts an FMA as 2).
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# Integer operations of one back-trace step of one pixel, as the kernel of
# ops/csrc/backtrace_warp.cu issues them: its unrolled walk loop (2 steps x
# 4 pixels) holds 94 vector integer instructions besides the 8 loads and
# the branch (cuobjdump -sass of the library nvcc 12.8 builds, written by
# tools/bench_torch_backtrace.py; its 20 uniform-datapath instructions run
# once per warp, not per lane).  A plain count gives 12: 2 shifts + 1
# multiply-add for the cell index, 2 subtracts, 4 bound compares, 2
# selects, the loop compare.
OPS_PER_STEP = 94 / 8

G, T, H, W, CELL, PICKS = 64, 12, 256, 320, 16, 3
SIZE, NUM_CLASS = 224, 51
# Card vs CPU logits: float32 with TF32 off, but cuDNN and the CPU sum the
# 20 convolutions in different orders (and may pick Winograd/FFT forms).
LOGIT_RTOL = LOGIT_ATOL = 1e-3
# The HMDB-51 recipe's data-layer width (examples/hmdb51_gen_flow/run.sh).
BATCH, SEGMENTS, MINMAX_BOUND = 40, 3, 20
# Card vs CPU crops after normalization: float32, TF32 off; the resampling
# products are summed in different orders.
NORM_ATOL = 5e-5
# (cell, H, W, T) the kernels must mask: widths whose rows do not fill a
# block's run of pixels, one and three cell rows, and T of one frame, one
# pair and an odd count (the middle frame walks alone).
RAGGED = [(8, h, w, t) for w in (72, 88, 96) for h in (8, 24)
          for t in (1, 2, 13)] + \
         [(16, h, w, t) for w in (80, 96, 112) for h in (16, 48)
          for t in (1, 2, 13)]


class SmokeFailure(RuntimeError):
    pass


def check(cond, what):
    if not cond:
        raise SmokeFailure(what)


def phase(name):
    print(f"== {name}", flush=True)


def median_ms(fn, n, torch):
    """Median of `n` timings of fn() by CUDA events (after one warm call)."""
    fn()
    times = []
    for _ in range(n):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def device_ms_per_call(fn, n, torch):
    """Device time of one fn() call, from CUDA events around `n` calls
    queued behind a ~20 ms device sleep: the host enqueues every call
    before the first runs, so the window holds device work only and not
    the wrapper's host overhead."""
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(40_000_000)
    e0.record()
    for _ in range(n):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / n


def host_ms(fn, n, torch):
    """Median host-clock ms of fn() + synchronize (after one warm call)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def synthetic_dataset(pool, num_videos, is_train, device, cache):
    """A `CoviarDataset` over synthetic GOPs instead of decoded video: its
    own sampling and item contract — (S, H, W, 7) uint8 group stack,
    label, (H, W) — with each GOP's MV and residual accumulated on the
    card by `gop_mv_residual_cuda` and u8-encoded on the host once, like
    the dataset's GOP cache.  Video v's GOP k is pool GOP (v + k) %
    len(pool); the flow channels are neutral (128), as without a flow
    root.  `cache` maps pool index -> (mv_u8, res_u8) across datasets."""
    from dmcnet_tpu_torch.data.dmc_dataset import CoviarDataset, _encode_u8
    from dmcnet_tpu_torch.data.lists import VideoItem
    from dmcnet_tpu_torch.ops.backtrace import gop_mv_residual_cuda

    class SyntheticCoviarDataset(CoviarDataset):
        def _segment_frame(self, item, gop_index, gop_pos):
            k = (item.label + gop_index) % len(pool)
            if k not in cache:
                mv, res = gop_mv_residual_cuda(*pool[k], device=device)
                cache[k] = (_encode_u8(mv.cpu().numpy(), MINMAX_BOUND),
                            _encode_u8(res.cpu().numpy()))
            mv_u8, res_u8 = cache[k]
            flow = np.full((H, W, 2), 128, np.uint8)
            return np.concatenate([flow, mv_u8[gop_pos], res_u8[gop_pos]],
                                  axis=-1)

    check(num_videos <= NUM_CLASS, "one label per synthetic video")
    items = [VideoItem(f"synthetic/{v}.avi", v, 3 * T)
             for v in range(num_videos)]
    return SyntheticCoviarDataset(None, None, None, "mv", SEGMENTS,
                                  is_train=is_train, gop=T, mv_minmaxnorm=1,
                                  items=items)


def gop_kernel_phase(torch, bt, dev, rng):
    """4. B2 against its plain version and B1's accu on the card, bit for
    bit; its own time and bound.  Returns the synthetic GOPs (reused by the
    codec and data phases) and B2's numbers."""
    from dmcnet_tpu_torch.codec.semantics import accumulate_gop_numpy
    from dmcnet_tpu_torch.codec.synthetic import dense_mv_maps, synthetic_gop

    phase("gop kernel")
    t0 = time.perf_counter()
    gops = {}  # synthetic GOPs (block lists, dense maps, frames), reused
    for name, block in (("16x16 blocks", 16), ("8x8 blocks", 8),
                        ("4x4 blocks", 4)):
        bl, frames = synthetic_gop(rng, num_frames=T, height=H, width=W,
                                   block_size=block, max_motion=16)
        gops[name] = (bl, dense_mv_maps(bl, H, W), frames)
    print(f"  set-up (3 synthetic {H}x{W} T={T} GOPs) "
          f"{time.perf_counter() - t0:.2f} s")
    b2_err = 0

    def compare_gop(cells, cell, label, quiet=False):
        nonlocal b2_err
        cm_d = torch.as_tensor(np.ascontiguousarray(cells, np.int32),
                               device=dev)
        h, w = cm_d.shape[1] * cell, cm_d.shape[2] * cell
        accu = bt.backtrace_gop_cells(cm_d, h, w, cell)
        torch.cuda.synchronize()
        ref = bt.backtrace_gop_cells_ref(cm_d, h, w, cell)
        b1, _ = bt.backtrace_warp_gop_cells(
            cm_d, torch.zeros((3, h, w), dtype=torch.int32, device=dev), h,
            w, cell)
        err = int((accu - ref).abs().max())
        b2_err = max(b2_err, err)
        if not quiet:
            print(f"  {label}: max |B2 - plain| = {err}, B2 == B1 accu: "
                  f"{torch.equal(accu, b1)}")
        check(err == 0, f"B2 != plain version ({label})")
        check(torch.equal(accu, b1), f"B2 != B1's accu ({label})")
        return cm_d, accu

    cm8, ok = bt.cell_mv_from_dense(gops["16x16 blocks"][1])
    coarse, ok16 = bt.coarsen_cell_mv(cm8, H, W)
    check(ok and ok16, "16x16-block GOP must coarsen to cell 16")
    b2_inputs, _ = compare_gop(coarse, 16, f"T={T} {H}x{W} cell 16, "
                               "16x16 blocks")
    compare_gop(cm8, 8, f"T={T} {H}x{W} cell 8, 16x16 blocks")
    cm8, ok = bt.cell_mv_from_dense(gops["8x8 blocks"][1])
    check(ok and not bt.coarsen_cell_mv(cm8, H, W)[1],
          "8x8-block GOP must stay at cell 8")
    compare_gop(cm8, 8, f"T={T} {H}x{W} cell 8, 8x8 blocks")
    for cell in (16, 8):
        m = bt.max_mv(cell)
        border = np.zeros((T, H // cell, W // cell, 2), np.int64)
        border[1::2] = m      # odd frames push sources off the top/left
        border[2::2] = -m     # even frames off the bottom/right
        compare_gop(border, cell, f"border |mv| = max_mv({cell}) = {m}")
    for cell, h, w, t in RAGGED:
        m = bt.max_mv(cell)
        compare_gop(rng.integers(-m, m + 1, size=(t, h // cell, w // cell,
                                                  2)),
                    cell, f"ragged T={t} {h}x{w} cell {cell}", quiet=True)
    print(f"  {len(RAGGED)} ragged shapes (W 72-112, H 8-48, T 1/2/13, "
          f"cell 8 and 16): max |B2 - plain| = {b2_err}, B2 == B1 accu")
    block_lists, _ = synthetic_gop(rng, num_frames=6, height=64, width=96,
                                   max_motion=20)
    small = dense_mv_maps(block_lists, 64, 96)
    coarse, ok16 = bt.coarsen_cell_mv(bt.cell_mv_from_dense(small)[0], 64,
                                      96)
    check(ok16, "small GOP must coarsen to cell 16")
    _, accu = compare_gop(coarse, 16, "small GOP vs numpy golden")
    accu = bt.accu_to_hwc(accu).cpu().numpy()
    for s in range(6):
        check(np.array_equal(accu[s], accumulate_gop_numpy(block_lists, 64,
                                                           96, s)),
              f"B2 accu != golden at frame {s}")
    print("  small GOP: accu equals the golden model")
    b2_ms = device_ms_per_call(
        lambda: bt.backtrace_gop_cells(b2_inputs, H, W, 16), 100, torch)
    one = torch.empty(1, device=dev)
    floor_ms = device_ms_per_call(lambda: one.zero_(), 100, torch)
    b2_wrapper_ms = host_ms(
        lambda: bt.backtrace_gop_cells(b2_inputs, H, W, 16), 50, torch)
    b2_plain_ms = median_ms(
        lambda: bt.backtrace_gop_cells_ref(b2_inputs, H, W, 16), 10, torch)
    b2_bytes = (b2_inputs.numel() + T * 2 * H * W) * 4
    b2_ops = OPS_PER_STEP * H * W * sum(range(T))
    b2_bytes_ms = b2_bytes / HBM_BYTES_PER_S * 1e3
    b2_ops_ms = b2_ops / INT32_OPS_PER_S * 1e3
    b2_bound_ms = max(b2_bytes_ms, b2_ops_ms)
    print(f"  launch floor: a 1-element zero_() {floor_ms:.5f} ms per call "
          "(device, 100 queued launches)")
    print(f"  backtrace_gop_cells at T={T} {H}x{W} cell 16: kernel "
          f"{b2_ms:.5f} ms (device, 100 queued launches), wrapper call "
          f"{b2_wrapper_ms:.4f} ms (host clock), plain {b2_plain_ms:.3f} "
          f"ms; bound {b2_bound_ms:.5f} ms (bytes {b2_bytes / 1e6:.3f} MB "
          f"-> {b2_bytes_ms:.5f} ms; int32 ops {b2_ops / 1e6:.1f} M -> "
          f"{b2_ops_ms:.5f} ms); {b2_bound_ms / b2_ms * 100:.1f}% of bound")
    return {"gops": gops, "max_err": b2_err, "ms": b2_ms,
            "floor_ms": floor_ms,
            "wrapper_ms": b2_wrapper_ms, "plain_ms": b2_plain_ms,
            "bound_ms": b2_bound_ms,
            "bound_by": "bytes" if b2_bytes_ms >= b2_ops_ms else "operations"}


def codec_phase(torch, bt, dev, gops):
    """6. gop_mv_residual_cuda on full-size GOPs: bit-equal to the plain
    codec.accumulate path on the card and to the golden model; each route
    taken.  Returns median times (ms)."""
    from dmcnet_tpu_torch.codec.accumulate import gop_mv_residual
    from dmcnet_tpu_torch.codec.semantics import load_like_coviar_numpy
    from dmcnet_tpu_torch.codec.synthetic import dense_mv_maps

    phase("codec")
    bl16, dense16, frames16 = gops["16x16 blocks"]
    w_odd = W - 4
    cases = [
        ("cell16", "16x16 blocks", bl16, dense16, frames16),
        ("cell8", "8x8 blocks", *gops["8x8 blocks"]),
        ("dense", "4x4 blocks: cells mix motions", *gops["4x4 blocks"]),
        ("dense", f"width {w_odd}, not a multiple of 8", bl16,
         dense_mv_maps(bl16, H, w_odd),
         np.ascontiguousarray(frames16[:, :, :w_odd])),
    ]
    routes0 = dict(bt.backtrace_gop_cuda.routes)
    launches0 = bt.backtrace_gop_cells.launches
    for route, label, block_lists, dense, frames in cases:
        before = dict(bt.backtrace_gop_cuda.routes)
        mv, res = bt.gop_mv_residual_cuda(dense, frames, device=dev)
        torch.cuda.synchronize()
        taken = [k for k, v in bt.backtrace_gop_cuda.routes.items()
                 if v != before[k]]
        check(taken == [route], f"{label}: route {taken}, want {route}")
        p_mv, p_res = gop_mv_residual(dense, frames, device=dev)
        check(torch.equal(mv, p_mv) and torch.equal(res, p_res),
              f"{label}: gop_mv_residual_cuda != codec.accumulate")
        w = dense.shape[2]
        for pos in (1, T - 1):
            for rep, got in (("mv", mv), ("residual", res)):
                want = load_like_coviar_numpy(block_lists, frames, pos, rep,
                                              True)
                check(np.array_equal(got[pos].cpu().numpy(), want),
                      f"{label}: {rep} != golden at frame {pos}")
        print(f"  {label} ({H}x{w}): route {route}; mv and residual equal "
              "codec.accumulate on the card and the golden model")
    taken = {k: v - routes0[k]
             for k, v in bt.backtrace_gop_cuda.routes.items()}
    launched = bt.backtrace_gop_cells.launches - launches0
    print(f"  routes taken {taken}; backtrace_gop_cells launches "
          f"{launched}")
    check(all(taken.values()), "a route of gop_mv_residual_cuda was not "
          "taken")
    check(launched >= 2, "gop_mv_residual_cuda did not launch B2")
    times = {
        "gop_mv_residual_cuda": host_ms(
            lambda: bt.gop_mv_residual_cuda(dense16, frames16, device=dev),
            20, torch),
        "cells_from_dense_host": host_ms(
            lambda: bt.coarsen_cell_mv(bt.cell_mv_from_dense(dense16)[0], H,
                                       W), 20, torch),
        "plain_gop_mv_residual": host_ms(
            lambda: gop_mv_residual(dense16, frames16, device=dev), 10,
            torch),
    }
    print(f"  per {H}x{W} T={T} GOP, 16x16 blocks (median ms, host clock): "
          + ", ".join(f"{k} {v:.3f}" for k, v in times.items()))
    return times


def data_phase(torch, bt, dev, gops, pred, rng):
    """7. The data layer at the HMDB-51 recipe's width on the card, held
    against the CPU, eval batches through DMCNet to video logits.  Returns
    B2's launch count over the phase and median times (ms)."""
    from dmcnet_tpu_torch.data.dmc_dataset import (
        BatchAssembler,
        augment_eval_batch,
        augment_train_batch,
    )
    from dmcnet_tpu_torch.models.tsn import segment_consensus

    phase("data")
    pool = [gops[k][1:] for k in ("16x16 blocks", "8x8 blocks",
                                  "4x4 blocks")]
    cache = {}
    bt.backtrace_gop_cells.launches = 0
    train_ds = synthetic_dataset(pool, 8, True, dev, cache)
    eval_ds = synthetic_dataset(pool, BATCH, False, dev, cache)
    train_asm = BatchAssembler(train_ds, input_size=SIZE, seed=0)
    batch = train_asm.train_batch(range(BATCH))
    parts = augment_train_batch(batch, "mv", input_size=SIZE, device=dev)
    torch.cuda.synchronize()
    check(tuple(batch["frames"].shape) == (BATCH, SEGMENTS, H, W, 7),
          f"train frames {batch['frames'].shape}")
    check(tuple(parts["mv"].shape) == (BATCH, SEGMENTS, 2, SIZE, SIZE)
          and tuple(parts["residual"].shape)
          == (BATCH, SEGMENTS, 3, SIZE, SIZE), "train batch shapes")

    def vs_cpu(got, fn, b, label):
        want = fn(b, "mv", input_size=SIZE, device="cpu")
        err = max(float((got[k][:len(b["label"])].cpu() - want[k]).abs()
                        .max()) for k in ("flow", "mv", "residual"))
        print(f"  {label} vs CPU: max |diff| = {err:.3g} "
              f"(atol {NORM_ATOL}, after normalization)")
        check(err <= NORM_ATOL, f"{label}: card != CPU")

    vs_cpu(parts, augment_train_batch, batch,
           f"train batch {BATCH}x{SEGMENTS} at {SIZE}")
    logits = {}
    eval_batches = {}
    with torch.inference_mode():
        for crops in (1, 10):
            asm = BatchAssembler(eval_ds, input_size=SIZE, test_crops=crops)
            eb = asm.eval_batch(range(BATCH))
            eval_batches[crops] = (asm, eb)
            ep = augment_eval_batch(eb, "mv", input_size=SIZE, device=dev)
            n_seg = crops * SEGMENTS
            check(tuple(ep["mv"].shape) == (BATCH, n_seg, 2, SIZE, SIZE),
                  f"eval batch shape at {crops} crops")
            # the CPU holds the 10-crop batch for 4 videos (time)
            sub = eb if crops == 1 else {k: v[:4] for k, v in eb.items()}
            vs_cpu(ep, augment_eval_batch, sub,
                   f"eval batch {len(sub['label'])}x{n_seg} at {SIZE}")
            out = []
            for i in range(0, BATCH, 8):
                gen = pred.model.generate(ep["mv"][i:i + 8],
                                          ep["residual"][i:i + 8])
                out.append(segment_consensus(pred.model.classify(gen),
                                             n_seg))
            logits[crops] = torch.cat(out)
            torch.cuda.synchronize()
            check(tuple(logits[crops].shape) == (BATCH, NUM_CLASS)
                  and bool(torch.isfinite(logits[crops]).all()),
                  f"video logits at {crops} crops")
    b2_launches = bt.backtrace_gop_cells.launches
    print(f"  main path of the slice: backtrace_gop_cells launches = "
          f"{b2_launches}; video logits {tuple(logits[1].shape)} at 1 and "
          "10 crops, finite")
    check(b2_launches >= 1, "the data path did not launch B2")

    eval1_asm, eval1 = eval_batches[1]
    eval10_asm, eval10 = eval_batches[10]
    times = {
        "train_assemble_host": host_ms(
            lambda: train_asm.train_batch(range(BATCH)), 5, torch),
        "train_augment": median_ms(
            lambda: augment_train_batch(batch, "mv", input_size=SIZE,
                                        device=dev), 5, torch),
        "eval1_assemble_host": host_ms(
            lambda: eval1_asm.eval_batch(range(BATCH)), 5, torch),
        "eval1_augment": median_ms(
            lambda: augment_eval_batch(eval1, "mv", input_size=SIZE,
                                       device=dev), 5, torch),
        "eval10_augment": median_ms(
            lambda: augment_eval_batch(eval10, "mv", input_size=SIZE,
                                       device=dev), 5, torch),
    }
    print(f"  batch of {BATCH} videos x {SEGMENTS} segments (median ms): "
          + ", ".join(f"{k} {v:.3f}" for k, v in times.items()))

    from dmcnet_tpu_torch.codec.mpeg4 import (
        NativeCodecUnavailable,
        _lib,
        encode_mpeg4,
    )

    try:
        _lib()
    except NativeCodecUnavailable as exc:
        print(f"  real CoviarDataset did not run: the native decoder cannot "
              f"be built here ({str(exc).splitlines()[0]})")
    else:
        import os
        import tempfile

        from dmcnet_tpu_torch.data.dmc_dataset import CoviarDataset
        from dmcnet_tpu_torch.data.lists import VideoItem

        with tempfile.TemporaryDirectory(dir=os.path.dirname(
                os.path.abspath(__file__))) as d:
            items = []
            for i in range(2):
                canvas = rng.integers(0, 256, size=(H + 110, W + 160, 3))
                canvas = (canvas // 8 * 8).astype(np.uint8)
                clip = np.stack([canvas[40 + k:40 + k + H,
                                        40 + 2 * k:40 + 2 * k + W]
                                 for k in range(26)])
                path = os.path.join(d, f"clip{i}.avi")
                encode_mpeg4(path, clip, gop_size=12, bit_rate=2_000_000)
                items.append(VideoItem(path, i, 26))
            ds = CoviarDataset(None, None, None, "mv", SEGMENTS,
                               is_train=True, mv_minmaxnorm=1, items=items)
            b = BatchAssembler(ds, input_size=SIZE).train_batch(range(4))
            got = augment_train_batch(b, "mv", input_size=SIZE, device=dev)
            vs_cpu(got, augment_train_batch, b,
                   "real CoviarDataset train batch 4 (2 encoded clips)")
    return {"b2_launches": b2_launches, "times": times}


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from dmcnet_tpu_torch.codec.semantics import accumulate_gop_numpy
    from dmcnet_tpu_torch.codec.synthetic import block_arrays, synthetic_gop
    from dmcnet_tpu_torch.data.transforms import IMAGENET_STD, MEAN_STD
    from dmcnet_tpu_torch.ops import _build
    from dmcnet_tpu_torch.ops import backtrace as bt
    from dmcnet_tpu_torch.serving import DMCPredictor

    # 1. device ------------------------------------------------------------
    phase("device")
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"device cuda:0 {kind} (count {count}), torch {torch.__version__}"
          f" cuda {torch.version.cuda}")
    print(smi)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print("TF32 off for convolutions and matmuls (float32 throughout)")
    dev = torch.device("cuda")

    # 2. build -------------------------------------------------------------
    phase("build")
    t0 = time.perf_counter()
    lib_path, report = _build.build("backtrace_warp")
    print(f"built {lib_path} in {time.perf_counter() - t0:.2f} s")
    for line in report.splitlines():
        if "registers" in line or "spill" in line:
            print("  " + line.strip())

    # 3. kernel vs plain version ---------------------------------------------
    phase("kernel")
    rng = np.random.default_rng(0)
    max_err = 0

    def compare(cm, ifr, h, w, cell, label, quiet=False):
        nonlocal max_err
        if isinstance(cm, np.ndarray):
            cm = np.ascontiguousarray(cm, np.int32)
            ifr = np.ascontiguousarray(ifr, np.int32)
        cm_d = torch.as_tensor(cm, device=dev)
        ifr_d = torch.as_tensor(ifr, device=dev)
        accu, warped = bt.backtrace_warp_batch(cm_d, ifr_d, h, w, cell)
        torch.cuda.synchronize()
        ra, rw = bt.backtrace_warp_batch_ref(cm_d, ifr_d, h, w, cell)
        err = max(int((accu - ra).abs().max()), int((warped - rw).abs().max()))
        max_err = max(max_err, err)
        if not quiet:
            print(f"  {label}: max |kernel - plain| = {err}")
        check(err == 0, f"kernel != plain version ({label})")
        return accu, warped

    for cell in (16, 8):
        m = bt.max_mv(cell)
        cm = rng.integers(-m, m + 1, size=(8, T, H // cell, W // cell, 2))
        ifr = rng.integers(0, 256, size=(8, 3, H, W))
        compare(cm, ifr, H, W, cell, f"G=8 T={T} {H}x{W} cell {cell} random")
        border = np.zeros((2, T, H // cell, W // cell, 2), np.int64)
        border[:, 1::2] = m      # odd frames push sources off the top/left
        border[:, 2::2] = -m     # even frames off the bottom/right
        compare(border, ifr[:2], H, W, cell,
                f"border |mv| = max_mv({cell}) = {m}")
    for cell, h, w, t in RAGGED:
        m = bt.max_mv(cell)
        compare(rng.integers(-m, m + 1, size=(3, t, h // cell, w // cell, 2)),
                rng.integers(0, 256, size=(3, 3, h, w)), h, w, cell,
                f"ragged G=3 T={t} {h}x{w} cell {cell}", quiet=True)
    print(f"  {len(RAGGED)} ragged shapes (W 72-112, H 8-48, T 1/2/13, "
          f"cell 8 and 16): max |kernel - plain| = {max_err}")
    # past the G*T <= 65535 grid limit of the first design
    big_g = 65535 // T + 1
    compare(rng.integers(-7, 8, size=(big_g, T, 1, 1, 2)),
            rng.integers(0, 256, size=(big_g, 3, 8, 8)), 8, 8, 8,
            f"G={big_g} T={T} (G*T = {big_g * T}) 8x8 cell 8")
    block_lists, frames = synthetic_gop(rng, num_frames=6, height=64,
                                        width=96, max_motion=20)
    blocks, n_blocks = block_arrays(block_lists)
    cm, cell = bt.cell_mv_from_blocks_np(blocks, n_blocks, 64, 96)
    check(cm is not None, "synthetic GOP must qualify")
    accu, warped = compare(cm[None], frames[0].transpose(2, 0, 1)[None],
                           64, 96, cell, "small GOP vs numpy golden")
    accu, warped = accu.cpu().numpy()[0], warped.cpu().numpy()[0]
    for s in range(6):
        golden = accumulate_gop_numpy(block_lists, 64, 96, s)
        check(np.array_equal(accu[s].transpose(1, 2, 0), golden),
              f"kernel accu != golden at frame {s}")
        check(np.array_equal(warped[s].transpose(1, 2, 0),
                             frames[0][golden[..., 1], golden[..., 0]]),
              f"kernel warped != golden at frame {s}")
    print("  small GOP: accu and warped equal the golden model")

    b2 = gop_kernel_phase(torch, bt, dev, rng)
    gops = b2["gops"]

    # 5. main path ----------------------------------------------------------
    phase("main path")
    t0 = time.perf_counter()
    pred = DMCPredictor(num_class=NUM_CLASS, arch="resnet18",
                        arch_estimator="DenseNetTiny", gen_flow_or_delta=1,
                        mv_minmaxnorm=1, input_size=SIZE, device="cuda",
                        seed=0)
    rows = []
    pick = np.unique(np.round(np.linspace(1, T - 1, PICKS)).astype(int))
    for _ in range(G):
        block_lists, frames = synthetic_gop(rng, num_frames=T, height=H,
                                            width=W, max_motion=16)
        blocks, n_blocks = block_arrays(block_lists)
        cm, cell = bt.cell_mv_from_blocks_np(blocks, n_blocks, H, W)
        check(cm is not None and cell == CELL, "synthetic GOP must qualify")
        rows.append((cm, cell, frames[0], pred._center_crop(frames[pick]),
                     pick))
    arrays = pred._pack_rows(rows, G, T, H, W, CELL, PICKS)
    fn = pred._gop_program(G, T, H, W, CELL, PICKS)
    print(f"  set-up (model, {G} synthetic GOPs) "
          f"{time.perf_counter() - t0:.2f} s")

    bt.backtrace_warp_batch.launches = 0
    logits, mv_u8, res_u8 = fn(*pred._to_device(arrays))
    torch.cuda.synchronize()
    launches = bt.backtrace_warp_batch.launches
    print(f"  main path: backtrace_warp_batch launches = {launches}")
    check(launches >= 1, "the main path did not launch backtrace_warp")
    check(tuple(logits.shape) == (G * PICKS, NUM_CLASS),
          f"logits shape {tuple(logits.shape)}")
    check(bool(torch.isfinite(logits).all()), "non-finite logits")
    check(tuple(mv_u8.shape) == (G, PICKS, SIZE, SIZE, 2)
          and tuple(res_u8.shape) == (G, PICKS, SIZE, SIZE, 3),
          "u8 output shapes")

    plain = DMCPredictor(pred.model.state_dict(), num_class=NUM_CLASS,
                         input_size=SIZE, device="cuda",
                         backtrace_impl=bt.backtrace_warp_batch_ref)
    p_logits, p_mv, p_res = plain._gop_program(G, T, H, W, CELL, PICKS)(
        *plain._to_device(arrays))
    check(torch.equal(p_mv, mv_u8) and torch.equal(p_res, res_u8),
          "mv_u8/res_u8 differ from the plain back-trace program")
    print("  mv_u8 and res_u8 equal the plain back-trace program's; logits "
          f"max diff {float((p_logits - logits).abs().max()):.3g}")

    g_cpu = 4
    cpu = DMCPredictor(pred.model.state_dict(), num_class=NUM_CLASS,
                       input_size=SIZE, device="cpu")
    c_logits, c_mv, c_res = cpu._gop_program(g_cpu, T, H, W, CELL, PICKS)(
        *cpu._to_device(cpu._pack_rows(rows[:g_cpu], g_cpu, T, H, W, CELL,
                                       PICKS)))
    check(torch.equal(c_mv, mv_u8[:g_cpu].cpu())
          and torch.equal(c_res, res_u8[:g_cpu].cpu()),
          "u8 outputs differ from the CPU run")
    gpu_rows = logits[:g_cpu * PICKS].cpu()
    logit_err = float((gpu_rows - c_logits).abs().max())
    print(f"  logits vs CPU run ({g_cpu * PICKS} rows): max |diff| = "
          f"{logit_err:.3g}, max |logit| = "
          f"{float(c_logits.abs().max()):.3g} (rtol={LOGIT_RTOL}, "
          f"atol={LOGIT_ATOL}, TF32 off)")
    check(torch.allclose(gpu_rows, c_logits, rtol=LOGIT_RTOL,
                         atol=LOGIT_ATOL), "card logits != CPU logits")

    def time_chunks(n=20, warm=3):
        out = []
        for i in range(warm + n):
            t0 = time.perf_counter()
            fn(*pred._to_device(arrays))
            torch.cuda.synchronize()
            if i >= warm:
                out.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(out)

    chunk_ms = time_chunks()
    clips = G * PICKS
    print(f"  chunk ({G} GOPs, {clips} clips, host arrays -> logits): "
          f"median {chunk_ms:.3f} ms over 20 chunks = "
          f"{clips / chunk_ms * 1e3:.1f} clips/s (fp32, TF32 off)")
    torch.backends.cudnn.allow_tf32 = True
    chunk_ms_tf32 = time_chunks()
    torch.backends.cudnn.allow_tf32 = False
    print(f"  same chunk with cuDNN TF32 on: median {chunk_ms_tf32:.3f} ms "
          f"= {clips / chunk_ms_tf32 * 1e3:.1f} clips/s")

    # where the chunk's time goes, layer by layer (CUDA events, medians)
    def host_to_device():
        pred._to_device(arrays)

    mv_flat = mv_u8.reshape(G * PICKS, SIZE, SIZE, 2)
    res_flat = res_u8.reshape(G * PICKS, SIZE, SIZE, 3)
    dev_arrays = pred._to_device(arrays)
    with torch.inference_mode():
        mv_n = ((mv_flat.float() / 255.0 - 0.5) / MEAN_STD) \
            .permute(0, 3, 1, 2)
        res_n = ((res_flat.float() / 255.0 - 0.5)
                 / torch.as_tensor(IMAGENET_STD, device=dev)) \
            .permute(0, 3, 1, 2)
        gen = pred.model.generate(mv_n, res_n)
        stages = {
            "host_to_device": median_ms(host_to_device, 10, torch),
            "gop_program": median_ms(lambda: fn(*dev_arrays), 10, torch),
            "forward_u8": median_ms(
                lambda: pred._forward_u8(mv_flat, res_flat), 10, torch),
            "generator": median_ms(
                lambda: pred.model.generate(mv_n, res_n), 10, torch),
            "classifier": median_ms(
                lambda: pred.model.classify(gen), 10, torch),
        }
    print("  breakdown (median ms, fp32): " + ", ".join(
        f"{k} {v:.3f}" for k, v in stages.items()))

    cm_d, if_d = dev_arrays[:2]
    ifr_d = if_d.permute(0, 3, 1, 2).to(torch.int32).contiguous()
    compare(cm_d, ifr_d, H, W, CELL, f"main-path inputs G={G} T={T} "
            f"{H}x{W} cell {CELL}")
    # the first design's times were read with median_ms, whose window
    # holds the wrapper's host work; the kernel's time is device time over
    # queued launches
    kernel_median_ms = median_ms(
        lambda: bt.backtrace_warp_batch(cm_d, ifr_d, H, W, CELL), 20, torch)
    print(f"  backtrace_warp_batch by the earlier method (median of 20 "
          f"event-timed calls, host work inside): {kernel_median_ms:.4f} ms")
    kernel_ms = device_ms_per_call(
        lambda: bt.backtrace_warp_batch(cm_d, ifr_d, H, W, CELL), 20, torch)
    plain_ms = median_ms(
        lambda: bt.backtrace_warp_batch_ref(cm_d, ifr_d, H, W, CELL), 5,
        torch)
    n_bytes = (cm_d.numel() + ifr_d.numel() + G * T * 5 * H * W) * 4
    n_ops = OPS_PER_STEP * H * W * G * sum(range(T))
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = n_ops / INT32_OPS_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    print(f"  backtrace_warp_batch at G={G} T={T} {H}x{W} cell {CELL}: "
          f"kernel {kernel_ms:.4f} ms (device, 20 queued launches), plain "
          f"{plain_ms:.3f} ms; bound "
          f"{bound_ms:.4f} ms (bytes {n_bytes / 1e9:.3f} GB -> "
          f"{bytes_ms:.4f} ms; int32 ops {n_ops / 1e9:.2f} G -> "
          f"{ops_ms:.4f} ms); {bound_ms / kernel_ms * 100:.1f}% of bound")

    codec_times = codec_phase(torch, bt, dev, gops)
    data = data_phase(torch, bt, dev, gops, pred, rng)

    # 8. videos --------------------------------------------------------------
    phase("videos")
    from dmcnet_tpu_torch.codec.mpeg4 import (
        NativeCodecUnavailable,
        _lib,
        encode_mpeg4,
    )

    try:
        _lib()
    except NativeCodecUnavailable as exc:
        print(f"videos phase did not run: the native decoder cannot be "
              f"built here ({str(exc).splitlines()[0]})")
    else:
        import os
        import tempfile

        with tempfile.TemporaryDirectory(dir=os.path.dirname(
                os.path.abspath(__file__))) as d:
            paths = []
            for i in range(2):
                canvas = rng.integers(0, 256, size=(H + 110, W + 160, 3))
                canvas = (canvas // 8 * 8).astype(np.uint8)
                clip = np.stack([canvas[40 + k:40 + k + H,
                                        40 + 2 * k:40 + 2 * k + W]
                                 for k in range(26)])
                paths.append(os.path.join(d, f"pan{i}.avi"))
                encode_mpeg4(paths[-1], clip, gop_size=12,
                             bit_rate=2_000_000)
            bt.backtrace_warp_batch.launches = 0
            scores = pred.predict_videos(paths, backend="device")
            n = bt.backtrace_warp_batch.launches
            host = pred.predict_videos(paths, backend="host")
        print(f"  predict_videos(2 clips, backend='device'): launches {n}")
        check(n >= 1, "predict_videos did not launch backtrace_warp")
        for s, hs in zip(scores, host):
            check(s.shape == (NUM_CLASS,) and np.isfinite(s).all(),
                  "bad video scores")
            check(np.allclose(s, hs, rtol=LOGIT_RTOL, atol=LOGIT_ATOL),
                  "device and host backends disagree")
        print("  device-backend scores agree with the host backend")

    kernels = [{
        "name": "backtrace_warp_batch",
        "route": "cuda",
        "source": "dmcnet_tpu_torch/ops/csrc/backtrace_warp.cu",
        "replaces": "dmcnet_tpu/ops/pallas_backtrace.py:401",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None,
    }, {
        "name": "backtrace_gop_cells",
        "route": "cuda",
        "source": "dmcnet_tpu_torch/ops/csrc/backtrace_warp.cu",
        "replaces": "dmcnet_tpu/ops/pallas_backtrace.py:371",
        "launches": data["b2_launches"],
        "max_abs_err": b2["max_err"],
        "ms": b2["ms"],
        "plain_ms": b2["plain_ms"],
        "bound_ms": b2["bound_ms"],
        "bound_by": b2["bound_by"],
        "library_ms": None,
    }]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"chunk_ms": chunk_ms, "chunk_ms_tf32": chunk_ms_tf32,
                      "stages_ms": stages, "clips_per_chunk": clips,
                      "clips_per_s": clips / chunk_ms * 1e3,
                      "b1_median_ms": kernel_median_ms,
                      "b2_wrapper_ms": b2["wrapper_ms"],
                      "launch_floor_ms": b2["floor_ms"],
                      "codec_ms": codec_times,
                      "data_ms": data["times"], "card": smi}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
