#!/usr/bin/env python3
"""Smoke run of dmcnet_tpu_torch on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Builds the port's CUDA kernel from this checkout, holds it bit for bit
against its plain PyTorch version on the card, then drives the serving main
path at full width — DenseNetTiny + ResNet-18 at 224x224, 51 classes, seeded
random weights — over one 64-GOP chunk of synthetic 256x320, 12-frame GOPs
(192 clips), and checks what comes out.  Phases:

  1. device     card name, count, power limit (nvidia-smi); TF32 off
  2. build      nvcc of ops/csrc/backtrace_warp.cu, with ptxas' report
  3. kernel     backtrace_warp_batch vs backtrace_warp_batch_ref on the
                card, bit-equal: G=8, T=12, 256x320 at cell 16 and 8,
                border motion at max_mv, and a small GOP vs the numpy
                golden model
  4. main path  DMCPredictor._pack_rows -> _gop_program on the card;
                launch counts read around the run; u8 outputs equal to the
                same program with the plain back-trace; logits vs a CPU run
                of the port; chunk time and clips/s; the kernel's own time,
                its plain version's time and its bound
  5. videos     encode_mpeg4 -> predict_videos(backend="device"), when the
                native decoder builds (FFmpeg development files present);
                otherwise one line says the phase did not run and why

Any failure raises and exits non-zero.  The last lines are a `kernels` JSON
object and `{"ok": true, "device": {...}}`.  Needs no network; takes about
a minute on an H100.
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
# Integer operations of one back-trace step of one pixel in
# ops/csrc/backtrace_warp.cu: 2 shifts + 1 multiply-add for the cell
# index, 2 subtracts, 4 bound compares, 2 selects, the loop compare.
OPS_PER_STEP = 12

G, T, H, W, CELL, PICKS = 64, 12, 256, 320, 16, 3
SIZE, NUM_CLASS = 224, 51
# Card vs CPU logits: float32 with TF32 off, but cuDNN and the CPU sum the
# 20 convolutions in different orders (and may pick Winograd/FFT forms).
LOGIT_RTOL = LOGIT_ATOL = 1e-3


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

    def compare(cm, ifr, h, w, cell, label):
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

    # 4. main path ----------------------------------------------------------
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
    kernel_ms = median_ms(
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
          f"kernel {kernel_ms:.4f} ms, plain {plain_ms:.3f} ms; bound "
          f"{bound_ms:.4f} ms (bytes {n_bytes / 1e9:.3f} GB -> "
          f"{bytes_ms:.4f} ms; int32 ops {n_ops / 1e9:.2f} G -> "
          f"{ops_ms:.4f} ms); {bound_ms / kernel_ms * 100:.1f}% of bound")

    # 5. videos --------------------------------------------------------------
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
        "replaces": "dmcnet_tpu/ops/pallas_backtrace.py:400",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None,
    }]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"chunk_ms": chunk_ms, "chunk_ms_tf32": chunk_ms_tf32,
                      "stages_ms": stages, "clips_per_chunk": clips,
                      "clips_per_s": clips / chunk_ms * 1e3,
                      "card": smi}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
