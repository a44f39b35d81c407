#!/usr/bin/env python3
"""Smoke run of dmcnet_tpu_torch on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Builds the port's CUDA kernels from this checkout, holds each bit for bit
against its plain PyTorch version on the card, then drives three paths at
full width and checks what comes out: the serving main path —
DenseNetTiny + ResNet-18 at 224x224, 51 classes, seeded random weights —
over one 64-GOP chunk of synthetic 256x320, 12-frame GOPs (192 clips), and
the input side — codec accumulation on the card and the data layer at the
HMDB-51 recipe's width (examples/hmdb51_gen_flow/run.sh: batch 40, 3
segments, mv, mv_minmaxnorm, input 224) through to logits, dmcnet and
dmcnet_GAN training at that width, I3D whole-video evaluation at the width
of examples/i3d/eval.sh (250-frame clips at 224², DenseNetTiny, 51
classes), I3D training at the width of examples/i3d/train.sh, the
parallel layer, pipeline-parallel scoring at the recipe's 250 clips a
video, and the utilities (flow pictures, profiler traces, the command
dispatcher).  Phases:

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
  5. main path   DMCPredictor._pack_rows -> _gop_program on the card,
                 served by the default pack=True predictor (the folded
                 bfloat16 forward: packed generator + PackedResNet18);
                 launch counts read around that run; u8 outputs equal to
                 the pack=False predictor's on the same arrays and to the
                 program with the plain back-trace; pack=False logits vs a
                 CPU run of the port (float32); pack=True logits vs
                 pack=False on the card and pack=True on the CPU, within
                 PACK_TOL; chunk time and clips/s of both (pack=False also
                 with TF32) and each forward's stage breakdown; B1's own
                 device time (queued launches), its plain version's time
                 and its bound
 5b. mesh        DMCPredictor(mesh=[every visible card]) on the same
                 chunk: B1 launched once per card, u8 outputs bit-equal
                 and logits within rtol 1e-4, atol 2e-4 of the one-card
                 predictor's, both chunks' ms; serve --mesh-devices over 4
                 synthetic videos (the host gather swapped: no decoder)
 5c. packed      the packed layer alone: the generator over 192 clips at
                 224² at s = 1, 2, 4 in bf16 and fp32, NCHW and
                 channels_last; QuantizedPackedEstimator's int8 GEMM route
                 bit-equal to its float64 route and timed beside the bf16
                 packed generator; a dmcnet train step at the recipe's
                 batch with --packed-gen 2 against 0 in fp32 and bf16,
                 losses within the train phase's rtol in fp32 and
                 PACKED_BF16_LOSS_RTOL in bf16
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
  8. train       dmcnet training at the HMDB-51 recipe's width (batch 40 x
                 3 segments at 224, DenseNetTiny + ResNet-18, lr 0.01,
                 lr-mse 1, flow_ds_factor 16) on synthetic datasets whose
                 GOPs B2 accumulates and whose flow target is the
                 accumulated MV: one train step on the card against the CPU
                 (4 videos), a freeze-phase step (classifier and its Adam
                 state bit-unchanged), median step and eval times, clips/s
                 and peak memory in fp32, TF32 and bf16, the cli.train loop
                 (2 epochs x 2 batches, 8 loader threads) with its data and
                 batch times and the kernels' launches counted around it,
                 its checkpoint reloaded bit-equal and served by
                 DMCPredictor.from_checkpoint
  9. gan         dmcnet_GAN training at the width of
                 examples/hmdb51_gan/run.sh (batch 40 x 3 at 224,
                 DenseNetTiny + ResNet-18 + Discriminator, lr 0.001,
                 lr_d_mult 0.01) on the train phase's synthetic datasets:
                 a D and a G step card against CPU with dropout off (f32
                 losses and accuracies, f64 parameters), a frozen D step
                 (classifier bit-unchanged, its Adam step count moved), D
                 and G step times, clips/s of a D+G pair and peak memory in
                 fp32, TF32 and bf16, the cli.train loop with GAN options
                 (2 epochs x 2 batches) and the kernels' launches counted
                 around it, its checkpoint's optimizer_d reloaded, scored
                 by cli.test --arch_d on the card and on the CPU (G
                 adversarial accuracy), served.  The training loops' B2
                 launches come from the synthetic datasets, which
                 accumulate their GOPs on the card; the recipes' own
                 datasets (--no-accumulation) launch none
 10. i3d         the I3D evaluation recipe (examples/i3d/eval.sh: HMDB-51,
                 flow+mp4, DenseNetTiny, clip 250, frame interval 1,
                 mv_minmaxnorm, accumulate 0, ds_factor 16, batch 1, 224²)
                 on clips of a VideoClipDataset over the synthetic GOPs:
                 two 16-frame clips through i3d_augment_batch and the
                 eval step, card against CPU (He-normal weights, so the
                 logits see the clip); step, generator and backbone times
                 at T = 250 in fp32, TF32 and bf16 with videos/s, peak
                 memory and the FLOPs' share of the card's peak;
                 cli.evaluate_video_i3d.evaluate() over 4 videos x 2
                 rounds, its npz checked; a reference-layout .pth written,
                 reloaded through --load-weights bit-equal, and an RGB
                 model's 3-channel stem adapted; the launch counts of B1
                 and B2 read around the path (no TPU kernel lies on it)
 11. i3d_train   I3D training at the width of examples/i3d/train.sh (clip
                 64, batch 3, iter-size 32 at 224², Adam, dropout 0.85,
                 DenseNetTiny + Discriminator, adv 1, detach, stage-1
                 learning rates; seeded He-normal weights, since the
                 recipe's --pretrained_3d file is not in the repository):
                 a D and a G macro step of 2 microbatches card against CPU
                 with dropout off (1 clip x 16 frames at 64², f32 losses,
                 f64 parameters); D- and G-phase microstep times (one
                 microbatch of 3 clips x 64 frames: forward, backward,
                 optimizer step) in fp32, TF32 and bf16 with peak memory;
                 one 32-microbatch D and G macro step fed from clips staged
                 on the host (ms, clips/s, peak memory, the host assembly
                 on its own line); the cli.train_i3d loop (--iter-size 2,
                 2 epochs x 2 macro steps, the stage-2 swap at
                 --epoch-thre 1) with its data and batch times and the
                 launches of B1 and B2 counted around it (0: the clips
                 accumulate on the host); its checkpoint scored by
                 evaluate_video_i3d --load-weights on the card and the CPU
 12. dist        the parallel layer and the directory checkpoints at the
                 train phase's width, on a world-size-1 process group
                 (cpu:gloo,cuda:nccl): the plain, data-parallel (global BN
                 swapped in, gradients averaged) and FSDP2 train steps on
                 the same seeded weights and batch, and a GAN D and G step
                 plain and data-parallel, agree (f32 losses, f64
                 parameters); their ms (CUDA events, median of 5, fp32)
                 and peak memory; the cli.train loop (2 epochs x 2
                 batches) with --ckpt-backend orbax-async against orbax:
                 the time each save blocks the loop and a step directory's
                 bytes; a torn step (meta.pkl, no commit) planted and
                 skipped by --auto-resume; the directory scored by
                 cli.test --weights and served by
                 DMCPredictor.from_checkpoint, card against CPU; B1 and B2
                 counted around the phase (0)
 13. parallel    I3D training across processes, time-sharded I3D
                 evaluation and tensor parallelism on a world-size-1
                 group (cpu:gloo,cuda:nccl): plain, data-parallel and
                 FSDP2 I3D D and G microsteps agree (f32 losses, f64
                 parameters, 2 clips x 16 frames at 64²), their ms and peak
                 memory at examples/i3d/train.sh's microbatch (3 clips x
                 64 frames at 224²); the cli.train_i3d loop with
                 --ckpt-backend orbax-async resumed by --auto-resume; the
                 time-sharded forward of a 250-frame clip at 224² against
                 the unsharded one, ms and peak memory of both; a
                 tensor-parallel dmcnet step on a 1 x 1 mesh against the
                 plain step (f32 loss, f64 parameters), both steps' ms and
                 peak memory, a cli.train --tp 1 step; then 2 gloo
                 processes on the one card: the time-sharded forward over
                 125 + 125 frames (halos crossing through the host)
                 against the unsharded logits, and a 1 x 2
                 tensor-parallel dmcnet step in float64 against the plain
                 step; B1 and B2 counted around the phase (0)
 14. pipeline    pipeline-parallel scoring at the width of the HMDB-51
                 recipe's test command (25 segments x 10 crops = 250 clips
                 a video at 224², DenseNetTiny + ResNet-18, 51 classes),
                 every stage on cuda:0 (one card: the schedule's cost, no
                 overlap between cards): the pp 2 and pp 4 logits of one
                 video against the unpipelined classifier on the card and
                 the CPU; the classifier's ms (CUDA events, median of 5)
                 and peak memory at pp 1, 2 and 4; a float64 backward
                 through the 2-stage schedule (remat off and on) against
                 the serial gradients; cli.test --pp 2 (its stage devices,
                 cli.common.first_devices, swapped to cuda:0 twice)
                 against cli.test over 4
                 synthetic videos; B1 and B2 counted around the phase (0)
 15. utils       cli.test --viz 1 on the card, its PNGs within one level of
                 a CPU run's; the cli.train loop at the train phase's width
                 (40 x 3 at 224²) with --profile-dir over a 10-batch epoch:
                 one trace, its steps 2-7, its CUDA kernel events and the
                 device's busy share over the traced window; python -m
                 dmcnet_tpu_torch --help in a subprocess; B1 and B2 counted
                 around the phase (0)
 16. videos      encode_mpeg4 -> predict_videos(backend="device"), when the
                 native decoder builds (FFmpeg development files present);
                 otherwise one line says the phase did not run and why

Any failure raises and exits non-zero.  The last lines are a `kernels` JSON
object, a summary JSON object, the card's name and power limit, and
`{"ok": true, "device": {...}}`.  Needs no network; takes about 5-6
minutes on an H100.
"""

from __future__ import annotations

import itertools
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
# The folded bfloat16 serving forward (pack=True) against the float32 one
# and against itself on the CPU: max |diff| within PACK_TOL of the
# reference's largest |logit| (bfloat16 keeps 8 significant bits, about
# 0.4% a rounding, over the generator's 6 and ResNet-18's 20 layers).
PACK_TOL = 2e-2
# Serving over several cards against one (tests/test_torch_serving.py's).
SERVE_RTOL, SERVE_ATOL = 1e-4, 2e-4
# The HMDB-51 recipe's data-layer width (examples/hmdb51_gen_flow/run.sh).
BATCH, SEGMENTS, MINMAX_BOUND = 40, 3, 20
# Card vs CPU crops after normalization: float32, TF32 off; the resampling
# products are summed in different orders.
NORM_ATOL = 5e-5
# The train phase: examples/hmdb51_gen_flow/run.sh's flags, and the
# tolerances of tests/test_torch_train.py for card against CPU.  Parameters
# are compared after a float64 step: in float32, Adam (eps 1e-3) turns the
# noise of a gradient near eps into most of a step (conv1 weights 8.8e-5
# apart after one step of 1e-4, TF32 off), whatever the card computes.
TRAIN_RECIPE = ["--data-name", "hmdb51", "--representation", "mv",
                "--arch", "resnet18", "--arch_estimator", "DenseNetTiny",
                "--num_segments", str(SEGMENTS), "--no-accumulation",
                "--mv_minmaxnorm", "1", "--flow_ds_factor", "16",
                "--gen_flow_or_delta", "1", "--lr", "0.01", "--lr-mse", "1",
                "--lr-steps", "55", "110", "165", "--lr-decay", "0.25"]
TRAIN_LOSS_RTOL = 1e-4
# --packed-gen 2 against 0 under bf16 autocast: the packed and unpacked
# convolutions sum in other orders, so the generator's bf16 outputs (8
# significant bits) round apart and ResNet-18 carries that into the
# classification loss: 9.1e-5 apart at 40 x 3 on an H100 (PERF.md §6).
# float32 steps keep TRAIN_LOSS_RTOL.
PACKED_BF16_LOSS_RTOL = 1e-3
TRAIN_PARAM_RTOL, TRAIN_PARAM_ATOL = 5e-4, 5e-6
TRAIN_TIMED_STEPS = 5
LONG_EPOCH_BATCHES = 8
# Card vs CPU steps run on the first CHECK_VIDEOS videos of a batch; the
# training phases' cli.train loops run 2 epochs x 2 batches.
CHECK_VIDEOS = 4
LOOP_FLAGS = ["--epochs", "2", "--epoch-thre", "1", "--eval-freq", "1",
              "--workers", "8", "--batch-size", str(BATCH)]
# The GAN phase: examples/hmdb51_gan/run.sh's flags (its --weights aside),
# and the test command's 3 segments x 10 crops over GAN_TEST_VIDEOS videos.
GAN_MODEL = ["--data-name", "hmdb51", "--representation", "mv",
             "--arch", "resnet18", "--arch_estimator", "DenseNetTiny",
             "--arch_d", "Discriminator", "--no-accumulation",
             "--mv_minmaxnorm", "1", "--flow_ds_factor", "16",
             "--gen_flow_or_delta", "1"]
GAN_RECIPE = GAN_MODEL + ["--num_segments", str(SEGMENTS), "--lr", "0.001",
                          "--lr-adv-g", "1", "--lr-adv-d", "1",
                          "--lr_d_mult", "0.01"]
GAN_TEST_VIDEOS = 4
# The test command's model flags for the dist phase's dmcnet checkpoint.
DIST_TEST_MODEL = [f for f in GAN_MODEL if f not in ("--arch_d",
                                                     "Discriminator")]
# The I3D evaluation recipe (examples/i3d/eval.sh), at full width.
I3D_FLAGS = ["--dataset", "HMDB51", "--split", "1", "--clip-length", "250",
             "--frame-interval", "1", "--modality", "flow+mp4",
             "--arch-estimator", "DenseNetTiny", "--mv-minmaxnorm", "1",
             "--accumulate", "0", "--ds_factor", "16", "--batch-size", "1",
             "--input-size", str(SIZE)]
I3D_T, I3D_CHECK_T, I3D_VIDEOS, I3D_TIMED = 250, 16, 4, 5
# The I3D training recipe (examples/i3d/train.sh, its --pretrained_3d
# aside), at full width: clip 64, batch 3, iter-size 32 at 224².  The
# macro steps cycle through I3D_STAGED microbatches staged on the host; the
# card-vs-CPU check runs 2 microbatches of 1 clip x I3D_CHECK_T frames at
# I3D_CHECK_SIZE²; the cli.train_i3d loop runs 2 epochs x 2 macro steps.
I3D_TRAIN_FLAGS = ["--dataset", "HMDB51", "--split", "1", "--network", "I3D",
                   "--clip-length", "64", "--iter-size", "32",
                   "--batch-size", "3", "--optimizer", "adam",
                   "--modality", "flow+mp4", "--train-frame-interval", "1",
                   "--val-frame-interval", "1", "--lr-base", "0.0004",
                   "--lr-base2", "0.0004", "--lr-d", "0.002", "--detach",
                   "1", "--lr-factor", "0.2", "--drop-out", "0.85",
                   "--fine_tune", "0", "--arch-estimator", "DenseNetTiny",
                   "--arch-d", "Discriminator", "--adv", "1",
                   "--epoch-thre", "6", "--ds_factor", "16",
                   "--mv-minmaxnorm", "1", "--accumulate", "0"]
I3D_TRAIN_T, I3D_TRAIN_B, I3D_TRAIN_ITER, I3D_STAGED = 64, 3, 32, 4
I3D_CHECK_SIZE = 64
I3D_LOOP_ITER = 2
I3D_LOOP_FLAGS = ["--iter-size", str(I3D_LOOP_ITER), "--epoch-thre", "1",
                  "--end-epoch", "2", "--workers", "8"]
# The pipeline phase: the scoring recipe's 25 segments x 10 crops, the
# classifier at pp 1 and PP_STAGES timed PP_TIMED times; a float64 backward
# through 2 stages at PP_GRAD_BATCH x PP_GRAD_SIZE² (the card may sum a
# weight gradient's terms in any order: atol scales with the tensor's
# largest |value|); cli.test --pp 2 over PP_VIDEOS videos.
PP_SEGMENTS, PP_CROPS, PP_STAGES, PP_TIMED = 25, 10, (2, 4), 5
PP_GRAD_BATCH, PP_GRAD_SIZE = 8, 64
PP_F64_RTOL, PP_F64_ATOL = 1e-10, 1e-12
PP_VIDEOS = 4
# The utils phase: --viz over VIZ_VIDEOS videos; --profile-dir over one
# epoch of PROFILE_BATCHES batches (steps 2-7 traced).
VIZ_VIDEOS, PROFILE_BATCHES = 2, 10
# Published H100 SXM peaks (NVIDIA data sheet, dense, at 700 W) by the type
# the I3D step computes in.
PEAK_FLOPS = {"fp32": 67e12, "tf32": 495e12, "bf16": 989e12}
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


def synthetic_dataset(pool, num_videos, is_train, device, cache,
                      flow_from_mv=False, num_segments=SEGMENTS):
    """A `CoviarDataset` over synthetic GOPs instead of decoded video: its
    own sampling and item contract — (S, H, W, 7) uint8 group stack,
    label, (H, W) — with each GOP's MV and residual accumulated on the
    card by `gop_mv_residual_cuda` and u8-encoded on the host once, like
    the dataset's GOP cache (under a lock: loader threads share it).
    Video v has label v % NUM_CLASS, and its GOP k is pool GOP (label + k)
    % len(pool).  The flow channels are neutral (128), as without a flow
    root, or with `flow_from_mv` the u8-encoded accumulated MV, a target
    that is not constant.  `cache` maps pool index -> (mv_u8, res_u8)
    across datasets."""
    import threading

    from dmcnet_tpu_torch.data.dmc_dataset import CoviarDataset, _encode_u8
    from dmcnet_tpu_torch.data.lists import VideoItem
    from dmcnet_tpu_torch.ops.backtrace import gop_mv_residual_cuda

    lock = threading.Lock()

    class SyntheticCoviarDataset(CoviarDataset):
        def _segment_frame(self, item, gop_index, gop_pos):
            k = (item.label + gop_index) % len(pool)
            with lock:
                if k not in cache:
                    mv, res = gop_mv_residual_cuda(*pool[k], device=device)
                    cache[k] = (_encode_u8(mv.cpu().numpy(), MINMAX_BOUND),
                                _encode_u8(res.cpu().numpy()))
            mv_u8, res_u8 = cache[k]
            flow = mv_u8[gop_pos] if flow_from_mv else \
                np.full((H, W, 2), 128, np.uint8)
            return np.concatenate([flow, mv_u8[gop_pos], res_u8[gop_pos]],
                                  axis=-1)

    items = [VideoItem(f"synthetic/{v}.avi", v % NUM_CLASS, 3 * T)
             for v in range(num_videos)]
    return SyntheticCoviarDataset(None, None, None, "mv", num_segments,
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


def _state_close(torch, a, b, what):
    """Two DMCNet state_dicts within the train tests' tolerance."""
    for k, v in a.items():
        if k.endswith("num_batches_tracked"):
            continue
        w = b[k].to(v.device)
        check(torch.allclose(v, w, rtol=TRAIN_PARAM_RTOL,
                             atol=TRAIN_PARAM_ATOL),
              f"{what}: {k} differs by {float((v - w).abs().max()):.3g}")


def _equal_optimizer_states(a, b):
    sa, sb = a.state_dict(), b.state_dict()
    if sa["param_groups"] != sb["param_groups"] or sa["state"].keys() != \
            sb["state"].keys():
        return False
    return all(all(v.cpu().equal(sb["state"][i][k].cpu())
                   for k, v in st.items()) for i, st in sa["state"].items())


def in_workdir(fn, *args):
    """fn(*args, workdir), with a temporary directory of the checkout for
    the files the phase writes."""
    import os
    import tempfile

    with tempfile.TemporaryDirectory(dir=os.path.dirname(os.path.abspath(
            __file__))) as workdir:
        return fn(*args, workdir)


def _recipe_setup(torch, dev, gops, args):
    """The training phases' pool of synthetic GOPs, and one train and one
    eval batch of BATCH x SEGMENTS at SIZE on the card, drawn from
    synthetic datasets whose flow target is the accumulated MV."""
    from dmcnet_tpu_torch.data.dmc_dataset import (
        BatchAssembler,
        augment_eval_batch,
        augment_train_batch,
    )

    t0 = time.perf_counter()
    pool = [gops[k][1:] for k in ("16x16 blocks", "8x8 blocks",
                                  "4x4 blocks")]
    cache = {}
    train_ds = synthetic_dataset(pool, 2 * BATCH, True, dev, cache,
                                 flow_from_mv=True)
    val_ds = synthetic_dataset(pool, BATCH, False, dev, cache,
                               flow_from_mv=True)
    aug = dict(representation="mv", flow_ds_factor=args.flow_ds_factor,
               input_size=SIZE, device=dev)
    batch = augment_train_batch(BatchAssembler(
        train_ds, input_size=SIZE, seed=0).train_batch(range(BATCH)), **aug)
    val_batch = augment_eval_batch(BatchAssembler(
        val_ds, input_size=SIZE, test_crops=1).eval_batch(range(BATCH)),
        **aug)
    torch.cuda.synchronize()
    print(f"  set-up (a {BATCH} x {SEGMENTS} train and eval batch at {SIZE} "
          "from synthetic datasets, flow target = accumulated MV) "
          f"{time.perf_counter() - t0:.2f} s")
    return pool, batch, val_batch


def _card_vs_cpu(torch, dev, batch, build, run, what, shown, desc=None):
    """`run(model, batch)` -> metrics for a `build()` model on the card and
    on the CPU, over the first CHECK_VIDEOS rows of `batch` (`desc` says
    what they are): in float32 (TF32 off) the metrics agree within
    TRAIN_LOSS_RTOL; in float64 those and every parameter and BN statistic
    (see TRAIN_PARAM_RTOL)."""
    n = CHECK_VIDEOS
    desc = desc or f"{n} videos x {SEGMENTS} at {SIZE}"
    for dtype in (torch.float32, torch.float64):
        small = {k: v[:n].to(dtype) if v.is_floating_point() else v[:n]
                 for k, v in batch.items()}
        sides = []
        for device in (dev, "cpu"):
            model = build().to(device, dtype)
            sides.append((model, run(model, {k: v.to(device)
                                             for k, v in small.items()})))
        (gpu_model, got), (cpu_model, want) = sides
        for k, w in want.items():
            g, w = float(got[k]), float(w)
            check(abs(g - w) <= TRAIN_LOSS_RTOL * abs(w),
                  f"{what} {k} ({dtype}): card {g} != CPU {w}")
        checked = ", ".join(want)
        if dtype == torch.float64:
            _state_close(torch, cpu_model.state_dict(),
                         gpu_model.state_dict(), f"{what}, card vs CPU")
            checked += (f"; parameters and BN statistics within rtol "
                        f"{TRAIN_PARAM_RTOL}, atol {TRAIN_PARAM_ATOL}")
        print(f"  {what}, {desc}, {str(dtype)[6:]}: " + ", ".join(
                  f"{k} card {float(got[k]):.7f} / CPU {float(want[k]):.7f}"
                  for k in shown)
              + f"; agree: {checked} (rtol {TRAIN_LOSS_RTOL}, TF32 off)")


def _precision_times(torch, make_fns, trained, smi, clips=BATCH * SEGMENTS):
    """Median ms (TRAIN_TIMED_STEPS, CUDA events) and peak memory of each
    function of `make_fns(bf16)` on `clips` clips a call, in fp32 (TF32
    off), TF32 and bf16 autocast, beside the memory already allocated when
    it starts (model, optimizer state, batches), and clips/s over one call
    of each function named in `trained`."""
    timing = {}
    print(f"  step times on {smi} (medians of {TRAIN_TIMED_STEPS}, CUDA "
          f"events, {clips} clips a step):")
    for label, tf32, bf16 in (("fp32", False, False), ("tf32", True, False),
                              ("bf16", False, True)):
        torch.backends.cudnn.allow_tf32 = tf32
        torch.backends.cuda.matmul.allow_tf32 = tf32
        row = {}
        fns = make_fns(bf16)
        for name, fn in fns.items():
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            row[name + "_resident_bytes"] = torch.cuda.memory_allocated()
            row[name + "_ms"] = median_ms(fn, TRAIN_TIMED_STEPS, torch)
            row[name + "_peak_bytes"] = torch.cuda.max_memory_allocated()
        row["clips_per_s"] = len(trained) * clips / sum(
            row[name + "_ms"] for name in trained) * 1e3
        timing[label] = row
        print(f"  {label}: " + ", ".join(
            f"{name} {row[name + '_ms']:.3f} ms (peak memory "
            f"{row[name + '_peak_bytes'] / 2**30:.3f} GiB, of which "
            f"{row[name + '_resident_bytes'] / 2**30:.3f} resident before "
            "it)" for name in fns)
            + f"; {row['clips_per_s']:.1f} clips/s over "
            + " + ".join(trained))
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return timing


def _train_loop(torch, bt, train_cli, args, pool, dev):
    """The `cli.train` loop — dmcnet_GAN's when `args` name a discriminator
    — for 2 epochs x 2 batches with 8 loader threads, over synthetic
    datasets with a cache of their own: their loader threads accumulate
    every GOP anew, and the kernels' counts, set to 0 just before the loop
    and read just after, are the loop's own.  Returns the result, the
    loop's seconds, the counts, its validation dataset and its cache."""
    cache = {}
    train_ds = synthetic_dataset(pool, 2 * BATCH, True, dev, cache,
                                 flow_from_mv=True)
    val_ds = synthetic_dataset(pool, BATCH, False, dev, cache,
                               flow_from_mv=True)
    train_cli.SAVE_FREQ = 1  # write after each epoch: the file then holds
    # the state the loop ends with
    bt.backtrace_warp_batch.launches = 0
    bt.backtrace_gop_cells.launches = 0
    t0 = time.perf_counter()
    result = train_cli.train(args, train_ds, val_ds, device=dev,
                             input_size=SIZE)
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    launches = {"backtrace_warp_batch": bt.backtrace_warp_batch.launches,
                "backtrace_gop_cells": bt.backtrace_gop_cells.launches}
    check(len(result.epochs) == 2, "the loop did not run 2 epochs")
    batches = "a D and a G batch" if getattr(args, "arch_d", None) else \
        f"{len(train_ds) // BATCH} batches"
    for e in result.epochs:
        print(f"  loop epoch {e['epoch']}: data time {e['data_time']:.4f} s, "
              f"batch time {e['batch_time']:.4f} s (averages over {batches},"
              " host clock)")
    print(f"  loop: 2 epochs with evaluation in {loop_s:.2f} s; launches in "
          f"the loop {launches} (B2 from the synthetic datasets' loader "
          "threads, which accumulate each GOP on the card)")
    check(launches["backtrace_gop_cells"] >= 1, "the loop did not launch B2")
    return result, loop_s, launches, val_ds, cache


def _reload_and_serve(torch, dev, train_cli, args, result, batch):
    """The loop's last checkpoint reloads bit-equal — parameters, BN buffers
    and every optimizer's Adam state, `optimizer_d` among them with a
    discriminator — and `DMCPredictor.from_checkpoint` serves it (dropping
    a discriminator) with the trained model's logits on `batch`."""
    import os

    from dmcnet_tpu_torch.models.tsn import segment_consensus
    from dmcnet_tpu_torch.serving import DMCPredictor
    from dmcnet_tpu_torch.train import checkpoints as tckpt
    from dmcnet_tpu_torch.train import optimizers as topt

    ckpt = result.checkpoint
    check(ckpt is not None and os.path.exists(ckpt), "no checkpoint written")
    model2 = train_cli.build_model(args, NUM_CLASS, SIZE).to(dev)
    opts2 = topt.make_optimizers(model2, args.lr_cls_mult, args.lr_mse_mult,
                                 getattr(args, "lr_d_mult", None))
    meta = tckpt.load_checkpoint(ckpt, model2, opts2)
    check(meta["epoch"] == 2, f"checkpoint epoch {meta['epoch']}")
    sd, sd2 = result.model.state_dict(), model2.state_dict()
    check(all(torch.equal(v, sd2[k]) for k, v in sd.items()),
          "reloaded parameters or BN buffers differ")
    check(len(opts2) == len(result.optimizers)
          and all(bool(o.state) for o in opts2)
          and all(_equal_optimizer_states(a, b)
                  for a, b in zip(result.optimizers, opts2)),
          "reloaded optimizer states differ")
    pred = DMCPredictor.from_checkpoint(ckpt, num_class=NUM_CLASS,
                                        device=dev)
    with torch.inference_mode():
        result.model.eval()
        want = result.model(batch["mv"], batch["residual"])[0]
        got = pred.model.classify(pred.model.generate(
            batch["mv"], batch["residual"]))
        scores = segment_consensus(got, SEGMENTS)
    check(tuple(scores.shape) == (BATCH, NUM_CLASS)
          and bool(torch.isfinite(scores).all()), "served scores")
    check(torch.allclose(got, want, rtol=LOGIT_RTOL, atol=LOGIT_ATOL),
          "served logits differ from the trained model's")
    print(f"  checkpoint {os.path.basename(ckpt)} (epoch {meta['epoch']}): "
          f"parameters, BN buffers and {len(opts2)} Adam states reload "
          f"bit-equal; DMCPredictor.from_checkpoint scores {BATCH} videos, "
          f"logits max |diff| {float((got - want).abs().max()):.3g} from the "
          "trained model")
    return ckpt


def train_phase(torch, bt, dev, gops, smi, workdir):
    """8. dmcnet training at the HMDB-51 recipe's width: one train step on
    the card against the CPU, a freeze-phase step, step and eval times in
    fp32, TF32 and bf16, the `cli.train` loop over synthetic datasets with
    its data and batch times, its checkpoint reloaded and served.  Returns
    the numbers for the summary line."""
    import os

    from dmcnet_tpu_torch.cli import train as train_cli
    from dmcnet_tpu_torch.cli.train_options import build_parser
    from dmcnet_tpu_torch.train import engine
    from dmcnet_tpu_torch.train import optimizers as topt

    phase("train")
    t_phase = time.perf_counter()
    args = build_parser().parse_args(TRAIN_RECIPE + LOOP_FLAGS + [
        "--model-prefix", os.path.join(workdir, "model")])
    pool, batch, val_batch = _recipe_setup(torch, dev, gops, args)

    def stepper(model, bf16=False):
        opts = topt.make_optimizers(model, args.lr_cls_mult,
                                    args.lr_mse_mult)
        topt.adjust_learning_rate(opts, args.lr, args.weight_decay)
        kw = dict(num_segments=SEGMENTS, lr_cls_w=args.lr_cls,
                  lr_mse_w=args.lr_mse, loss_mse=args.loss_mse, bf16=bf16)
        return (opts, engine.make_train_step(model, *opts, **kw),
                engine.make_eval_step(model, **kw))

    # (a) one step on the card against the same step on the CPU
    _card_vs_cpu(torch, dev, batch,
                 lambda: train_cli.build_model(args, NUM_CLASS, SIZE),
                 lambda m, b: stepper(m)[1](b, True), "one train step",
                 ("loss",))

    # (b) a freeze-phase step: the classifier and its Adam state untouched
    model = train_cli.build_model(args, NUM_CLASS, SIZE).to(dev)
    opts, step, _ = stepper(model)
    step(batch, True)  # so that the classifier's Adam state exists
    cls_before = {k: v.clone() for k, v in
                  model.base_model.named_parameters()}
    gen_before = {k: v.clone() for k, v in
                  model.gen_flow_model.named_parameters()}
    opt_cls_before = {i: {k: v.clone() for k, v in st.items()}
                      for i, st in opts[0].state_dict()["state"].items()}
    step(batch, False)
    check(all(torch.equal(v, cls_before[k])
              for k, v in model.base_model.named_parameters()),
          "the freeze step moved the classifier")
    check(all(all(torch.equal(v, opt_cls_before[i][k])
                  for k, v in st.items())
              for i, st in opts[0].state_dict()["state"].items()),
          "the freeze step changed the classifier's Adam state")
    moved = sum(not torch.equal(v, gen_before[k])
                for k, v in model.gen_flow_model.named_parameters())
    check(moved > 0, "the freeze step did not move the generator")
    print(f"  freeze-phase step ({BATCH} x {SEGMENTS}): classifier parameters "
          f"and Adam state bit-unchanged; {moved} generator tensors moved")

    # (c) step and eval times at the recipe's batch
    def timed(bf16):
        _, t_step, t_eval = stepper(model, bf16=bf16)
        return {"train_step": lambda: t_step(batch, True),
                "eval_step": lambda: t_eval(val_batch)}

    timing = _precision_times(torch, timed, ("train_step",), smi)
    del model, opts, step

    # (d) the cli.train loop, then one longer frozen epoch over the loop's
    # cache: whether the loader keeps up once its threads run ahead of the
    # first batch
    result, loop_s, launches, val_ds, cache = _train_loop(
        torch, bt, train_cli, args, pool, dev)
    long_args = build_parser().parse_args(TRAIN_RECIPE + [
        "--epochs", "1", "--workers", "8", "--batch-size", str(BATCH),
        "--model-prefix", os.path.join(workdir, "long")])
    long_ds = synthetic_dataset(pool, LONG_EPOCH_BATCHES * BATCH, True, dev,
                                cache, flow_from_mv=True)
    t0 = time.perf_counter()
    long_epoch = train_cli.train(long_args, long_ds, val_ds, device=dev,
                                 input_size=SIZE).epochs[0]
    torch.cuda.synchronize()
    long_s = time.perf_counter() - t0
    steady = {k: statistics.median(long_epoch[k + "s"][1:])
              for k in ("data_time", "batch_time")}
    print(f"  loop, one frozen epoch of {LONG_EPOCH_BATCHES} batches in "
          f"{long_s:.2f} s: data time {long_epoch['data_time']:.4f} s, "
          f"batch time {long_epoch['batch_time']:.4f} s (averages); after "
          f"the first batch median data time {steady['data_time']:.4f} s, "
          f"batch time {steady['batch_time']:.4f} s; per batch data "
          + " ".join(f"{t:.3f}" for t in long_epoch["data_times"]))

    # (e) the checkpoint reloads bit-equal and serves
    _reload_and_serve(torch, dev, train_cli, args, result, val_batch)
    phase_s = time.perf_counter() - t_phase
    print(f"  train phase {phase_s:.1f} s")
    return {"timing": timing, "epochs": result.epochs, "loop_s": loop_s,
            "long_epoch": long_epoch, "long_epoch_s": long_s,
            "steady": steady, "launches": launches, "phase_s": phase_s}


def _dropout_off(torch, model):
    """Rate 0 on the discriminator's Dropout2d modules: the card and the CPU
    draw their masks from different generators."""
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout2d):
            m.p = 0.0
    return model


def gan_phase(torch, bt, dev, gops, smi, workdir):
    """9. dmcnet_GAN training at examples/hmdb51_gan/run.sh's width: one D
    and one G step on the card against the CPU, a frozen D step, D and G
    step times in fp32, TF32 and bf16, the `cli.train` loop, its checkpoint
    reloaded, scored by `cli.test --arch_d` on the card and on the CPU, and
    served.  Returns the numbers for the summary line."""
    import contextlib
    import io
    import os
    import re

    from dmcnet_tpu_torch.cli import test as test_cli
    from dmcnet_tpu_torch.cli import train as train_cli
    from dmcnet_tpu_torch.cli.train_options import build_parser
    from dmcnet_tpu_torch.train import optimizers as topt
    from dmcnet_tpu_torch.train.engine_gan import make_gan_train_steps

    phase("gan")
    t_phase = time.perf_counter()
    args = build_parser(gan=True).parse_args(GAN_RECIPE + LOOP_FLAGS + [
        "--model-prefix", os.path.join(workdir, "gan")])
    pool, batch, val_batch = _recipe_setup(torch, dev, gops, args)

    def stepper(model, bf16=False, frozen=False):
        opts = topt.make_optimizers(model, args.lr_cls_mult,
                                    args.lr_mse_mult, args.lr_d_mult)
        topt.adjust_learning_rate(opts[:1], 0.0 if frozen else args.lr,
                                  args.weight_decay)
        topt.adjust_learning_rate(opts[1:], args.lr, args.weight_decay)
        return (opts,) + make_gan_train_steps(
            model, *opts, num_segments=SEGMENTS, lr_cls_w=args.lr_cls,
            lr_adv_g=args.lr_adv_g, lr_adv_d=args.lr_adv_d,
            lr_mse_w=args.lr_mse, loss_mse=args.loss_mse, bf16=bf16)

    # (a) a D and a G step on the card against the CPU, dropout off
    def d_then_g(model, b):
        _, d_step, g_step = stepper(model)
        return {**{"D " + k: v for k, v in d_step(b).items()},
                **{"G " + k: v for k, v in g_step(b).items()}}

    _card_vs_cpu(torch, dev, batch, lambda: _dropout_off(
        torch, train_cli.build_model(args, NUM_CLASS, SIZE)), d_then_g,
        "D + G step, dropout off", ("D loss", "G loss"))

    # (b) a frozen D step: the classifier at lr 0 keeps its parameters
    # while its Adam moments and step count move; the discriminator trains
    model = train_cli.build_model(args, NUM_CLASS, SIZE).to(dev)
    (opt_cls, _, _), d_step, _ = stepper(model, frozen=True)
    cls_before = {k: v.clone() for k, v in
                  model.base_model.named_parameters()}
    d_before = {k: v.clone() for k, v in
                model.discriminator.named_parameters()}
    d_step(batch)
    check(all(torch.equal(v, cls_before[k])
              for k, v in model.base_model.named_parameters()),
          "the frozen D step moved the classifier")
    n_cls = len(cls_before)
    check(len(opt_cls.state) == n_cls
          and all(float(st["step"]) == 1.0 for st in opt_cls.state.values()),
          "the frozen D step did not advance the classifier's Adam step")
    check(any(bool(st["exp_avg"].any()) for st in opt_cls.state.values()),
          "the frozen D step left the classifier's moments at zero")
    moved = sum(not torch.equal(v, d_before[k])
                for k, v in model.discriminator.named_parameters())
    check(moved == len(d_before), "the frozen D step did not train D")
    print(f"  frozen D step ({BATCH} x {SEGMENTS}): classifier parameters "
          f"bit-unchanged, its Adam step 1 on all {n_cls} tensors; "
          f"{moved} discriminator tensors moved")
    del opt_cls, d_step

    # (c) D and G step times at the recipe's batch
    def timed(bf16):
        _, t_d, t_g = stepper(model, bf16=bf16)
        return {"d_step": lambda: t_d(batch), "g_step": lambda: t_g(batch)}

    timing = _precision_times(torch, timed, ("d_step", "g_step"), smi)
    del model

    # (d) the cli.train loop: 2 epochs x 2 batches (D, G); (e) its
    # checkpoint reloads and serves
    result, loop_s, launches, _, cache = _train_loop(
        torch, bt, train_cli, args, pool, dev)
    ckpt = _reload_and_serve(torch, dev, train_cli, args, result, val_batch)

    # (f) cli.test --arch_d scores the checkpoint on the card and the CPU
    test_list = _test_list(workdir, GAN_TEST_VIDEOS)
    scored = []  # (G adversarial accuracy, scores, s) on the card, the CPU
    real_dataset = test_cli.CoviarDataset
    # the command's dataset over the synthetic GOPs (no decoder here)
    test_cli.CoviarDataset = lambda **kw: synthetic_dataset(
        pool, GAN_TEST_VIDEOS, False, dev, cache, flow_from_mv=True,
        num_segments=kw["num_segments"])
    try:
        for device in (str(dev), "cpu"):
            scores = os.path.join(workdir, f"scores_{len(scored)}")
            out = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                test_cli.main(GAN_MODEL + [
                    "--test-list", test_list, "--weights", ckpt,
                    "--test_segments", "3", "--test-crops", "10",
                    "--input_size", str(SIZE), "--save-scores", scores,
                    "--device", device])
            g_adv = re.findall(r"G adversarial accuracy ([0-9.]+)%",
                               out.getvalue())
            check(len(g_adv) == 1, f"cli.test --arch_d on {device} printed "
                  f"no G adversarial accuracy: {out.getvalue()[-300:]}")
            with np.load(scores + ".npz", allow_pickle=True) as data:
                s_arr = np.stack([x[0] for x in data["scores"]])
            scored.append((float(g_adv[0]), s_arr,
                           time.perf_counter() - t0))
    finally:
        test_cli.CoviarDataset = real_dataset
    (g_card, s_card, t_card), (g_cpu, s_cpu, t_cpu) = scored
    check(s_card.shape == (GAN_TEST_VIDEOS, 1, NUM_CLASS)
          and np.isfinite(s_card).all(), "cli.test --arch_d scores")
    check(g_card == g_cpu, f"G adversarial accuracy card {g_card}% != CPU "
          f"{g_cpu}%")
    check(np.allclose(s_card, s_cpu, rtol=LOGIT_RTOL, atol=LOGIT_ATOL),
          "cli.test --arch_d scores: card != CPU")
    print(f"  cli.test --arch_d Discriminator ({GAN_TEST_VIDEOS} videos x 3 "
          f"segments x 10 crops): G adversarial accuracy {g_card}% on the "
          f"card and {g_cpu}% on the CPU; scores max |diff| "
          f"{float(np.abs(s_card - s_cpu).max()):.3g}; {t_card:.2f} s card, "
          f"{t_cpu:.2f} s CPU")
    phase_s = time.perf_counter() - t_phase
    print(f"  gan phase {phase_s:.1f} s")
    return {"timing": timing, "epochs": [
        {k: e[k] for k in ("epoch", "data_time", "batch_time")}
        for e in result.epochs], "loop_s": loop_s,
        "g_adv_card": g_card, "g_adv_cpu": g_cpu, "test_card_s": t_card,
        "test_cpu_s": t_cpu, "launches": launches, "phase_s": phase_s}


def _free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _dir_bytes(path):
    import os

    return sum(os.path.getsize(os.path.join(root, f))
               for root, _, files in os.walk(path) for f in files)


def dist_phase(torch, bt, dev, gops, smi, workdir):
    """12. The parallel layer and the directory checkpoints at the HMDB-51
    recipe's width, on a world-size-1 process group (cpu:gloo,cuda:nccl):
    the plain, data-parallel (global BN, averaged gradients) and FSDP2
    train steps, and a GAN D and G step plain and data-parallel, agree
    (f32 losses, f64 parameters, the train phase's tolerances); their step
    times and peak memory; the cli.train loop with --ckpt-backend
    orbax-async against orbax (the time each save blocks the loop, a step
    directory's bytes); a torn step planted and skipped by --auto-resume;
    the directory scored by cli.test --weights and served by
    DMCPredictor.from_checkpoint on the card against the CPU.  B1 and B2
    are counted around the phase: none lies on it (the datasets' GOPs are
    accumulated before the counts are set to 0)."""
    import contextlib
    import io
    import os
    import pickle

    import torch.distributed as dist

    from dmcnet_tpu_torch.cli import test as test_cli
    from dmcnet_tpu_torch.cli import train as train_cli
    from dmcnet_tpu_torch.cli.train_options import build_parser
    from dmcnet_tpu_torch.models.tsn import segment_consensus
    from dmcnet_tpu_torch.parallel import fsdp, mesh, multihost
    from dmcnet_tpu_torch.serving import DMCPredictor
    from dmcnet_tpu_torch.train import checkpoints as tckpt
    from dmcnet_tpu_torch.train import engine
    from dmcnet_tpu_torch.train import optimizers as topt
    from dmcnet_tpu_torch.train.engine_gan import make_gan_train_steps

    phase("dist")
    t_phase = time.perf_counter()
    args = build_parser().parse_args(TRAIN_RECIPE + LOOP_FLAGS + [
        "--model-prefix", os.path.join(workdir, "dist")])
    gan_args = build_parser(gan=True).parse_args(GAN_RECIPE + LOOP_FLAGS)
    pool, batch, val_batch = _recipe_setup(torch, dev, gops, args)
    cache = _filled_cache(torch, dev, pool)
    bt.backtrace_warp_batch.launches = 0
    bt.backtrace_gop_cells.launches = 0

    dist.init_process_group("cpu:gloo,cuda:nccl",
                            init_method=f"tcp://localhost:{_free_port()}",
                            world_size=1, rank=0)
    try:
        print(f"  process group: {dist.get_backend()}, world size "
              f"{dist.get_world_size()}")

        def build(kind, gan=False):
            """A seeded model of `kind` (plain, dp, fsdp) on the card and
            its optimizers; call `.to(dtype)` through `dtype`."""
            def make(dtype=torch.float32):
                a = gan_args if gan else args
                model = train_cli.build_model(a, NUM_CLASS, SIZE)
                if gan:
                    _dropout_off(torch, model)
                model = model.to(dev, dtype)
                if kind != "plain":
                    mesh.use_global_batchnorm(model)
                if kind == "fsdp":
                    fsdp.shard_model(model)
                opts = topt.make_optimizers(
                    model, a.lr_cls_mult, a.lr_mse_mult,
                    a.lr_d_mult if gan else None)
                topt.adjust_learning_rate(opts, a.lr, a.weight_decay)
                if kind == "fsdp":
                    fsdp.loop_optimizers(opts)
                if kind != "plain":
                    mesh.sync_gradients(opts)
                return model, opts
            return make

        kw = dict(num_segments=SEGMENTS, lr_cls_w=args.lr_cls,
                  lr_mse_w=args.lr_mse, loss_mse=args.loss_mse)

        def train_step(model, opts):
            return engine.make_train_step(model, *opts, **kw)

        def gan_steps(model, opts):
            return make_gan_train_steps(
                model, *opts, num_segments=SEGMENTS, lr_cls_w=gan_args.lr_cls,
                lr_adv_g=gan_args.lr_adv_g, lr_adv_d=gan_args.lr_adv_d,
                lr_mse_w=gan_args.lr_mse, loss_mse=gan_args.loss_mse)

        # (a) plain, data-parallel and FSDP2 steps on the same seeded
        # weights and batch; a GAN D and G step plain and data-parallel
        n = CHECK_VIDEOS
        cases = (("dmcnet", ("plain", "dp", "fsdp"), False),
                 ("gan", ("plain", "dp"), True))
        for name, kinds, gan in cases:
            for dtype in (torch.float32, torch.float64):
                small = {k: v[:n].to(dtype) if v.is_floating_point() else
                         v[:n] for k, v in batch.items()}
                got = {}
                for kind in kinds:
                    model, opts = build(kind, gan)(dtype)
                    if gan:
                        d, g = gan_steps(model, opts)
                        m = {**{"D " + k: v for k, v in d(small).items()},
                             **{"G " + k: v for k, v in g(small).items()}}
                    else:
                        m = train_step(model, opts)(small, True)
                    got[kind] = ({k: float(v) for k, v in m.items()},
                                 fsdp.gather_state(model))
                want, want_sd = got["plain"]
                for kind in kinds[1:]:
                    m, sd = got[kind]
                    for k, w in want.items():
                        check(abs(m[k] - w) <= TRAIN_LOSS_RTOL * abs(w),
                              f"{name} {kind} {k} ({dtype}): {m[k]} != "
                              f"plain {w}")
                    if dtype == torch.float64:
                        _state_close(torch, want_sd, sd,
                                     f"{name} {kind} vs plain")
                loss = "D loss" if gan else "loss"
                print(f"  {name}, {n} videos x {SEGMENTS} at {SIZE}, "
                      f"{str(dtype)[6:]}: " + ", ".join(
                          f"{kind} {loss} {got[kind][0][loss]:.7f}"
                          for kind in kinds)
                      + "; agree: every metric (rtol "
                      f"{TRAIN_LOSS_RTOL})" + (
                          f", parameters and BN statistics (rtol "
                          f"{TRAIN_PARAM_RTOL}, atol {TRAIN_PARAM_ATOL})"
                          if dtype == torch.float64 else ""))

        # (b) step times and peak memory at the recipe's batch, fp32
        def timed(kind, gan):
            model, opts = build(kind, gan)()
            if gan:
                d, g = gan_steps(model, opts)
                fn = lambda: (d(batch), g(batch))  # noqa: E731
            else:
                step = train_step(model, opts)
                fn = lambda: step(batch, True)  # noqa: E731
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ms = median_ms(fn, TRAIN_TIMED_STEPS, torch)
            return {"ms": ms, "peak_bytes": torch.cuda.max_memory_allocated()}

        # each model freed before the next is built: the peaks are its own
        timing = {f"{name}_{kind}": timed(kind, gan)
                  for name, kinds, gan in cases for kind in kinds}
        print(f"  step times on {smi} (medians of {TRAIN_TIMED_STEPS}, CUDA "
              f"events, fp32, TF32 off, {BATCH} x {SEGMENTS} clips; GAN: a "
              "D + G pair): " + ", ".join(
                  f"{k} {v['ms']:.3f} ms / {v['peak_bytes'] / 2**30:.3f} "
                  "GiB peak" for k, v in timing.items()))

        # (c) the cli.train loop with each directory backend
        train_ds = synthetic_dataset(pool, 2 * BATCH, True, dev, cache,
                                     flow_from_mv=True)
        val_ds = synthetic_dataset(pool, BATCH, False, dev, cache,
                                   flow_from_mv=True)
        train_cli.SAVE_FREQ = 1
        loops = {}
        for backend in ("orbax", "orbax-async"):
            a = build_parser().parse_args(TRAIN_RECIPE + LOOP_FLAGS + [
                "--ckpt-backend", backend, "--model-prefix",
                os.path.join(workdir, backend)])
            t0 = time.perf_counter()
            result = train_cli.train(a, train_ds, val_ds, device=dev,
                                     input_size=SIZE)
            torch.cuda.synchronize()
            directory = result.checkpoint
            check(tckpt._committed_steps(directory) == [1, 2],
                  f"{backend}: committed steps "
                  f"{tckpt._committed_steps(directory)}")
            loops[backend] = {
                "loop_s": time.perf_counter() - t0,
                "save_block_s": result.saves,
                "step_bytes": _dir_bytes(os.path.join(directory, "2")),
                "dir": directory, "model": result.model}
            print(f"  cli.train --ckpt-backend {backend} (2 epochs x 2 "
                  f"batches): loop {loops[backend]['loop_s']:.2f} s; the "
                  "loop blocked, per save, on the checkpoint / the best "
                  "copy for " + ", ".join(
                      f"epoch {t['epoch']} {t['checkpoint_s'] * 1e3:.1f} / "
                      + ("-" if t["best_s"] is None else
                         f"{t['best_s'] * 1e3:.1f}") + " ms"
                      + (" (best)" if t["is_best"] else "")
                      for t in result.saves)
                  + f" (host clock); a step directory holds "
                  f"{loops[backend]['step_bytes'] / 2**20:.2f} MiB")

        # (d) a torn step, skipped by --auto-resume
        directory = loops["orbax-async"]["dir"]
        os.makedirs(os.path.join(directory, "3", "state"))
        with open(os.path.join(directory, "3", "meta.pkl"), "wb") as f:
            pickle.dump({"epoch": 3}, f)
        a = build_parser().parse_args(TRAIN_RECIPE + LOOP_FLAGS + [
            "--ckpt-backend", "orbax-async", "--epochs", "3",
            "--auto-resume", "1", "--model-prefix",
            os.path.join(workdir, "orbax-async")])
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            result = train_cli.train(a, train_ds, val_ds, device=dev,
                                     input_size=SIZE)
        check(f"--auto-resume: found {directory}" in out.getvalue()
              and "(epoch 2)" in out.getvalue(),
              "--auto-resume did not resume from the committed step 2")
        check([e["epoch"] for e in result.epochs] == [2],
              f"resumed epochs {[e['epoch'] for e in result.epochs]}")
        check(tckpt._committed_steps(directory) == [2, 3],
              f"after the resume: {tckpt._committed_steps(directory)}")
        print("  torn step 3 (meta.pkl, no commit) planted: --auto-resume "
              "resumed from step 2, trained epoch 2 and committed step 3 "
              "in its place")

        # (e) the directory scored and served, card against CPU
        test_list = os.path.join(workdir, "test_list.txt")
        with open(test_list, "w") as f:
            f.writelines(f"synthetic/{v}.avi 0 {v % NUM_CLASS}\n"
                         for v in range(GAN_TEST_VIDEOS))
        real_dataset = test_cli.CoviarDataset
        test_cli.CoviarDataset = lambda **kw: synthetic_dataset(
            pool, GAN_TEST_VIDEOS, False, dev, cache, flow_from_mv=True,
            num_segments=kw["num_segments"])
        scored = []
        try:
            for device in (str(dev), "cpu"):
                scores = os.path.join(workdir, f"dist_scores_{len(scored)}")
                with contextlib.redirect_stdout(io.StringIO()):
                    test_cli.main(DIST_TEST_MODEL + [
                        "--test-list", test_list, "--weights", directory,
                        "--test_segments", "3", "--test-crops", "10",
                        "--input_size", str(SIZE), "--save-scores", scores,
                        "--device", device])
                with np.load(scores + ".npz", allow_pickle=True) as data:
                    scored.append(np.stack([x[0] for x in data["scores"]]))
        finally:
            test_cli.CoviarDataset = real_dataset
        check(scored[0].shape == (GAN_TEST_VIDEOS, 1, NUM_CLASS)
              and np.isfinite(scored[0]).all(), "cli.test scores")
        check(np.allclose(scored[0], scored[1], rtol=LOGIT_RTOL,
                          atol=LOGIT_ATOL), "cli.test scores: card != CPU")
        logits = []
        for device in (dev, "cpu"):
            pred = DMCPredictor.from_checkpoint(directory,
                                                num_class=NUM_CLASS,
                                                device=device)
            with torch.inference_mode():
                logits.append(pred.model.classify(pred.model.generate(
                    val_batch["mv"][:n].to(device),
                    val_batch["residual"][:n].to(device))).cpu())
        check(bool(torch.isfinite(logits[0]).all())
              and tuple(segment_consensus(logits[0], SEGMENTS).shape)
              == (n, NUM_CLASS), "served logits")
        check(torch.allclose(logits[0], logits[1], rtol=LOGIT_RTOL,
                             atol=LOGIT_ATOL), "served logits: card != CPU")
        print(f"  the directory scored by cli.test --weights "
              f"({GAN_TEST_VIDEOS} videos x 3 x 10 crops; max |card - CPU| "
              f"{float(np.abs(scored[0] - scored[1]).max()):.3g}) and served "
              f"by DMCPredictor.from_checkpoint ({n} videos; max |card - "
              f"CPU| {float((logits[0] - logits[1]).abs().max()):.3g}), "
              f"rtol {LOGIT_RTOL}, atol {LOGIT_ATOL}")
    finally:
        tckpt.wait_for_checkpoints()
        multihost.shutdown()
    launches = {"backtrace_warp_batch": bt.backtrace_warp_batch.launches,
                "backtrace_gop_cells": bt.backtrace_gop_cells.launches}
    print(f"  launches around the phase: {launches} (no TPU kernel lies on "
          "the parallel or checkpoint path)")
    check(not any(launches.values()), "the dist phase launched B1 or B2")
    phase_s = time.perf_counter() - t_phase
    print(f"  dist phase {phase_s:.1f} s")
    return {"timing": timing, "loops": {
        k: {x: v[x] for x in ("loop_s", "save_block_s", "step_bytes")}
        for k, v in loops.items()}, "launches": launches,
        "phase_s": phase_s}


def synthetic_clip_dataset(pool, num_videos, clip_length, device, cache):
    """A `VideoClipDataset` over synthetic GOPs instead of decoded video:
    its own sampling, retries and item contract ((T, H, W, 7) uint8 clip,
    label), with each GOP's raw MV and residual (accumulate 0) computed on
    the card by `codec.accumulate.gop_mv_residual` and u8-encoded on the
    host once, as `GopCache` encodes them (min-max bound 20).  Video v has
    label v % NUM_CLASS and 21 GOPs; its GOP k is pool GOP (label + k) %
    len(pool).  The flow channels are the u8 MV of the GOP's next position,
    so that they vary: a training step's MSE target and the discriminator's
    real frames are then not a constant 128, the flow of a clip without
    flow files."""
    from dmcnet_tpu_torch.codec.accumulate import gop_mv_residual
    from dmcnet_tpu_torch.data.dmc_dataset import _encode_u8
    from dmcnet_tpu_torch.data.lists import VideoItem
    from dmcnet_tpu_torch.data.sampling import RandomSampling
    from dmcnet_tpu_torch.data.video_iter import VideoClipDataset

    class SyntheticClipDataset(VideoClipDataset):
        def _frame(self, item, frame_idx):
            gop_index, gop_pos = self.gop_position(frame_idx)
            k = (item.label + gop_index) % len(pool)
            if k not in cache:
                mv, res = gop_mv_residual(*pool[k], accumulate=False,
                                          device=device)
                cache[k] = (_encode_u8(mv.cpu().numpy(), MINMAX_BOUND),
                            _encode_u8(res.cpu().numpy()))
            mv_u8, res_u8 = cache[k]
            return np.concatenate([mv_u8[(gop_pos + 1) % len(mv_u8)],
                                   mv_u8[gop_pos], res_u8[gop_pos]], axis=-1)

    items = [VideoItem(f"synthetic/{v}.avi", v % NUM_CLASS, 21 * T)
             for v in range(num_videos)]
    return SyntheticClipDataset(items, RandomSampling(num=clip_length,
                                                      seed=0),
                                modality="flow+mp4", accumulate=False,
                                mv_minmaxnorm=True, gop=T)


def he_init(torch, net, seed):
    """Seeded He-normal weights N(0, 2 / fan_in) for every convolution and
    linear layer: under torch's default initialisation the ~20 ReLU layers
    of I3D shrink the clip's signal until the logits barely depend on it,
    and a card-vs-CPU check of the logits would see little."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for mod in net.modules():
            if isinstance(mod, (torch.nn.Conv2d, torch.nn.Conv3d,
                                torch.nn.Linear)):
                w = mod.weight
                w.copy_(torch.randn(w.shape, generator=gen)
                        * (2.0 / w[0].numel()) ** 0.5)
    return net


def i3d_flops(torch, net, x):
    """Operations of one I3D forward on x, counted from the layer shapes:
    2 x the multiply-adds of every convolution and linear layer (pools,
    BN and activations are left out).  Returns (generator, backbone)."""
    counts = {"gen": 0, "i3d": 0}
    hooks = []

    def hook(part):
        def fn(mod, inp, out):
            if isinstance(mod, torch.nn.Linear):
                macs = out.numel() * mod.in_features
            else:
                macs = out.numel() * (mod.in_channels // mod.groups) \
                    * int(np.prod(mod.kernel_size))
            counts[part] += 2 * macs
        return fn

    for name, mod in net.named_modules():
        if isinstance(mod, (torch.nn.Conv2d, torch.nn.Conv3d,
                            torch.nn.Linear)):
            part = "gen" if name.startswith("gen_flow_model") else "i3d"
            hooks.append(mod.register_forward_hook(hook(part)))
    with torch.no_grad():
        net(x, "flow+logit")
    for h in hooks:
        h.remove()
    return counts["gen"], counts["i3d"]


def i3d_phase(torch, bt, dev, gops, workdir):
    """10. I3D whole-video evaluation at the recipe's width, with its files
    in `workdir`."""
    import os

    from dmcnet_tpu_torch.cli import evaluate_video_i3d as eval_cli
    from dmcnet_tpu_torch.data.video_iter import (
        I3DBatchAssembler,
        i3d_augment_batch,
    )
    from dmcnet_tpu_torch.models.i3d import get_symbol
    from dmcnet_tpu_torch.train import engine_i3d

    phase("i3d")
    t0 = time.perf_counter()
    args = eval_cli.build_parser().parse_args(I3D_FLAGS + [
        "--load-weights", os.path.join(workdir, "i3d.pth"),
        "--data-root", workdir, "--video-prefix", workdir])
    pool = [gops[k][1:] for k in ("16x16 blocks", "8x8 blocks",
                                  "4x4 blocks")]
    cache = {}
    torch.manual_seed(0)
    net, conf = get_symbol("I3D", modality=args.modality,
                           num_classes=NUM_CLASS,
                           arch_estimator=args.arch_estimator,
                           input_size=SIZE)
    he_init(torch, net, 0)
    torch.save(net.state_dict(), args.load_weights)
    net = net.to(dev).eval()
    aug = dict(modality=args.modality, ds_factor=args.ds_factor,
               input_size=SIZE, mean=conf["mean"][0], std=conf["std"][0])
    step = engine_i3d.make_i3d_eval_step(net)

    # (a) two 16-frame clips, card against CPU, float32 with TF32 off
    check_ds = synthetic_clip_dataset(pool, 2, I3D_CHECK_T, dev, cache)
    raw = I3DBatchAssembler(check_ds, input_size=SIZE, is_train=False) \
        .batch([0, 1])
    got_b = i3d_augment_batch(raw, device=dev, **aug)
    want_b = i3d_augment_batch(raw, device="cpu", **aug)
    aug_err = max(float((got_b[k].cpu() - want_b[k]).abs().max())
                  for k in ("flow", "mv", "residual"))
    check(aug_err <= NORM_ATOL, f"i3d augment: card != CPU ({aug_err})")
    cpu_net = get_symbol("I3D", modality=args.modality,
                         num_classes=NUM_CLASS,
                         arch_estimator=args.arch_estimator)[0]
    cpu_net.load_state_dict(net.state_dict())
    with torch.no_grad():
        mv_res = torch.cat([got_b["mv"], got_b["residual"]], dim=1)
        logits, gen = net(mv_res, "flow+logit")
        c_logits, c_gen = cpu_net.eval()(mv_res.cpu(), "flow+logit")
    got = step(got_b)
    check(torch.equal(got["logits"], logits), "eval step != model forward")
    logit_err = float((logits.cpu() - c_logits).abs().max())
    gen_err = float((gen.cpu() - c_gen).abs().max())
    check(tuple(logits.shape) == (2, NUM_CLASS)
          and tuple(gen.shape) == (2, 2, I3D_CHECK_T, SIZE, SIZE),
          "i3d output shapes")
    spread = float((c_logits[0] - c_logits[1]).abs().max())
    check(spread > 100 * LOGIT_ATOL, "the two clips' logits barely differ: "
          "the check would not see the input")
    check(torch.allclose(logits.cpu(), c_logits, rtol=LOGIT_RTOL,
                         atol=LOGIT_ATOL), "i3d logits: card != CPU")
    check(torch.allclose(gen.cpu(), c_gen, rtol=LOGIT_RTOL,
                         atol=LOGIT_ATOL), "i3d gen_flow: card != CPU")
    print(f"  two {I3D_CHECK_T}-frame clips at {SIZE}, card vs CPU (fp32, "
          f"TF32 off): augment max |diff| {aug_err:.3g} (atol "
          f"{NORM_ATOL}); logits {logit_err:.3g} (max |logit| "
          f"{float(c_logits.abs().max()):.3g}, the clips' logits "
          f"{spread:.3g} apart), gen_flow {gen_err:.3g} (max |gen_flow| "
          f"{float(c_gen.abs().max()):.3g}); both rtol = atol = "
          f"{LOGIT_RTOL}")

    # (b) full-width times at T = I3D_T
    full_ds = synthetic_clip_dataset(pool, 2, I3D_T, dev, cache)
    asm = I3DBatchAssembler(full_ds, input_size=SIZE, is_train=False)
    t1 = time.perf_counter()
    raw = asm.batch([0])
    assemble_s = time.perf_counter() - t1
    check(raw["frames"].shape == (1, I3D_T, H, W, 7), "i3d clip shape")
    batch = i3d_augment_batch(raw, device=dev, **aug)
    mv_res = torch.cat([batch["mv"], batch["residual"]], dim=1)
    with torch.no_grad():
        gen = net.generate(mv_res)
    gen_flops, i3d_flops_ = i3d_flops(torch, net, mv_res)
    # the model's operations are the step's useful work; the augment's two
    # resampling contractions (W then H, B = 1) compute a centre crop, a
    # gather, and are counted apart as overhead
    aug_flops = 2 * I3D_T * 7 * SIZE * (H * W + H * SIZE)
    step_flops = gen_flops + i3d_flops_
    print(f"  set-up (model, synthetic datasets, card-vs-CPU check) "
          f"{time.perf_counter() - t0:.2f} s; one {I3D_T}-frame clip "
          f"assembled on the host in {assemble_s:.3f} s")
    print(f"  FLOPs at T={I3D_T}, {SIZE}² (2 x multiply-adds of the convs "
          f"and linears, from the layer shapes): generator "
          f"{gen_flops / 1e9:.1f} G, I3D backbone {i3d_flops_ / 1e9:.1f} G, "
          f"model (the step's useful work) {step_flops / 1e9:.1f} G; the "
          f"augment's resampling contractions {aug_flops / 1e9:.1f} G more, "
          "not counted in the shares below")
    timing = {}
    for label, tf32, bf16 in (("fp32", False, False), ("tf32", True, False),
                              ("bf16", False, True)):
        torch.backends.cudnn.allow_tf32 = tf32
        torch.backends.cuda.matmul.allow_tf32 = tf32
        ctx = (lambda: torch.autocast("cuda", dtype=torch.bfloat16)) \
            if bf16 else (lambda: torch.autocast("cuda", enabled=False))

        def t_step():
            b = i3d_augment_batch(raw, device=dev, **aug)
            with ctx():
                step(b)

        def generator():
            with torch.no_grad(), ctx():
                net.generate(mv_res)

        def backbone():
            with torch.no_grad(), ctx():
                net.features_to_logits(gen)

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        step_ms = median_ms(t_step, I3D_TIMED, torch)
        peak = torch.cuda.max_memory_allocated()
        gen_ms = median_ms(generator, I3D_TIMED, torch)
        i3d_ms = median_ms(backbone, I3D_TIMED, torch)
        aug_ms = median_ms(lambda: i3d_augment_batch(raw, device=dev, **aug),
                           I3D_TIMED, torch)
        share = step_flops / (step_ms * 1e-3) / PEAK_FLOPS[label]
        timing[label] = {"step_ms": step_ms, "generator_ms": gen_ms,
                         "backbone_ms": i3d_ms, "augment_ms": aug_ms,
                         "videos_per_s": 1e3 / step_ms,
                         "peak_bytes": peak, "resident_bytes": base,
                         "tflops": step_flops / (step_ms * 1e-3) / 1e12,
                         "peak_share": share}
        print(f"  {label}: eval step (host clip -> augment -> generator -> "
              f"I3D -> logits) {step_ms:.3f} ms = {1e3 / step_ms:.3f} "
              f"videos/s; augment (clip to the card, crop, normalize) "
              f"{aug_ms:.3f} ms, generator {gen_ms:.3f} ms, I3D backbone "
              f"{i3d_ms:.3f} ms (medians of {I3D_TIMED}, CUDA events); peak "
              f"memory {peak / 2**30:.3f} GiB ({base / 2**30:.3f} resident "
              "before the step); "
              f"model {step_flops / (step_ms * 1e-3) / 1e12:.2f} TFLOP/s = "
              f"{share * 100:.2f}% of the {label} peak "
              f"({PEAK_FLOPS[label] / 1e12:.0f} TFLOP/s)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    h2d_ms = median_ms(lambda: torch.from_numpy(raw["frames"]).to(dev),
                       I3D_TIMED, torch)
    print(f"  of the augment: the {raw['frames'].nbytes / 1e6:.1f} MB u8 clip "
          f"to the card (pageable) {h2d_ms:.3f} ms")
    del gen, mv_res, batch

    # (c) evaluate() over I3D_VIDEOS videos x 2 rounds, batch 1, its npz
    args.num_sample = 2
    args.score_file = os.path.join(workdir, "i3d_eval")
    rounds = []
    make_step = eval_cli.make_i3d_eval_step

    def recording_step(model):
        inner = make_step(model)

        def fn(b):
            out = inner(b)
            rounds.append((out["logits"].double().cpu().numpy(),
                           out["label"].cpu().numpy()))
            return out
        return fn

    eval_cli.make_i3d_eval_step = recording_step
    bt.backtrace_warp_batch.launches = 0
    bt.backtrace_gop_cells.launches = 0
    t1 = time.perf_counter()
    try:
        scores, labels, top1 = eval_cli.evaluate(
            args, synthetic_clip_dataset(pool, I3D_VIDEOS, I3D_T, dev,
                                         cache), device=dev)
    finally:
        eval_cli.make_i3d_eval_step = make_step
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t1
    launches = {"backtrace_warp_batch": bt.backtrace_warp_batch.launches,
                "backtrace_gop_cells": bt.backtrace_gop_cells.launches}
    with np.load(args.score_file + ".npz") as npz:
        check(sorted(npz.files) == ["labels", "scores", "top1"],
              f"npz keys {npz.files}")
        check(npz["scores"].shape == (I3D_VIDEOS, NUM_CLASS)
              and npz["scores"].dtype == np.float64, "npz scores")
        check(np.array_equal(npz["scores"], scores)
              and np.array_equal(npz["labels"], labels)
              and float(npz["top1"]) == top1, "npz differs from evaluate()")
    check(len(rounds) == 2 * I3D_VIDEOS, f"{len(rounds)} eval steps")
    per_round = np.concatenate([r[0] for r in rounds]).reshape(
        2, I3D_VIDEOS, NUM_CLASS)
    check(np.array_equal(scores, (per_round[0] + per_round[1]) / 2),
          "a video's score is not the mean of its two rounds' logits")
    check(list(labels) == [v % NUM_CLASS for v in range(I3D_VIDEOS)],
          "labels")
    want_top1 = 100.0 * float(np.mean(scores.argmax(1) == labels))
    check(top1 == want_top1, f"top-1 {top1} != {want_top1} from the scores")
    check(bool(np.isfinite(scores).all()), "non-finite scores")
    print(f"  evaluate(): {I3D_VIDEOS} videos x 2 rounds at T={I3D_T} in "
          f"{eval_s:.2f} s (host clock, clip assembly included); npz "
          f"{{scores {scores.shape} float64, labels, top1}}; each score the "
          f"mean of its two rounds' logits; top-1 {top1:.1f}% agrees with "
          f"the scores; launches on the I3D path {launches} (no TPU kernel "
          "lies on it)")

    # (d) a reference-layout .pth through --load-weights, bit-equal logits;
    # an RGB model's 3-channel stem adapted
    with torch.no_grad():
        want = net(torch.cat([got_b["mv"], got_b["residual"]], dim=1),
                   "flow+logit")[0]
    ref_path = os.path.join(workdir, "hmdb_1_ep-0010.pth")
    torch.save({"epoch": 10, "state_dict": {
        "module." + k: v.cpu() for k, v in net.state_dict().items()}},
        ref_path)
    net2 = get_symbol("I3D", modality=args.modality, num_classes=NUM_CLASS,
                      arch_estimator=args.arch_estimator)[0]
    eval_cli.load_weights(net2, ref_path, args.modality)
    net2 = net2.to(dev).eval()
    with torch.no_grad():
        again = net2(torch.cat([got_b["mv"], got_b["residual"]], dim=1),
                     "flow+logit")[0]
    check(torch.equal(again, want), "reloaded .pth logits differ")
    torch.manual_seed(1)
    rgb = he_init(torch, get_symbol(
        "I3D", modality="rgb", num_classes=NUM_CLASS,
        arch_estimator=args.arch_estimator)[0], 1)
    rgb_path = os.path.join(workdir, "i3d_rgb.pth")
    torch.save({"state_dict": rgb.state_dict()}, rgb_path)
    eval_cli.load_weights(net2, rgb_path, args.modality)
    stem = net2.conv3d_1a_7x7.conv3d.weight.cpu()
    rgb_stem = rgb.conv3d_1a_7x7.conv3d.weight
    check(tuple(stem.shape) == (64, 2, 7, 7, 7)
          and torch.equal(stem, rgb_stem.mean(1, keepdim=True)
                          .expand(-1, 2, -1, -1, -1)),
          "3-channel stem not channel-meaned")
    print("  reference-layout .pth (module. prefix) reloaded through "
          "--load-weights: logits bit-equal on the card; an RGB model's "
          "3-channel stem channel-meaned onto the 2-channel one")
    print(f"  i3d phase {time.perf_counter() - t0:.1f} s")
    return {"timing": timing, "flops": {"generator": gen_flops,
                                        "backbone": i3d_flops_,
                                        "augment": aug_flops},
            "check": {"augment": aug_err, "logits": logit_err,
                      "gen_flow": gen_err},
            "h2d_ms": h2d_ms, "clip_assemble_s": assemble_s,
            "evaluate_s": eval_s, "phase_s": time.perf_counter() - t0,
            "launches": launches}


def i3d_train_phase(torch, bt, dev, gops, smi, workdir):
    """11. I3D training at the width of examples/i3d/train.sh (its
    --pretrained_3d file is not in the repository: the weights are seeded
    He-normal), with its files in `workdir`: a D and a G macro step on the
    card against the CPU, D- and G-phase microstep times in fp32, TF32 and
    bf16, one 32-microbatch D and G macro step, the `cli.train_i3d` loop
    through the stage-2 swap, its checkpoint scored by
    `evaluate_video_i3d` on the card and the CPU.  Returns the numbers for
    the summary line."""
    import os

    from dmcnet_tpu_torch.cli import evaluate_video_i3d as eval_cli
    from dmcnet_tpu_torch.cli import train_i3d
    from dmcnet_tpu_torch.data.video_iter import (
        I3DBatchAssembler,
        i3d_augment_batch,
    )
    from dmcnet_tpu_torch.train.engine_i3d import make_i3d_steps
    from dmcnet_tpu_torch.train.optimizers import make_i3d_optimizers

    phase("i3d_train")
    t_phase = time.perf_counter()
    args = train_i3d.autofill(train_i3d.build_parser().parse_args(
        I3D_TRAIN_FLAGS + ["--model-dir", workdir, "--task-name", "i3d"]))
    pool = [gops[k][1:] for k in ("16x16 blocks", "8x8 blocks",
                                  "4x4 blocks")]
    cache = {}
    # the recipe's stage-1 step (--epoch-thre 6): base layers frozen, the
    # classifier at lr1 = 0 under --detach, full backward
    lrs = (args.lr_base, 0.0, args.lr_d, train_i3d.WEIGHT_DECAY)

    def build(size, dropout=True):
        net = he_init(torch, train_i3d.build_model(args, NUM_CLASS,
                                                   size)[0], 0)
        if not dropout:
            net.dropout.p = 0.0
            _dropout_off(torch, net)
        return net

    def steps_of(model, bf16=False):
        opts = make_i3d_optimizers(model, optim=args.optimizer, lr_mul=0.5,
                                   has_gan=True, freeze_base=True)
        return make_i3d_steps(model, opts, adv=args.adv, bf16=bf16)

    def split(b):
        return [{k: v[i] for k, v in b.items()}
                for i in range(b["label"].shape[0])]

    # (a) a D and a G macro step of 2 microbatches, card against CPU
    t, size = I3D_CHECK_T, I3D_CHECK_SIZE
    check_ds = synthetic_clip_dataset(pool, 2, t, dev, cache)
    asm = I3DBatchAssembler(check_ds, input_size=size, is_train=True, seed=0)
    micros = [i3d_augment_batch(asm.batch([i]), ds_factor=args.ds_factor,
                                input_size=size, device="cpu")
              for i in range(2)]
    # stacked on a leading microbatch axis, which `split` undoes
    micro = {k: torch.stack([m[k] for m in micros]) for k in micros[0]}

    def d_then_g(model, b):
        d_step, g_step = steps_of(model)
        return {**{"D " + k: v for k, v in d_step(split(b), *lrs,
                                                   True).items()},
                **{"G " + k: v for k, v in g_step(split(b), *lrs,
                                                   True).items()}}

    _card_vs_cpu(torch, dev, micro, lambda: build(size, dropout=False),
                 d_then_g, "D + G macro step, dropout off",
                 ("D loss", "G loss"),
                 desc=f"2 microbatches of 1 clip x {t} frames at {size}²")

    # (b) microstep times at the recipe's width: one microbatch of
    # I3D_TRAIN_B clips x I3D_TRAIN_T frames, resident on the card
    train_ds = synthetic_clip_dataset(pool, I3D_STAGED * I3D_TRAIN_B,
                                      I3D_TRAIN_T, dev, cache)
    asm = I3DBatchAssembler(train_ds, input_size=SIZE, is_train=True, seed=0)
    t0 = time.perf_counter()
    staged = [asm.batch(range(i * I3D_TRAIN_B, (i + 1) * I3D_TRAIN_B))
              for i in range(I3D_STAGED)]
    stage_s = time.perf_counter() - t0
    n_clips = I3D_STAGED * I3D_TRAIN_B
    print(f"  host assembly of {n_clips} clips of {I3D_TRAIN_T} frames "
          f"({I3D_STAGED} microbatches of {I3D_TRAIN_B}, one thread): "
          f"{stage_s:.3f} s = {stage_s / n_clips:.3f} s a clip (host clock)")
    aug = dict(ds_factor=args.ds_factor, input_size=SIZE, device=dev)
    resident = i3d_augment_batch(staged[0], **aug)
    model = build(SIZE).to(dev)

    def timed(bf16):
        d_step, g_step = steps_of(model, bf16=bf16)
        return {"d_microstep": lambda: d_step([resident], *lrs, True),
                "g_microstep": lambda: g_step([resident], *lrs, True)}

    timing = _precision_times(torch, timed, ("d_microstep", "g_microstep"),
                              smi, clips=I3D_TRAIN_B)

    # (c) one whole macro step of each kind: I3D_TRAIN_ITER microbatches
    # cut from the staged clips in turn, each to the card and augmented
    # there, as the command feeds them
    d_step, g_step = steps_of(model)
    macro = {}
    for name, fn in (("d", d_step), ("g", g_step)):
        feed = (i3d_augment_batch(staged[i % I3D_STAGED], **aug)
                for i in range(I3D_TRAIN_ITER))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        resident_bytes = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        m = fn(feed, *lrs, True)
        loss = float(m["loss"])
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t0
        check(np.isfinite(loss), f"{name} macro step loss {loss}")
        clips = I3D_TRAIN_ITER * I3D_TRAIN_B
        macro[name] = {"ms": step_s * 1e3, "clips_per_s": clips / step_s,
                       "peak_bytes": torch.cuda.max_memory_allocated(),
                       "resident_bytes": resident_bytes, "loss": loss}
        print(f"  {name.upper()} macro step ({I3D_TRAIN_ITER} microbatches x "
              f"{I3D_TRAIN_B} clips x {I3D_TRAIN_T} frames at {SIZE}², fp32, "
              f"each microbatch from the host): {step_s * 1e3:.1f} ms = "
              f"{clips / step_s:.2f} clips/s (host clock); peak memory "
              f"{macro[name]['peak_bytes'] / 2**30:.3f} GiB "
              f"({resident_bytes / 2**30:.3f} resident before it); loss "
              f"{loss:.5f}")
    del model, d_step, g_step, resident, staged

    # (d) the cli.train_i3d loop: 2 epochs x 2 macro steps (D, G) at
    # --iter-size 2, the stage-2 swap at --epoch-thre 1
    loop_args = train_i3d.autofill(train_i3d.build_parser().parse_args(
        I3D_TRAIN_FLAGS + I3D_LOOP_FLAGS + ["--model-dir", workdir,
                                            "--task-name", "loop"]))
    loop_args.score_dir = os.path.join(workdir, "score")
    loop_train = synthetic_clip_dataset(
        pool, 2 * I3D_TRAIN_B * I3D_LOOP_ITER, I3D_TRAIN_T, dev, cache)
    loop_val = synthetic_clip_dataset(pool, I3D_TRAIN_B, I3D_TRAIN_T, dev,
                                      cache)
    bt.backtrace_warp_batch.launches = 0
    bt.backtrace_gop_cells.launches = 0
    t0 = time.perf_counter()
    result = train_i3d.train(loop_args, loop_train, loop_val, device=dev,
                             input_size=SIZE)
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    launches = {"backtrace_warp_batch": bt.backtrace_warp_batch.launches,
                "backtrace_gop_cells": bt.backtrace_gop_cells.launches}
    check(len(result.epochs) == 2, "the loop did not run 2 epochs")
    check(result.optimizers["gf"].param_groups[0]["eps"] == 1e-3,
          "the loop did not swap to the stage-2 optimizers")
    for e in result.epochs:
        print(f"  loop epoch {e['epoch']}: data time {e['data_time']:.4f} s, "
              f"batch time {e['batch_time']:.4f} s (averages over a D and a "
              "G macro step, host clock)")
    print(f"  loop: 2 epochs with evaluation and the stage-2 swap in "
          f"{loop_s:.2f} s; launches in the loop {launches} (no TPU kernel "
          "lies on it: the clips accumulate on the host)")
    check(launches == {"backtrace_warp_batch": 0, "backtrace_gop_cells": 0},
          f"the I3D training loop launched {launches}")

    # (e) its checkpoint through evaluate_video_i3d --load-weights, on the
    # card and on the CPU
    ckpt = result.checkpoint
    check(ckpt is not None and os.path.exists(ckpt), "no checkpoint written")
    eval_args = eval_cli.build_parser().parse_args(I3D_FLAGS + [
        "--clip-length", str(I3D_CHECK_T), "--load-weights", ckpt,
        "--data-root", workdir, "--video-prefix", workdir])
    scored = []
    for device in (dev, "cpu"):
        t0 = time.perf_counter()
        scores, _, top1 = eval_cli.evaluate(
            eval_args, synthetic_clip_dataset(pool, 2, I3D_CHECK_T, dev,
                                              cache), device=device)
        scored.append((scores, top1, time.perf_counter() - t0))
    (s_card, top1_card, t_card), (s_cpu, top1_cpu, t_cpu) = scored
    check(s_card.shape == (2, NUM_CLASS) and np.isfinite(s_card).all(),
          "evaluate scores")
    check(np.allclose(s_card, s_cpu, rtol=LOGIT_RTOL, atol=LOGIT_ATOL),
          "the trained checkpoint's scores: card != CPU")
    print(f"  {os.path.basename(ckpt)} through evaluate_video_i3d "
          f"--load-weights (every key filled): 2 videos x {I3D_CHECK_T} "
          f"frames, scores max |card - CPU| "
          f"{float(np.abs(s_card - s_cpu).max()):.3g} (rtol = atol = "
          f"{LOGIT_RTOL}), top-1 {top1_card:.1f}% / {top1_cpu:.1f}%; "
          f"{t_card:.2f} s card, {t_cpu:.2f} s CPU")
    phase_s = time.perf_counter() - t_phase
    print(f"  i3d_train phase {phase_s:.1f} s")
    return {"timing": timing, "macro": macro, "stage_assemble_s": stage_s,
            "epochs": [{k: e[k] for k in ("epoch", "data_time",
                                          "batch_time")}
                       for e in result.epochs], "loop_s": loop_s,
            "launches": launches, "eval_card_s": t_card,
            "eval_cpu_s": t_cpu, "phase_s": phase_s}


def mesh_phase(torch, bt, pred, rows, outputs, cards, smi, workdir):
    """5b. Serving over every visible card (`DMCPredictor(mesh=...)`, a
    replica on each): the main path's 64-GOP chunk split over the cards,
    each share back-traced by B1 on its card, every share launched before
    any is read; its u8 outputs bit-equal to the one-card predictor's and
    its logits within the serving tolerance; the chunk's ms beside the
    one-card chunk's; `serve --mesh-devices 1` once over synthetic videos.
    Returns the numbers and B1's launches on the two mesh paths."""
    import contextlib
    import io
    import os

    from dmcnet_tpu_torch.cli import serve as serve_cli
    from dmcnet_tpu_torch.serving import DMCPredictor

    phase("mesh")
    count = len(cards)
    mesh_pred = DMCPredictor(pred.model.state_dict(), num_class=NUM_CLASS,
                             arch="resnet18", arch_estimator="DenseNetTiny",
                             gen_flow_or_delta=1, mv_minmaxnorm=1,
                             input_size=SIZE, mesh=cards)
    logits, mv_u8, res_u8 = (o.cpu().numpy() for o in outputs)
    bt.backtrace_warp_batch.launches = 0
    parts = mesh_pred._launch(rows, G, T, H, W, CELL, PICKS)
    m_logits, m_mv, m_res = mesh_pred.gather_outputs(parts)
    launches = bt.backtrace_warp_batch.launches
    shares = mesh_pred._shares(G)
    print(f"  mesh over {cards}: shares of the {G}-GOP chunk "
          f"{[b - a for _, a, b in shares]}; backtrace_warp_batch launches "
          f"= {launches}")
    check(launches == len(shares), "the mesh path did not launch B1 once "
          "per card")
    check(np.array_equal(m_mv, mv_u8) and np.array_equal(m_res, res_u8),
          "mesh u8 outputs != the one-card predictor's")
    err = float(np.abs(m_logits - logits).max())
    check(np.allclose(m_logits, logits, rtol=SERVE_RTOL, atol=SERVE_ATOL),
          f"mesh logits != the one-card predictor's ({err})")
    print(f"  mv_u8 and res_u8 equal the one-card chunk's; logits max "
          f"|diff| {err:.3g} (rtol {SERVE_RTOL}, atol {SERVE_ATOL})")

    def chunk(p):
        return [part[0].cpu() for part in p._launch(rows, G, T, H, W, CELL,
                                                    PICKS)]

    times = {"one_card_ms": host_ms(lambda: chunk(pred), 10, torch),
             "mesh_ms": host_ms(lambda: chunk(mesh_pred), 10, torch)}
    print(f"  chunk ({G} GOPs, {G * PICKS} clips; GOP rows packed, to the "
          f"card(s), logits back; host clock, median of 10, pack=True) on "
          f"{smi}: "
          f"one card {times['one_card_ms']:.3f} ms, mesh of {count} "
          f"{times['mesh_ms']:.3f} ms")

    # serve --mesh-devices 1 over 4 synthetic videos of 8 GOPs each: the
    # host gather is the one step swapped (no decoder on this machine)
    def gather(self, path, frames_per_gop, segments=None):
        v = int(os.path.basename(path).split(".")[0])
        sel = rows[8 * v:8 * (v + 1)]
        return ([(cm, c) for cm, c, *_ in sel],
                [(iframe, fp, T) for _, _, iframe, fp, _ in sel],
                [pk for *_, pk in sel], [len(pk) for *_, pk in sel],
                [np.ones(len(pk), np.float32) for *_, pk in sel], H, W)

    weights = os.path.join(workdir, "serve.pth")
    torch.save(pred.model.state_dict(), weights)
    paths = [f"synthetic/{v}.avi" for v in range(4)]
    real = DMCPredictor._gather_video_device
    DMCPredictor._gather_video_device = gather
    try:
        bt.backtrace_warp_batch.launches = 0
        with contextlib.redirect_stdout(io.StringIO()):
            scores = serve_cli.main([
                "--weights", weights, "--num-class", str(NUM_CLASS),
                "--input_size", str(SIZE), "--mesh-devices", str(count),
                "--backend", "device", "--chunk-gops", str(G), "--device",
                torch.device(cards[0]).type] + paths)
        serve_launches = bt.backtrace_warp_batch.launches
        want = pred.predict_videos(paths, backend="device", chunk_gops=G)
    finally:
        DMCPredictor._gather_video_device = real
    check(serve_launches >= 1, "serve --mesh-devices did not launch B1")
    for s, w in zip(scores, want):
        check(s.shape == (NUM_CLASS,) and np.isfinite(s).all()
              and np.allclose(s, w, rtol=SERVE_RTOL, atol=SERVE_ATOL),
              "serve --mesh-devices scores != the one-card predictor's")
    print(f"  serve --mesh-devices {count} over 4 synthetic videos x 8 GOPs: "
          f"B1 launches {serve_launches}; scores equal the one-card "
          f"predictor's within rtol {SERVE_RTOL}, atol {SERVE_ATOL}")
    return {"times": times, "launches": launches,
            "serve_launches": serve_launches}


def packed_phase(torch, bt, dev, gops, smi, workdir):
    """5c. The packed layer on its own: the generator over the main path's
    192 clips at 224² at s = 1, 2, 4 in bf16 and fp32, NCHW and
    channels_last (the serving folds on, output packed), each within
    PACK_TOL of s = 1 in fp32; `QuantizedPackedEstimator`'s int8 route (an
    int8 GEMM) bit-equal to its float64 route on 8 clips, within 5% of the
    float32 generator, and timed beside the bf16 packed generator on the
    same normalized input; one dmcnet train step at the HMDB-51 recipe's
    batch (40 x 3 at 224²) with --packed-gen 2 against 0, their losses
    within TRAIN_LOSS_RTOL in fp32 and PACKED_BF16_LOSS_RTOL in bf16.  B1
    counted around it (0; B2 launches only where the synthetic datasets
    accumulate their GOPs).  Returns the numbers."""
    import os

    from dmcnet_tpu_torch.cli import train as train_cli
    from dmcnet_tpu_torch.cli.train_options import build_parser
    from dmcnet_tpu_torch.ops import packed_generator as pg
    from dmcnet_tpu_torch.serving import DMCPredictor
    from dmcnet_tpu_torch.train import engine
    from dmcnet_tpu_torch.train import optimizers as topt

    phase("packed")
    t_phase = time.perf_counter()
    bt.backtrace_warp_batch.launches = 0
    bt.backtrace_gop_cells.launches = 0
    n = G * PICKS
    # the main path's weights (seed 0) and serving folds
    pred = DMCPredictor(num_class=NUM_CLASS, input_size=SIZE, device=dev,
                        seed=0)
    gen = pred.model.gen_flow_model
    affine = pred.packed[0].input_affine
    rng = torch.Generator(device=dev).manual_seed(0)
    raw = torch.randint(0, 256, (n, 5, SIZE, SIZE), device=dev,
                        generator=rng).float()

    # (a) the generator's layouts
    sweep, ref = {}, None
    print(f"  packed generator, {n} clips at {SIZE}², input_affine and "
          f"fuse_mv_delta on, output packed (median ms of 5, CUDA events) "
          f"on {smi}:")
    for s_ in (1, 2, 4):
        for dt_name, dt in (("fp32", torch.float32),
                            ("bf16", torch.bfloat16)):
            for fmt_name, fmt in (("nchw", torch.contiguous_format),
                                  ("channels_last", torch.channels_last)):
                m = pg.PackedDenseEstimator(
                    gen, s=s_, dtype=dt, packed_output=True,
                    fuse_mv_delta=True, input_affine=affine,
                    memory_format=fmt).to(dev)
                x = raw.to(dt)
                with torch.inference_mode():
                    out = pg.depth_to_space(m(x), s_).float()
                    if ref is None:
                        ref = out   # s = 1, fp32, NCHW
                    err = float((out - ref).abs().max())
                    scale = float(ref.abs().max())
                    check(err <= PACK_TOL * scale,
                          f"generator s={s_} {dt_name} {fmt_name} differs "
                          f"by {err}")
                    ms = median_ms(lambda: m(x), 5, torch)
                key = f"s{s_}_{dt_name}_{fmt_name}"
                sweep[key] = {"ms": ms, "max_abs_diff": err}
                print(f"    s={s_} {dt_name} {fmt_name}: {ms:.3f} ms "
                      f"({n / ms * 1e3:.1f} clips/s); max |diff| from s=1 "
                      f"fp32 NCHW {err:.3g} (max |cue| {scale:.3g})")
                del m, out
    del ref

    # (b) the int8 estimator on the normalized input
    scale_t = torch.as_tensor(np.asarray(affine[0], np.float32), device=dev)
    shift_t = torch.as_tensor(np.asarray(affine[1], np.float32), device=dev)
    norm = raw * scale_t[:, None, None] + shift_t[:, None, None]
    quant = pg.QuantizedPackedEstimator(gen, norm[:8], s=2).to(dev)
    bf16_gen = pg.PackedDenseEstimator(gen, s=2, dtype=torch.bfloat16).to(
        dev)
    with torch.inference_mode():
        small = norm[:8]
        q_gemm = quant(small)
        q_f64 = quant(small, int_conv=pg.int_conv3x3_f64)
        check(torch.equal(q_gemm, q_f64),
              "the int8 GEMM route != the float64 route")
        want = gen(small)
        rel = {"int8": float((q_gemm - want).abs().mean()
                             / want.abs().mean()),
               "bf16": float((bf16_gen(small).float() - want).abs().mean()
                             / want.abs().mean())}
        check(rel["int8"] < 0.05, f"int8 generator {rel['int8']:.4f} from "
              "float32")
        norm_bf16 = norm.to(torch.bfloat16)
        quant_ms = {"int8_ms": median_ms(lambda: quant(norm), 5, torch),
                    "bf16_ms": median_ms(lambda: bf16_gen(norm_bf16), 5,
                                         torch)}
    print(f"  QuantizedPackedEstimator (s=2): int8 GEMM route bit-equal to "
          f"the float64 route on 8 clips; mean relative error from float32 "
          f"{rel['int8']:.4f} (bf16 packed {rel['bf16']:.4f}); {n} clips "
          f"int8 {quant_ms['int8_ms']:.3f} ms, bf16 packed "
          f"{quant_ms['bf16_ms']:.3f} ms (median of 5)")
    del norm, norm_bf16, raw, quant, bf16_gen, pred

    # (c) a dmcnet train step with --packed-gen 2 against 0
    argv = TRAIN_RECIPE + ["--model-prefix", os.path.join(workdir, "m")]
    args = {s_: build_parser().parse_args(argv + ["--packed-gen", s_])
            for s_ in ("0", "2")}
    _, batch, _ = _recipe_setup(torch, dev, gops, args["0"])
    train_steps = {}
    for label, bf16 in (("fp32", False), ("bf16", True)):
        row, losses = {}, {}
        for s_, a in args.items():
            model = train_cli.build_model(a, NUM_CLASS, SIZE).to(dev)
            opts = topt.make_optimizers(model, a.lr_cls_mult, a.lr_mse_mult)
            topt.adjust_learning_rate(opts, a.lr, a.weight_decay)
            step = engine.make_train_step(
                model, *opts, num_segments=SEGMENTS, lr_cls_w=a.lr_cls,
                lr_mse_w=a.lr_mse, loss_mse=a.loss_mse, bf16=bf16)
            losses[s_] = {k: float(v) for k, v in step(batch, True).items()
                          if k.startswith("loss")}
            row[f"packed_gen_{s_}_ms"] = median_ms(
                lambda: step(batch, True), TRAIN_TIMED_STEPS, torch)
            del model, opts, step
        rtol = PACKED_BF16_LOSS_RTOL if bf16 else TRAIN_LOSS_RTOL
        for k, w in losses["0"].items():
            g_ = losses["2"][k]
            check(abs(g_ - w) <= rtol * abs(w),
                  f"--packed-gen 2 {label} {k} {g_} != --packed-gen 0 {w}")
        row["losses"] = losses
        train_steps[label] = row
        print(f"  train step {BATCH} x {SEGMENTS} at {SIZE}², {label}: "
              f"--packed-gen 0 {row['packed_gen_0_ms']:.3f} ms, 2 "
              f"{row['packed_gen_2_ms']:.3f} ms (median of "
              f"{TRAIN_TIMED_STEPS}); losses " + ", ".join(
                  f"{k} {losses['0'][k]:.7f} / {losses['2'][k]:.7f}"
                  for k in losses["0"])
              + f" (rtol {rtol})")
    launches = {"backtrace_warp_batch": bt.backtrace_warp_batch.launches,
                "backtrace_gop_cells": bt.backtrace_gop_cells.launches}
    phase_s = time.perf_counter() - t_phase
    print(f"  launches in the phase {launches}; packed phase {phase_s:.1f} s")
    return {"generator": sweep, "quantized": {**quant_ms, "rel_err": rel},
            "train_step": train_steps, "launches": launches,
            "phase_s": phase_s}


def _gloo_pair_worker(rank, port, workdir, device="cuda"):
    """One of 2 gloo ranks on the one card: the time-sharded I3D forward on
    its half of the clip, and a tensor-parallel (1 x 2) dmcnet step in
    float64; writes rank<r>.pt to `workdir`."""
    import os

    import torch
    import torch.distributed as dist

    from dmcnet_tpu_torch.cli import train as train_cli
    from dmcnet_tpu_torch.cli.train_options import build_parser
    from dmcnet_tpu_torch.models.i3d import get_symbol
    from dmcnet_tpu_torch.parallel import mesh as pmesh
    from dmcnet_tpu_torch.parallel import tensor, temporal
    from dmcnet_tpu_torch.train import engine
    from dmcnet_tpu_torch.train import optimizers as topt

    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=2, rank=rank)
    out = {}
    try:
        shared = torch.load(os.path.join(workdir, "pair_in.pt"),
                            weights_only=True)
        net = get_symbol("I3D", modality="flow+mp4", num_classes=NUM_CLASS,
                         arch_estimator="DenseNetTiny", input_size=SIZE)[0]
        net.load_state_dict(shared["i3d"])
        net = net.to(dev).eval()
        frames = torch.load(os.path.join(workdir, f"frames{rank}.pt"),
                            weights_only=True).to(dev)
        shard = temporal.TimeShard()
        ranges = temporal.split_frames(I3D_T, 2)
        fr = temporal.Frames(frames, ranges)
        torch.cuda.reset_peak_memory_stats()
        logits, _ = temporal.time_sharded_forward(net, shard, fr)
        out["ms"] = median_ms(
            lambda: temporal.time_sharded_forward(net, shard, fr), 3, torch)
        out["peak_bytes"] = torch.cuda.max_memory_allocated()
        out["logits"] = logits.cpu()
        out["max_halo"] = shard.max_halo
        del net, frames, fr

        args = build_parser().parse_args(TRAIN_RECIPE)
        model = train_cli.build_model(args, NUM_CLASS, SIZE).to(
            dev, torch.float64)
        mesh2 = tensor.make_mesh_2d(1, 2, dev.type)
        names = tensor.shard_model_tp(model, mesh2)
        pmesh.use_global_batchnorm(model, mesh2["data"].get_group())
        opts = topt.make_optimizers(model, args.lr_cls_mult,
                                    args.lr_mse_mult)
        topt.adjust_learning_rate(opts, args.lr, args.weight_decay)
        for opt in opts:
            for group in opt.param_groups:
                group["foreach"] = False
        pmesh.sync_gradients(opts, mesh2["data"].get_group())
        batch = {k: v.to(dev) for k, v in shared["batch"].items()}
        m = engine.make_train_step(
            model, *opts, num_segments=SEGMENTS, lr_cls_w=args.lr_cls,
            lr_mse_w=args.lr_mse, loss_mse=args.loss_mse)(batch, True)
        out["tp_loss"] = float(m["loss"])
        out["tp_names"] = names
        out["tp_state"] = {k: (v.to_local() if hasattr(v, "to_local")
                               else v).detach().cpu()
                           for k, v in model.state_dict().items()}
    finally:
        dist.destroy_process_group()
    torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))


def parallel_phase(torch, bt, dev, gops, smi, workdir):
    """14. I3D training across processes, time-sharded I3D evaluation and
    tensor parallelism, on a world-size-1 process group
    (cpu:gloo,cuda:nccl), and 2 gloo ranks on the one card for the halo
    exchange and the sharded layers.  Returns the numbers for the summary
    line."""
    import contextlib
    import io
    import os

    import torch.distributed as dist
    import torch.multiprocessing as mp

    from dmcnet_tpu_torch.cli import train as train_cli
    from dmcnet_tpu_torch.cli import train_i3d
    from dmcnet_tpu_torch.cli.train_options import build_parser
    from dmcnet_tpu_torch.data.video_iter import (
        I3DBatchAssembler,
        i3d_augment_batch,
    )
    from dmcnet_tpu_torch.models.i3d import get_symbol
    from dmcnet_tpu_torch.parallel import fsdp, multihost, temporal, tensor
    from dmcnet_tpu_torch.parallel import mesh as pmesh
    from dmcnet_tpu_torch.train import checkpoints as tckpt
    from dmcnet_tpu_torch.train import engine
    from dmcnet_tpu_torch.train import optimizers as topt
    from dmcnet_tpu_torch.train.engine_i3d import make_i3d_steps
    from dmcnet_tpu_torch.train.optimizers import make_i3d_optimizers

    phase("parallel")
    t_phase = time.perf_counter()
    pool = [gops[k][1:] for k in ("16x16 blocks", "8x8 blocks",
                                  "4x4 blocks")]
    cache = {}
    args = train_i3d.autofill(train_i3d.build_parser().parse_args(
        I3D_TRAIN_FLAGS + ["--model-dir", workdir, "--task-name", "par"]))
    lrs = (args.lr_base, 0.0, args.lr_d, train_i3d.WEIGHT_DECAY)
    size, t = I3D_CHECK_SIZE, I3D_CHECK_T
    check_ds = synthetic_clip_dataset(pool, 2, t, dev, cache)
    asm = I3DBatchAssembler(check_ds, input_size=size, is_train=True, seed=0)
    check_micro = i3d_augment_batch(asm.batch([0, 1]),
                                    ds_factor=args.ds_factor,
                                    input_size=size, device=dev)
    full_ds = synthetic_clip_dataset(pool, I3D_TRAIN_B, I3D_TRAIN_T, dev,
                                     cache)
    full_micro = i3d_augment_batch(
        I3DBatchAssembler(full_ds, input_size=SIZE, is_train=True, seed=0)
        .batch(range(I3D_TRAIN_B)), ds_factor=args.ds_factor,
        input_size=SIZE, device=dev)
    clip_ds = synthetic_clip_dataset(pool, 1, I3D_T, dev, cache)
    raw = I3DBatchAssembler(clip_ds, input_size=SIZE, is_train=False) \
        .batch([0])
    eval_b = i3d_augment_batch(raw, ds_factor=16, input_size=SIZE,
                               device=dev)
    clip = torch.cat([eval_b["mv"], eval_b["residual"]], dim=1)
    del eval_b
    loop_train = synthetic_clip_dataset(
        pool, 2 * I3D_TRAIN_B * I3D_LOOP_ITER, I3D_TRAIN_T, dev, cache)
    loop_val = synthetic_clip_dataset(pool, I3D_TRAIN_B, I3D_TRAIN_T, dev,
                                      cache)
    for ds in (loop_train, loop_val):   # GOPs encoded before the counts
        for i in range(len(ds)):
            ds[i]
    # the dmcnet batches, and the GOPs of the tp loop's synthetic datasets
    # accumulated by B2 (the recipe's datasets accumulate on the host)
    targs = build_parser().parse_args(TRAIN_RECIPE + LOOP_FLAGS)
    tp_pool, batch, _ = _recipe_setup(torch, dev, gops, targs)
    tp_cache = _filled_cache(torch, dev, tp_pool)
    bt.backtrace_warp_batch.launches = 0
    bt.backtrace_gop_cells.launches = 0

    dist.init_process_group("cpu:gloo,cuda:nccl",
                            init_method=f"tcp://localhost:{_free_port()}",
                            world_size=1, rank=0)
    try:
        # (a) I3D: plain, data-parallel and FSDP2 D and G microsteps on the
        # same seeded weights and microbatch
        def build_i3d(kind, size, dtype=torch.float32):
            net = he_init(torch, train_i3d.build_model(args, NUM_CLASS,
                                                       size)[0], 0)
            net.dropout.p = 0.0
            _dropout_off(torch, net)
            net = net.to(dev, dtype)
            if kind != "plain":
                pmesh.use_global_batchnorm(net)
            if kind == "fsdp":
                fsdp.shard_model(net)
            opts = make_i3d_optimizers(net, optim=args.optimizer,
                                       lr_mul=0.5, has_gan=True,
                                       freeze_base=True)
            if kind == "fsdp":
                fsdp.loop_optimizers(opts.values())
            if kind != "plain":
                pmesh.sync_gradients(opts.values())
            return net, make_i3d_steps(net, opts, adv=args.adv)

        # at a small width, then at the recipe's microbatch
        kinds = ("plain", "dp", "fsdp")
        widths = ((check_micro, size, f"2 clips x {t} frames at {size}²"),
                  (full_micro, SIZE, f"{I3D_TRAIN_B} clips x {I3D_TRAIN_T} "
                   f"frames at {SIZE}²"))
        for (micro32, width, shape), dtype in itertools.product(
                widths, (torch.float32, torch.float64)):
            t_check = time.perf_counter()
            micro = {k: v.to(dtype) if v.is_floating_point() else v
                     for k, v in micro32.items()}
            got = {}
            for kind in kinds:
                net, (d_step, g_step) = build_i3d(kind, width, dtype)
                m = {**{"D " + k: float(v) for k, v in
                        d_step([micro], *lrs, True).items()},
                     **{"G " + k: float(v) for k, v in
                        g_step([micro], *lrs, True).items()}}
                got[kind] = (m, fsdp.gather_state(net))
                del net, d_step, g_step
            del micro
            want, want_sd = got["plain"]
            for kind in kinds[1:]:
                m, sd = got[kind]
                for k, w in want.items():
                    check(abs(m[k] - w) <= TRAIN_LOSS_RTOL * abs(w),
                          f"i3d {kind} {k} ({shape}, {dtype}): {m[k]} != "
                          f"plain {w}")
                if dtype == torch.float64:
                    _state_close(torch, want_sd, sd,
                                 f"i3d {kind} vs plain ({shape})")
            print(f"  I3D D + G microstep, {shape}, {str(dtype)[6:]}: "
                  + ", ".join(f"{kind} D loss {got[kind][0]['D loss']:.7f}"
                              for kind in kinds)
                  + f"; agree: every metric (rtol {TRAIN_LOSS_RTOL})" + (
                      f", parameters and BN statistics (rtol "
                      f"{TRAIN_PARAM_RTOL}, atol {TRAIN_PARAM_ATOL})"
                      if dtype == torch.float64 else "")
                  + f"; {time.perf_counter() - t_check:.1f} s")
            del got, want_sd
            torch.cuda.empty_cache()

        # (b) microstep times and peak memory at the recipe's microbatch
        timing = {}
        for kind in kinds:
            net, (d_step, g_step) = build_i3d(kind, SIZE)
            for name, fn in (("d", d_step), ("g", g_step)):
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                ms = median_ms(lambda: fn([full_micro], *lrs, True),
                               TRAIN_TIMED_STEPS, torch)
                timing[f"i3d_{kind}_{name}"] = {
                    "ms": ms, "peak_bytes": torch.cuda.max_memory_allocated()}
            del net, d_step, g_step
        print(f"  I3D microstep times on {smi} (medians of "
              f"{TRAIN_TIMED_STEPS}, CUDA events, fp32, TF32 off, "
              f"{I3D_TRAIN_B} clips x {I3D_TRAIN_T} frames at {SIZE}²): "
              + ", ".join(f"{k[4:]} {v['ms']:.3f} ms / "
                          f"{v['peak_bytes'] / 2**30:.3f} GiB peak"
                          for k, v in timing.items()))

        # (c) the cli.train_i3d loop with orbax-async, then --auto-resume
        loop_argv = I3D_TRAIN_FLAGS + I3D_LOOP_FLAGS + [
            "--model-dir", workdir, "--task-name", "dist", "--ckpt-backend",
            "orbax-async"]
        loop_args = train_i3d.autofill(train_i3d.build_parser().parse_args(
            loop_argv))
        loop_args.score_dir = os.path.join(workdir, "score")
        t0 = time.perf_counter()
        result = train_i3d.train(loop_args, loop_train, loop_val, device=dev,
                                 input_size=SIZE)
        torch.cuda.synchronize()
        loop_s = time.perf_counter() - t0
        directory = result.checkpoint
        check(tckpt.dcp_checkpoint_committed(directory)
              and directory.endswith("ep-0002.pth.orbax"),
              f"the loop's directory {directory}")
        resume_args = train_i3d.autofill(train_i3d.build_parser().parse_args(
            loop_argv + ["--end-epoch", "3", "--auto-resume", "1"]))
        resume_args.score_dir = loop_args.score_dir
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            resumed = train_i3d.train(resume_args, loop_train, loop_val,
                                      device=dev, input_size=SIZE)
        torch.cuda.synchronize()
        resume_s = time.perf_counter() - t0
        check("--auto-resume: epoch 2" in out.getvalue()
              and [e["epoch"] for e in resumed.epochs] == [2],
              "--auto-resume did not resume the I3D loop at epoch 2")
        print(f"  cli.train_i3d loop (--iter-size {I3D_LOOP_ITER}, 2 epochs "
              f"x 2 macro steps, --ckpt-backend orbax-async) {loop_s:.2f} s;"
              f" --auto-resume from epoch 2 trained epoch 2 in "
              f"{resume_s:.2f} s (host clock)")

        # (d) the time-sharded I3D forward at T = I3D_T on the world of 1
        net = he_init(torch, get_symbol(
            "I3D", modality="flow+mp4", num_classes=NUM_CLASS,
            arch_estimator="DenseNetTiny", input_size=SIZE)[0], 0)
        net = net.to(dev).eval()
        shard = temporal.TimeShard()
        fr = shard.scatter(clip)
        with torch.no_grad():
            want_logits, want_gen = net(clip, "flow+logit")
        logits, gen = temporal.time_sharded_forward(net, shard, fr)
        errs = (float((logits - want_logits).abs().max()),
                float((gen - want_gen).abs().max()))
        check(torch.allclose(logits, want_logits, rtol=LOGIT_RTOL,
                             atol=LOGIT_ATOL)
              and torch.allclose(gen, want_gen, rtol=LOGIT_RTOL,
                                 atol=LOGIT_ATOL),
              f"time-sharded forward != the unsharded one {errs}")
        shard_times = {}
        for name, fn in (("unsharded", lambda: net(clip, "flow+logit")),
                         ("sharded", lambda: temporal.time_sharded_forward(
                             net, shard, fr))):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            with torch.no_grad():
                ms = median_ms(fn, I3D_TIMED, torch)
            shard_times[name] = {
                "ms": ms, "peak_bytes": torch.cuda.max_memory_allocated()}
        print(f"  time-sharded I3D forward, one {I3D_T}-frame clip at "
              f"{SIZE}², world of 1: logits / gen_flow max |diff| "
              f"{errs[0]:.3g} / {errs[1]:.3g} from the unsharded forward "
              f"(rtol = atol = {LOGIT_RTOL}); on {smi} (medians of "
              f"{I3D_TIMED}, CUDA events, fp32): " + ", ".join(
                  f"{k} {v['ms']:.3f} ms / {v['peak_bytes'] / 2**30:.3f} "
                  "GiB peak" for k, v in shard_times.items()))

        # (e) tensor parallelism on a 1 x 1 mesh: every large layer through
        # the sharded forward (f, its channels, g) and DTensor weights
        mesh11 = tensor.make_mesh_2d(1, 1, torch.device(dev).type)

        def build_tp(kind, dtype=torch.float32):
            model = train_cli.build_model(targs, NUM_CLASS, SIZE).to(
                dev, dtype)
            names = []
            if kind == "tp":
                names = tensor.shard_model_tp(model, mesh11)
                pmesh.use_global_batchnorm(model,
                                           mesh11["data"].get_group())
            opts = topt.make_optimizers(model, targs.lr_cls_mult,
                                        targs.lr_mse_mult)
            topt.adjust_learning_rate(opts, targs.lr, targs.weight_decay)
            if kind == "tp":
                fsdp.loop_optimizers(opts)
                pmesh.sync_gradients(opts, mesh11["data"].get_group())
            return model, engine.make_train_step(
                model, *opts, num_segments=SEGMENTS, lr_cls_w=targs.lr_cls,
                lr_mse_w=targs.lr_mse, loss_mse=targs.loss_mse), names

        n = CHECK_VIDEOS
        for dtype in (torch.float32, torch.float64):
            small = {k: v[:n].to(dtype) if v.is_floating_point() else v[:n]
                     for k, v in batch.items()}
            got = {}
            for kind in ("plain", "tp"):
                model, step, names = build_tp(kind, dtype)
                got[kind] = (float(step(small, True)["loss"]),
                             fsdp.gather_state(model))
            check(abs(got["tp"][0] - got["plain"][0])
                  <= TRAIN_LOSS_RTOL * abs(got["plain"][0]),
                  f"tp loss {got['tp'][0]} != plain {got['plain'][0]}")
            if dtype == torch.float64:
                _state_close(torch, got["plain"][1], got["tp"][1],
                             "tp vs plain")
            print(f"  tensor-parallel dmcnet step (1 x 1 mesh, {len(names)} "
                  f"layers sharded), {n} videos x {SEGMENTS} at {SIZE}, "
                  f"{str(dtype)[6:]}: loss plain {got['plain'][0]:.7f} / tp "
                  f"{got['tp'][0]:.7f}" + (
                      f"; parameters and BN statistics agree (rtol "
                      f"{TRAIN_PARAM_RTOL}, atol {TRAIN_PARAM_ATOL})"
                      if dtype == torch.float64 else ""))
        pair_batch = {k: v[:n].double().cpu() if v.is_floating_point()
                      else v[:n].cpu() for k, v in batch.items()}
        plain64, step64, _ = build_tp("plain", torch.float64)
        plain_loss = float(step64({k: v.to(dev) for k, v in
                                   pair_batch.items()}, True)["loss"])
        plain_state = {k: v.cpu() for k, v in plain64.state_dict().items()}
        del plain64, step64, got
        tp_times = {}
        for kind in ("plain", "tp"):
            model, step, _ = build_tp(kind)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            tp_times[kind] = {
                "ms": median_ms(lambda: step(batch, True),
                                TRAIN_TIMED_STEPS, torch),
                "peak_bytes": torch.cuda.max_memory_allocated()}
            del model, step
        print(f"  dmcnet step times on {smi} (medians of "
              f"{TRAIN_TIMED_STEPS}, CUDA events, fp32, {BATCH} x "
              f"{SEGMENTS} clips): " + ", ".join(
                  f"{k} {v['ms']:.3f} ms / {v['peak_bytes'] / 2**30:.3f} GiB"
                  " peak" for k, v in tp_times.items()))
        tp_args = build_parser().parse_args(TRAIN_RECIPE + LOOP_FLAGS + [
            "--tp", "1", "--epochs", "1", "--model-prefix",
            os.path.join(workdir, "tp1")])
        tp_train = synthetic_dataset(tp_pool, BATCH, True, dev, tp_cache,
                                     flow_from_mv=True)
        tp_val = synthetic_dataset(tp_pool, BATCH, False, dev, tp_cache,
                                   flow_from_mv=True)
        with contextlib.redirect_stdout(io.StringIO()):
            tp_result = train_cli.train(tp_args, tp_train, tp_val,
                                        device=dev, input_size=SIZE)
        check(len(tp_result.epochs) == 1
              and len(tp_result.epochs[0]["batch_times"]) == 1,
              "cli.train --tp 1 did not take its step")
        print("  cli.train --tp 1: one step of the recipe's batch, evaluated "
              f"(Prec@1 {tp_result.best_prec1:.3f})")
    finally:
        tckpt.wait_for_checkpoints()
        multihost.shutdown()
    launches = {"backtrace_warp_batch": bt.backtrace_warp_batch.launches,
                "backtrace_gop_cells": bt.backtrace_gop_cells.launches}

    # (f) 2 gloo ranks on the one card (NCCL refuses two ranks on one
    # card; gloo carries the collectives through the host): the halo
    # exchange of the time-sharded forward, and a 1 x 2 tensor-parallel
    # dmcnet step in float64
    ranges = temporal.split_frames(I3D_T, 2)
    torch.save({"i3d": {k: v.cpu() for k, v in net.state_dict().items()},
                "batch": pair_batch}, os.path.join(workdir, "pair_in.pt"))
    for r, (a, b) in enumerate(ranges):
        torch.save(clip[:, :, a:b].cpu().clone(),
                   os.path.join(workdir, f"frames{r}.pt"))
    want_logits = want_logits.cpu()
    del net, clip, fr, logits, gen, want_gen
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    mp.start_processes(_gloo_pair_worker, args=(
        _free_port(), workdir, torch.device(dev).type), nprocs=2,
        start_method="spawn", join=True)
    pair_s = time.perf_counter() - t0
    pair = [torch.load(os.path.join(workdir, f"rank{r}.pt"),
                       weights_only=True) for r in range(2)]
    for r, res in enumerate(pair):
        check(torch.allclose(res["logits"], want_logits, rtol=LOGIT_RTOL,
                             atol=LOGIT_ATOL),
              f"2-rank time-sharded logits (rank {r}) != unsharded")
        check(0 < res["max_halo"] <= 7, f"rank {r} received "
              f"{res['max_halo']} frames in one exchange")
        check(abs(res["tp_loss"] - plain_loss) <= 1e-9 * abs(plain_loss),
              f"2-rank tp loss {res['tp_loss']} != plain {plain_loss}")
        for k, v in res["tp_state"].items():
            w = plain_state[k]
            if v.shape != w.shape:      # this rank's output channels
                w = w.chunk(2)[r]
            if not k.endswith("num_batches_tracked"):
                check(torch.allclose(v, w, rtol=TRAIN_PARAM_RTOL,
                                     atol=TRAIN_PARAM_ATOL),
                      f"2-rank tp {k} (rank {r}) != plain")
    print(f"  2 gloo ranks on the card ({pair_s:.1f} s with start-up): "
          f"time-sharded forward over {ranges}, logits max |diff| "
          + " / ".join(f"{float((p['logits'] - want_logits).abs().max()):.3g}"
                       for p in pair)
          + f" from the unsharded, halos of at most "
          f"{max(p['max_halo'] for p in pair)} frames; "
          + ", ".join(f"rank {r} {p['ms']:.3f} ms / "
                      f"{p['peak_bytes'] / 2**30:.3f} GiB peak"
                      for r, p in enumerate(pair))
          + f" (median of 3, CUDA events, fp32); a 1 x 2 tensor-parallel "
          f"dmcnet step in float64 ({len(pair[0]['tp_names'])} layers, "
          "each rank half their output channels): loss and every "
          "parameter and BN statistic as the plain step")
    print(f"  launches around the phase: {launches} (no TPU kernel lies on "
          "these paths)")
    check(not any(launches.values()), "the parallel phase launched B1/B2")
    phase_s = time.perf_counter() - t_phase
    print(f"  parallel phase {phase_s:.1f} s")
    return {"i3d_timing": timing, "i3d_loop_s": loop_s,
            "i3d_resume_s": resume_s, "shard_time": shard_times,
            "tp_timing": tp_times, "pair": [
                {k: p[k] for k in ("ms", "peak_bytes", "max_halo")}
                for p in pair], "pair_s": pair_s, "launches": launches,
            "phase_s": phase_s}


def _filled_cache(torch, dev, pool):
    """The synthetic datasets' cache with every pool GOP accumulated by
    B2 and u8-encoded, filled before a phase sets the launch counts to 0:
    the phase's own paths then launch what they launch."""
    from dmcnet_tpu_torch.data.dmc_dataset import _encode_u8
    from dmcnet_tpu_torch.ops.backtrace import gop_mv_residual_cuda

    cache = {}
    for k, gop in enumerate(pool):
        mv, res = gop_mv_residual_cuda(*gop, device=dev)
        cache[k] = (_encode_u8(mv.cpu().numpy(), MINMAX_BOUND),
                    _encode_u8(res.cpu().numpy()))
    return cache


def _run_test_cli(test_cli, pool, cache, dev, flags, videos):
    """`cli.test` with `flags` over `videos` synthetic videos (its
    `CoviarDataset` swapped for the synthetic dataset: no decoder here);
    returns (accuracy, scores (videos, 1, classes), s)."""
    import contextlib
    import io

    real_dataset = test_cli.CoviarDataset
    test_cli.CoviarDataset = lambda **kw: synthetic_dataset(
        pool, videos, False, dev, cache, flow_from_mv=True,
        num_segments=kw["num_segments"])
    scores = flags[flags.index("--save-scores") + 1]
    try:
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            acc = test_cli.main(flags)
        seconds = time.perf_counter() - t0
    finally:
        test_cli.CoviarDataset = real_dataset
    with np.load(scores + ".npz", allow_pickle=True) as data:
        return acc, np.stack([x[0] for x in data["scores"]]), seconds


def _test_list(workdir, n):
    import os

    path = os.path.join(workdir, f"test_list_{n}.txt")
    with open(path, "w") as f:
        f.writelines(f"synthetic/{v}.avi 0 {v % NUM_CLASS}\n"
                     for v in range(n))
    return path


def pipeline_phase(torch, bt, dev, gops, smi, workdir):
    """14. Pipeline-parallel scoring at the HMDB-51 scoring recipe's width
    (examples/hmdb51_gen_flow/run.sh's test command: 25 segments x 10
    crops = 250 clips a video at 224², DenseNetTiny + ResNet-18, 51
    classes): the pp 2 and pp 4 ResNet-18 logits of one video against the
    unpipelined classifier on the card and on the CPU; ms and peak memory
    of the classifier at pp 1, 2 and 4; a float64 backward through the
    2-stage schedule against the serial gradients; `cli.test --pp 2`
    against `cli.test` over 4 synthetic videos.  The card has no peers:
    every stage lies on cuda:0, so the times are the schedule's cost
    without overlap between cards.  B1 and B2 counted around the phase
    (0).  Returns the numbers for the summary line."""
    import copy
    import os

    from dmcnet_tpu_torch.cli import test as test_cli
    from dmcnet_tpu_torch.data.dmc_dataset import (
        BatchAssembler,
        augment_eval_batch,
    )
    from dmcnet_tpu_torch.models.resnet import resnet18
    from dmcnet_tpu_torch.models.tsn import DMCNet
    from dmcnet_tpu_torch.parallel import (
        make_pipeline_apply,
        make_pp_resnet18,
        make_stage_mesh,
        resnet18_stage_split,
    )
    from dmcnet_tpu_torch.train.checkpoints import save_checkpoint

    phase("pipeline")
    t_phase = time.perf_counter()
    pool = [gops[k][1:] for k in ("16x16 blocks", "8x8 blocks",
                                  "4x4 blocks")]
    cache = _filled_cache(torch, dev, pool)
    bt.backtrace_warp_batch.launches = 0
    bt.backtrace_gop_cells.launches = 0

    # (a) one video's 250 generated cues, the classifier at pp 1, 2, 4
    torch.manual_seed(0)
    model = DMCNet(NUM_CLASS, num_segments=PP_SEGMENTS,
                   arch_estimator="DenseNetTiny",
                   gen_flow_or_delta=1).to(dev).eval()
    ds = synthetic_dataset(pool, 1, False, dev, cache, flow_from_mv=True,
                           num_segments=PP_SEGMENTS)
    batch = augment_eval_batch(BatchAssembler(
        ds, input_size=SIZE, test_crops=PP_CROPS).eval_batch([0]),
        representation="mv", flow_ds_factor=16, input_size=SIZE,
        device=dev)
    clips = PP_SEGMENTS * PP_CROPS
    cpu_base = copy.deepcopy(model.base_model).cpu()
    with torch.inference_mode():
        gen = model.generate(batch["mv"], batch["residual"])
        check(tuple(gen.shape) == (clips, 2, SIZE, SIZE),
              f"generated cues {tuple(gen.shape)}")
        cpu_logits = cpu_base(gen.cpu())
    del batch, cpu_base

    def padded(x, n_stages):
        """The clip batch wrapped to a multiple of the stage count, as
        cli.test --pp pads it."""
        n = x.shape[0]
        return x[torch.arange(n + (-n) % n_stages, device=x.device) % n]

    runs = {1: model.base_model}
    for n in PP_STAGES:
        runs[n] = make_pp_resnet18(model.base_model,
                                   make_stage_mesh([str(dev)] * n),
                                   n_microbatches=n)
    times, logits = {}, {}
    with torch.inference_mode():
        for n, fn in runs.items():
            x = padded(gen, n)
            logits[n] = fn(x)[:clips]
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            resident = torch.cuda.memory_allocated()
            ms = median_ms(lambda: fn(x), PP_TIMED, torch)
            times[n] = {"ms": ms, "resident_bytes": resident,
                        "peak_bytes": torch.cuda.max_memory_allocated()}
            del x
    for n in PP_STAGES:
        err_card = float((logits[n] - logits[1]).abs().max())
        err_cpu = float((logits[n].cpu() - cpu_logits).abs().max())
        print(f"  pp {n}: logits of {clips} clips max |diff| {err_card:.3g} "
              f"from the unpipelined card, {err_cpu:.3g} from the CPU "
              f"(rtol {LOGIT_RTOL}, atol {LOGIT_ATOL}, TF32 off)")
        check(torch.allclose(logits[n], logits[1], rtol=LOGIT_RTOL,
                             atol=LOGIT_ATOL), f"pp {n} != unpipelined")
        check(torch.allclose(logits[n].cpu(), cpu_logits, rtol=LOGIT_RTOL,
                             atol=LOGIT_ATOL), f"pp {n} != CPU")
    check(bool(torch.isfinite(logits[1]).all()), "non-finite logits")
    print(f"  classifier on one video ({clips} clips at {SIZE}², fp32, "
          f"TF32 off, inference mode, median of {PP_TIMED} by CUDA events; "
          f"every stage on cuda:0: no overlap between cards) on {smi}: "
          + "; ".join(f"pp {n} {t['ms']:.3f} ms, peak "
                      f"{t['peak_bytes'] / 2**30:.3f} GiB of which "
                      f"{t['resident_bytes'] / 2**30:.3f} resident before"
                      for n, t in times.items()))
    del runs, logits, gen

    # (b) float64 gradients through the 2-stage schedule, with and without
    # remat, against the serial model's
    torch.manual_seed(1)
    net = resnet18(NUM_CLASS).to(dev, torch.float64).eval()
    x = torch.randn(PP_GRAD_BATCH, 2, PP_GRAD_SIZE, PP_GRAD_SIZE,
                    dtype=torch.float64, device=dev)
    params = list(net.parameters())
    want = torch.autograd.grad((net(x) ** 2).sum(), params)
    worst = 0.0
    for remat in (False, True):
        pipe = make_pipeline_apply(resnet18_stage_split(net, 2),
                                   make_stage_mesh([str(dev)] * 2),
                                   remat=remat)
        got = torch.autograd.grad((pipe(x) ** 2).sum(), params)
        for g, w in zip(got, want):
            tol = PP_F64_RTOL * w.abs() + PP_F64_ATOL * w.abs().max()
            check(bool(((g - w).abs() <= tol).all()),
                  f"f64 pipeline gradients (remat {remat}) != serial")
            worst = max(worst, float(((g - w).abs()
                                      / w.abs().max()).max()))
    print(f"  float64 backward through 2 stages ({PP_GRAD_BATCH} x "
          f"{PP_GRAD_SIZE}², remat off and on): all {len(params)} gradients "
          f"within rtol {PP_F64_RTOL}, atol {PP_F64_ATOL} x each tensor's "
          f"max of the serial model's; worst |diff| / max {worst:.3g}")
    del net, x, want

    # (c) cli.test --pp 2 against cli.test, stages on cuda:0 twice
    weights = os.path.join(workdir, "pp.pth")
    save_checkpoint(model, {"epoch": 1, "arch": "resnet18",
                            "best_prec1": 0.0}, weights)
    del model
    flags = DIST_TEST_MODEL + [
        "--test-list", _test_list(workdir, PP_VIDEOS), "--weights", weights,
        "--test_segments", str(PP_SEGMENTS), "--test-crops", str(PP_CROPS),
        "--input_size", str(SIZE), "--device", str(dev)]
    plain = _run_test_cli(test_cli, pool, cache, dev, flags + [
        "--save-scores", os.path.join(workdir, "pp1")], PP_VIDEOS)
    card = "cuda:0" if dev.type == "cuda" else str(dev)
    real_devices = test_cli.first_devices
    test_cli.first_devices = lambda n, device, flag: [card] * n
    try:
        piped = _run_test_cli(test_cli, pool, cache, dev, flags + [
            "--pp", "2", "--save-scores", os.path.join(workdir, "pp2")],
            PP_VIDEOS)
    finally:
        test_cli.first_devices = real_devices
    err = float(np.abs(piped[1] - plain[1]).max())
    check(piped[1].shape == (PP_VIDEOS, 1, NUM_CLASS)
          and np.isfinite(piped[1]).all(), "cli.test --pp 2 scores")
    check(np.allclose(piped[1], plain[1], rtol=SERVE_RTOL, atol=SERVE_ATOL)
          and piped[0] == plain[0], "cli.test --pp 2 != cli.test")
    print(f"  cli.test --pp 2 over {PP_VIDEOS} synthetic videos x "
          f"{PP_SEGMENTS} x {PP_CROPS} (stage devices swapped to "
          f"{card} x 2: one card): scores max |diff| {err:.3g} from "
          f"cli.test without --pp (rtol {SERVE_RTOL}, atol {SERVE_ATOL}), "
          f"accuracy {piped[0]} and {plain[0]}; {piped[2]:.2f} s and "
          f"{plain[2]:.2f} s")
    launches = {"backtrace_warp_batch": bt.backtrace_warp_batch.launches,
                "backtrace_gop_cells": bt.backtrace_gop_cells.launches}
    print(f"  launches around the phase: {launches} (no TPU kernel lies on "
          "the pipeline path)")
    check(not any(launches.values()), "the pipeline phase launched B1/B2")
    phase_s = time.perf_counter() - t_phase
    print(f"  pipeline phase {phase_s:.1f} s")
    return {"classifier": times, "f64_worst": worst,
            "cli_s": {"pp2": piped[2], "plain": plain[2]},
            "launches": launches, "phase_s": phase_s}


def read_png(path):
    """(H, W, 3) uint8 of an 8-bit RGB PNG with unfiltered rows, as
    `utils/viz.write_png` writes them (no imaging package on the card's
    machine)."""
    import struct
    import zlib

    with open(path, "rb") as f:
        data = f.read()
    check(data[:8] == b"\x89PNG\r\n\x1a\n", f"{path}: not a PNG")
    pos, idat = 8, b""
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if kind == b"IHDR":
            w, h, depth, color = struct.unpack(">IIBB", body[:10])
            check(depth == 8 and color == 2, f"{path}: not 8-bit RGB")
        elif kind == b"IDAT":
            idat += body
        pos += 12 + n
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(
        h, 1 + 3 * w)
    check(not rows[:, 0].any(), f"{path}: filtered rows")
    return rows[:, 1:].reshape(h, w, 3)


def _trace_numbers(path):
    """(traced step numbers, the categories of their spans, kernel events,
    device busy share, kernel share, window ms) of a Chrome trace: the
    busy share is the union of the kernels' and copies' intervals over
    the window from the first traced step's start to the last one's end,
    the steps' host spans (`user_annotation`; a card's trace repeats each
    on the device's timeline)."""
    import collections
    import json

    with open(path) as f:
        events = json.load(f)["traceEvents"]
    marks = [e for e in events
             if str(e.get("name", "")).startswith("ProfilerStep#")]
    cats = collections.Counter(e.get("cat") for e in marks)
    steps = [e for e in marks if e.get("cat") == "user_annotation"]
    t0 = min(e["ts"] for e in steps)
    t1 = max(e["ts"] + e["dur"] for e in steps)

    def share(cats):
        spans = sorted((max(e["ts"], t0), min(e["ts"] + e["dur"], t1))
                       for e in events if e.get("cat") in cats
                       and e.get("ph") == "X")
        busy, end = 0.0, t0
        for a, b in spans:
            a = max(a, end)
            if b > a:
                busy += b - a
                end = b
        return busy / (t1 - t0)

    kernels = sum(e.get("cat") == "kernel" for e in events)
    return (sorted(int(e["name"].split("#")[1]) for e in steps), dict(cats),
            kernels, share({"kernel", "gpu_memcpy", "gpu_memset"}),
            share({"kernel"}), (t1 - t0) / 1e3)


def utils_phase(torch, bt, dev, gops, smi, workdir):
    """15. The last modules on the card: `cli.test --viz 1` against a CPU
    run's pictures; the `cli.train` loop at the train phase's width (40 x
    3 at 224²) with `--profile-dir` over a 10-batch epoch: the trace's
    steps, its CUDA kernel events and the device's busy share over the
    traced window; `python -m dmcnet_tpu_torch --help`.  B1 and B2
    counted around the phase (0).  Returns the numbers for the summary
    line."""
    import os
    import subprocess

    from dmcnet_tpu_torch.cli import test as test_cli
    from dmcnet_tpu_torch.cli import train as train_cli
    from dmcnet_tpu_torch.cli.train_options import build_parser

    phase("utils")
    t_phase = time.perf_counter()
    pool = [gops[k][1:] for k in ("16x16 blocks", "8x8 blocks",
                                  "4x4 blocks")]
    cache = _filled_cache(torch, dev, pool)
    bt.backtrace_warp_batch.launches = 0
    bt.backtrace_gop_cells.launches = 0

    # (a) cli.test --viz 1 on the card and on the CPU
    torch.manual_seed(0)
    from dmcnet_tpu_torch.models.tsn import DMCNet
    from dmcnet_tpu_torch.train.checkpoints import save_checkpoint

    weights = os.path.join(workdir, "viz.pth")
    save_checkpoint(DMCNet(NUM_CLASS, arch_estimator="DenseNetTiny",
                           gen_flow_or_delta=1),
                    {"epoch": 1, "arch": "resnet18", "best_prec1": 0.0},
                    weights)
    pictures = []
    for device in (str(dev), "cpu"):
        viz_dir = os.path.join(workdir, f"viz_{device.replace(':', '')}")
        _run_test_cli(test_cli, pool, cache, dev, DIST_TEST_MODEL + [
            "--test-list", _test_list(workdir, VIZ_VIDEOS),
            "--weights", weights, "--test_segments", "3", "--test-crops",
            "1", "--input_size", str(SIZE), "--viz", "1", "--viz-dir",
            viz_dir, "--device", device, "--save-scores",
            os.path.join(workdir, f"viz_{len(pictures)}")], VIZ_VIDEOS)
        names = sorted(os.listdir(viz_dir))
        check(names == [f"{i:05d}_{i}_gen_flow.png"
                        for i in range(VIZ_VIDEOS)],
              f"--viz pictures on {device}: {names}")
        pictures.append([read_png(os.path.join(viz_dir, n)) for n in names])
    diff = max(int(np.abs(a.astype(int) - b).max())
               for a, b in zip(*pictures))
    check(all(p.shape == (SIZE, SIZE, 3) and p.std() > 1.0
              for p in pictures[0]), "--viz pictures are flat")
    check(diff <= 1, f"--viz pictures card vs CPU differ by {diff} levels")
    print(f"  cli.test --viz 1 over {VIZ_VIDEOS} synthetic videos: "
          f"{VIZ_VIDEOS} {SIZE}x{SIZE} PNGs on the card and on the CPU, "
          f"pixels at most {diff} level(s) apart")

    # (b) the cli.train loop with --profile-dir over one 10-batch epoch
    prof_dir = os.path.join(workdir, "prof")
    args = build_parser().parse_args(TRAIN_RECIPE + [
        "--epochs", "1", "--workers", "8", "--batch-size", str(BATCH),
        "--profile-dir", prof_dir,
        "--model-prefix", os.path.join(workdir, "prof_model")])
    train_ds = synthetic_dataset(pool, PROFILE_BATCHES * BATCH, True, dev,
                                 cache, flow_from_mv=True)
    val_ds = synthetic_dataset(pool, BATCH, False, dev, cache,
                               flow_from_mv=True)
    t0 = time.perf_counter()
    result = train_cli.train(args, train_ds, val_ds, device=dev,
                             input_size=SIZE)
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    files = os.listdir(prof_dir)
    check(len(files) == 1, f"--profile-dir wrote {files}")
    trace = os.path.join(prof_dir, files[0])
    steps, cats, kernels, busy, kernel_busy, window_ms = \
        _trace_numbers(trace)
    check(steps == list(range(2, 8)), f"traced steps {steps}")
    check(kernels > 0, "the trace holds no CUDA kernel event")
    print(f"  cli.train --profile-dir, one epoch of {PROFILE_BATCHES} "
          f"batches of {BATCH} x {SEGMENTS} at {SIZE}² in {loop_s:.2f} s: "
          f"trace {os.path.getsize(trace) / 2**20:.1f} MiB, steps {steps} "
          f"(ProfilerStep spans by category {cats}), "
          f"{kernels} CUDA kernel events; over the traced window "
          f"({window_ms:.1f} ms, {len(steps)} steps) the device is busy "
          f"{busy * 100:.1f}% (kernels alone {kernel_busy * 100:.1f}%) on "
          f"{smi}; batch time {result.epochs[0]['batch_time']:.4f} s "
          "(average, host clock, profiler on for steps 2-7)")

    # (c) the dispatcher
    run = subprocess.run([sys.executable, "-m", "dmcnet_tpu_torch",
                          "--help"], capture_output=True, text=True,
                         timeout=300)
    listed = [x.strip() for x in run.stdout.splitlines()[3:]]
    check(run.returncode == 0 and len(listed) == 9 and "serve" in listed,
          f"python -m dmcnet_tpu_torch --help: {run.returncode} "
          f"{run.stdout[-300:]} {run.stderr[-300:]}")
    print(f"  python -m dmcnet_tpu_torch --help: exit 0, commands "
          f"{', '.join(listed)}")
    launches = {"backtrace_warp_batch": bt.backtrace_warp_batch.launches,
                "backtrace_gop_cells": bt.backtrace_gop_cells.launches}
    print(f"  launches around the phase: {launches} (no TPU kernel lies on "
          "these paths)")
    check(not any(launches.values()), "the utils phase launched B1/B2")
    phase_s = time.perf_counter() - t_phase
    print(f"  utils phase {phase_s:.1f} s")
    return {"viz_max_diff": diff, "profile": {
        "steps": steps, "kernel_events": kernels, "busy_share": busy,
        "kernel_share": kernel_busy, "window_ms": window_ms,
        "loop_s": loop_s}, "launches": launches, "phase_s": phase_s}


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
    # the default predictor serves the folded bfloat16 forward (pack=True);
    # `unpacked` serves the float32 one on the same weights and arrays
    pred = DMCPredictor(num_class=NUM_CLASS, arch="resnet18",
                        arch_estimator="DenseNetTiny", gen_flow_or_delta=1,
                        mv_minmaxnorm=1, input_size=SIZE, device="cuda",
                        seed=0)
    check(pred.packed is not None and pred.packed_cls is not None,
          "the default predictor is not packed")
    unpacked = DMCPredictor(pred.model.state_dict(), num_class=NUM_CLASS,
                            input_size=SIZE, pack=False, device="cuda")
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
    u_fn = unpacked._gop_program(G, T, H, W, CELL, PICKS)
    print(f"  set-up (models, {G} synthetic GOPs) "
          f"{time.perf_counter() - t0:.2f} s")

    bt.backtrace_warp_batch.launches = 0
    logits, mv_u8, res_u8 = fn(*pred._to_device(arrays))
    torch.cuda.synchronize()
    launches = bt.backtrace_warp_batch.launches
    print(f"  main path (pack=True): backtrace_warp_batch launches = "
          f"{launches}")
    check(launches >= 1, "the main path did not launch backtrace_warp")
    check(tuple(logits.shape) == (G * PICKS, NUM_CLASS),
          f"logits shape {tuple(logits.shape)}")
    check(bool(torch.isfinite(logits).all()), "non-finite logits")
    check(tuple(mv_u8.shape) == (G, PICKS, SIZE, SIZE, 2)
          and tuple(res_u8.shape) == (G, PICKS, SIZE, SIZE, 3),
          "u8 output shapes")

    u_logits, u_mv, u_res = u_fn(*unpacked._to_device(arrays))
    check(torch.equal(u_mv, mv_u8) and torch.equal(u_res, res_u8),
          "mv_u8/res_u8 differ between pack=True and pack=False")
    plain = DMCPredictor(pred.model.state_dict(), num_class=NUM_CLASS,
                         input_size=SIZE, pack=False, device="cuda",
                         backtrace_impl=bt.backtrace_warp_batch_ref)
    p_logits, p_mv, p_res = plain._gop_program(G, T, H, W, CELL, PICKS)(
        *plain._to_device(arrays))
    check(torch.equal(p_mv, mv_u8) and torch.equal(p_res, res_u8),
          "mv_u8/res_u8 differ from the plain back-trace program")
    print("  mv_u8 and res_u8 of pack=True and pack=False equal the plain "
          "back-trace program's; pack=False logits max diff "
          f"{float((p_logits - u_logits).abs().max()):.3g}")

    g_cpu = 4
    cpu_arrays = pred._pack_rows(rows[:g_cpu], g_cpu, T, H, W, CELL, PICKS)
    cpu = DMCPredictor(pred.model.state_dict(), num_class=NUM_CLASS,
                       input_size=SIZE, pack=False, device="cpu")
    c_logits, c_mv, c_res = cpu._gop_program(g_cpu, T, H, W, CELL, PICKS)(
        *cpu._to_device(cpu_arrays))
    check(torch.equal(c_mv, mv_u8[:g_cpu].cpu())
          and torch.equal(c_res, res_u8[:g_cpu].cpu()),
          "u8 outputs differ from the CPU run")
    gpu_rows = u_logits[:g_cpu * PICKS].cpu()
    logit_err = float((gpu_rows - c_logits).abs().max())
    print(f"  pack=False logits vs CPU run ({g_cpu * PICKS} rows): max |diff| "
          f"= {logit_err:.3g}, max |logit| = "
          f"{float(c_logits.abs().max()):.3g} (rtol={LOGIT_RTOL}, "
          f"atol={LOGIT_ATOL}, TF32 off)")
    check(torch.allclose(gpu_rows, c_logits, rtol=LOGIT_RTOL,
                         atol=LOGIT_ATOL), "card logits != CPU logits")

    # pack=True in bfloat16: against pack=False on the card and pack=True
    # on the CPU, each within PACK_TOL of the reference's largest |logit|
    cpu_packed = DMCPredictor(pred.model.state_dict(), num_class=NUM_CLASS,
                              input_size=SIZE, device="cpu")
    cp_logits = cpu_packed._gop_program(g_cpu, T, H, W, CELL, PICKS)(
        *cpu_packed._to_device(cpu_arrays))[0]
    pack_err = {}
    for name, got, want in (
            ("pack=True vs pack=False on the card", logits, u_logits),
            ("pack=True card vs CPU", logits[:g_cpu * PICKS].cpu(),
             cp_logits)):
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        pack_err[name] = {"max_abs_diff": err, "max_abs_logit": scale}
        print(f"  {name}: max |diff| {err:.4g}, max |logit| {scale:.4g} "
              f"(bound {PACK_TOL} x max |logit| = {PACK_TOL * scale:.4g})")
        check(err <= PACK_TOL * scale, f"{name}: logits differ by {err}")

    def time_chunks(fn, p, n=20, warm=3):
        out = []
        for i in range(warm + n):
            t0 = time.perf_counter()
            fn(*p._to_device(arrays))
            torch.cuda.synchronize()
            if i >= warm:
                out.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(out)

    clips = G * PICKS
    packed_chunk_ms = time_chunks(fn, pred)
    chunk_ms = time_chunks(u_fn, unpacked)
    print(f"  chunk ({G} GOPs, {clips} clips, host arrays -> logits; median "
          f"of 20) on {smi}: pack=True (bf16, folded) {packed_chunk_ms:.3f} "
          f"ms = {clips / packed_chunk_ms * 1e3:.1f} clips/s; pack=False "
          f"{chunk_ms:.3f} ms = {clips / chunk_ms * 1e3:.1f} clips/s (fp32, "
          "TF32 off)")
    torch.backends.cudnn.allow_tf32 = True
    chunk_ms_tf32 = time_chunks(u_fn, unpacked)
    torch.backends.cudnn.allow_tf32 = False
    print(f"  same chunk pack=False with cuDNN TF32 on: median "
          f"{chunk_ms_tf32:.3f} ms = {clips / chunk_ms_tf32 * 1e3:.1f} "
          "clips/s")

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
        gen = unpacked.model.generate(mv_n, res_n)
        stages = {
            "host_to_device": median_ms(host_to_device, 10, torch),
            "gop_program": median_ms(lambda: u_fn(*dev_arrays), 10, torch),
            "forward_u8": median_ms(
                lambda: unpacked._forward_u8(mv_flat, res_flat), 10, torch),
            "generator": median_ms(
                lambda: unpacked.model.generate(mv_n, res_n), 10, torch),
            "classifier": median_ms(
                lambda: unpacked.model.classify(gen), 10, torch),
        }
        raw = torch.cat([mv_flat, res_flat], -1).permute(0, 3, 1, 2) \
            .to(torch.bfloat16)
        packed_gen = pred.packed[0](raw)
        packed_stages = {
            "host_to_device": stages["host_to_device"],
            "gop_program": median_ms(lambda: fn(*dev_arrays), 10, torch),
            "forward_u8": median_ms(
                lambda: pred._forward_u8(mv_flat, res_flat), 10, torch),
            "packed_generator": median_ms(lambda: pred.packed[0](raw), 10,
                                          torch),
            "packed_resnet18": median_ms(
                lambda: pred.packed_cls[0](packed_gen), 10, torch),
        }
    print("  breakdown pack=False (median ms, fp32): " + ", ".join(
        f"{k} {v:.3f}" for k, v in stages.items()))
    print("  breakdown pack=True (median ms, bf16): " + ", ".join(
        f"{k} {v:.3f}" for k, v in packed_stages.items()))

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

    mesh = in_workdir(mesh_phase, torch, bt, pred, rows,
                      (logits, mv_u8, res_u8),
                      [f"cuda:{i}" for i in range(count)], smi)
    packed = in_workdir(packed_phase, torch, bt, dev, gops, smi)
    codec_times = codec_phase(torch, bt, dev, gops)
    data = data_phase(torch, bt, dev, gops, pred, rng)
    train = in_workdir(train_phase, torch, bt, dev, gops, smi)
    gan = in_workdir(gan_phase, torch, bt, dev, gops, smi)
    i3d = in_workdir(i3d_phase, torch, bt, dev, gops)
    i3d_train = in_workdir(i3d_train_phase, torch, bt, dev, gops, smi)
    dist_numbers = in_workdir(dist_phase, torch, bt, dev, gops, smi)
    parallel = in_workdir(parallel_phase, torch, bt, dev, gops, smi)
    pipeline = in_workdir(pipeline_phase, torch, bt, dev, gops, smi)
    utils = in_workdir(utils_phase, torch, bt, dev, gops, smi)

    # 16. videos --------------------------------------------------------------
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
            scores = unpacked.predict_videos(paths, backend="device")
            n = bt.backtrace_warp_batch.launches
            host = unpacked.predict_videos(paths, backend="host")
        print(f"  predict_videos(2 clips, backend='device'): launches {n}")
        check(n >= 1, "predict_videos did not launch backtrace_warp")
        for s, hs in zip(scores, host):
            check(s.shape == (NUM_CLASS,) and np.isfinite(s).all(),
                  "bad video scores")
            check(np.allclose(s, hs, rtol=LOGIT_RTOL, atol=LOGIT_ATOL),
                  "device and host backends disagree")
        print("  device-backend scores agree with the host backend")

    # B1 on the serving paths: the one-card chunk, the mesh chunk and the
    # serve --mesh-devices command, each counted from 0
    b1_launches = launches + mesh["launches"] + mesh["serve_launches"]
    print(f"  B1 launches: main path {launches}, mesh chunk "
          f"{mesh['launches']}, serve --mesh-devices {mesh['serve_launches']}")
    kernels = [{
        "name": "backtrace_warp_batch",
        "route": "cuda",
        "source": "dmcnet_tpu_torch/ops/csrc/backtrace_warp.cu",
        "replaces": "dmcnet_tpu/ops/pallas_backtrace.py:401",
        "launches": b1_launches,
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
                      "stages_ms": stages,
                      "packed_chunk_ms": packed_chunk_ms,
                      "packed_stages_ms": packed_stages,
                      "pack_logit_err": pack_err, "packed": packed,
                      "clips_per_chunk": clips,
                      "clips_per_s": clips / chunk_ms * 1e3,
                      "b1_median_ms": kernel_median_ms,
                      "b2_wrapper_ms": b2["wrapper_ms"],
                      "launch_floor_ms": b2["floor_ms"],
                      "codec_ms": codec_times,
                      "data_ms": data["times"], "train": train,
                      "gan": gan, "i3d": i3d, "i3d_train": i3d_train,
                      "dist": dist_numbers, "mesh": mesh,
                      "parallel": parallel, "pipeline": pipeline,
                      "utils": utils, "card": smi}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
