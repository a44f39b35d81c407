"""dmcnet_tpu_torch — DMC-Net in PyTorch and CUDA for NVIDIA Hopper (H100).

The port of `dmcnet_tpu` (JAX on a TPU), which stays beside it as the
reference.  This package imports torch, numpy and the standard library only —
never jax, flax or anything under `dmcnet_tpu` — and mirrors the JAX
package's module names so every counterpart can be found:

  codec/          native MPEG-4 front-end (ctypes, libcoviar_torch.so), numpy
                  golden model and synthetic GOPs, GOP accumulation on a
                  device and on the host, the `coviar` API, the re-encoder
  ops/backtrace   GOP back-trace: CUDA kernels B1 and B2
                  (ops/csrc/backtrace_warp.cu), their plain PyTorch
                  versions, and `gop_mv_residual_cuda`
  data/           lists, TSN and I3D clip sampling, the CoViAR dataset and
                  its batches, the I3D clip dataset and its batches, crops
                  and normalization on a device, the batch loader, an
                  image-list dataset
  models/         estimators (ContextNetwork(-Att), DenseNet family, Tiny
                  early fusion), ResNet-18/34 and the bottleneck
                  ResNet-50/101/152, DMCNet (with or without a
                  discriminator), PlainTSN, the GAN discriminators, I3D,
                  weight bridge, initialisers and 2D -> 3D inflation, the
                  Kinetics TF importer
  train/          Adam and SGD parameter groups, train/eval steps with the
                  freeze phase, the GAN's alternating D and G steps, the
                  I3D D and G macro steps (iter-size accumulation, the
                  `.grad` carry) and eval step, the I3D LR driver and
                  callbacks, meters and metric lists, checkpoints (torch
                  files, the JAX package's msgpack files, step directories
                  on torch.distributed.checkpoint)
  parallel/       process groups and per-rank batch rows, data parallelism
                  with global-batch BatchNorm, FSDP2, tensor parallelism,
                  time-sharded I3D evaluation, the GPipe schedule and the
                  pipelined ResNet-18
  utils/          JSON-lines metrics log, flow pictures (Middlebury wheel,
                  PNG writer), torch.profiler traces and timers
  serving         DMCPredictor: compressed video in, action scores out
  cli/            serve (batch / stdin scoring), train, train_gan, test
                  (with the GAN's adversarial accuracy), combine,
                  evaluate_video_i3d, train_i3d (train_hmdb51,
                  train_ucf101); `python -m dmcnet_tpu_torch <command>`
                  dispatches to them

Entry points run on `cuda` unless the caller passes `device="cpu"`; without
CUDA and without an explicit device they raise.
"""

import torch


def resolve_device(device=None):
    """`device` as a torch.device; None means CUDA, and raises when CUDA is
    unavailable rather than quietly running on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run on the CPU")
        device = "cuda"
    return torch.device(device)
