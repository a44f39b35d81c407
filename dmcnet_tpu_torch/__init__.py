"""dmcnet_tpu_torch — DMC-Net in PyTorch and CUDA for NVIDIA Hopper (H100).

The port of `dmcnet_tpu` (JAX on a TPU), which stays beside it as the
reference.  This package imports torch, numpy and the standard library only —
never jax, flax or anything under `dmcnet_tpu` — and mirrors the JAX
package's module names so every counterpart can be found:

  codec/          native MPEG-4 front-end (ctypes, libcoviar_torch.so), numpy
                  golden model and synthetic GOPs, host accumulation
  ops/backtrace   GOP back-trace: CUDA kernel (ops/csrc/backtrace_warp.cu)
                  and its plain PyTorch version
  models/         DenseNet estimators, ResNet-18/34, DMCNet, weight bridge
  serving         DMCPredictor: compressed video in, action scores out
  cli/serve       batch / stdin scoring command

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
