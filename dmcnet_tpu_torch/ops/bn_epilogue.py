"""Inference BatchNorm + residual add + ReLU of a bottleneck ResNet block as
one in-place pass over a convolution's output.

  * `bn_epilogue` is the wrapper of the hand-written CUDA kernel in
    `ops/csrc/bn_epilogue.cu`, which replaces no TPU kernel (XLA fused
    these ops into the JAX package's convolutions).  For a CUDA tensor it
    launches the kernel or raises; for a CPU tensor it runs the plain
    version.
  * `bn_epilogue_ref` is that plain PyTorch version, rounded as the kernel
    rounds: the two agree bit for bit.
"""

from __future__ import annotations

import ctypes

import torch


def _affine_(x, bn):
    """x <- bn(x) in place, the BatchNorm module in inference: x * k + s
    per channel, k = weight / sqrt(running_var + eps), s = bias -
    running_mean * k, from its tensors as they are at the call."""
    k = bn.weight / torch.sqrt(bn.running_var + bn.eps)
    s = bn.bias - bn.running_mean * k
    return x.mul_(k.view(1, -1, 1, 1)).add_(s.view(1, -1, 1, 1))


def bn_epilogue_ref(y, bn, residual=None, residual_bn=None, relu=True):
    """Plain version of `bn_epilogue` (any device, any layout): y <-
    act(bn(y) [+ residual | + residual_bn(residual)]) in place, act ReLU
    or none; returns y."""
    _affine_(y, bn)
    if residual is not None:
        y.add_(residual if residual_bn is None
               else _affine_(residual.clone(), residual_bn))
    return torch.relu_(y) if relu else y


def _declare(lib):
    lib.bn_epilogue_launch.restype = ctypes.c_int
    lib.bn_epilogue_launch.argtypes = (
        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
        + [ctypes.c_void_p] * 4 + [ctypes.c_float]
        + [ctypes.c_void_p] * 4 + [ctypes.c_float]
        + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p])
    lib.bn_epilogue_error_string.restype = ctypes.c_char_p
    lib.bn_epilogue_error_string.argtypes = [ctypes.c_int]


def _bn_args(bn, y):
    """The BN's four tensors' pointers and its eps, after checking them."""
    tensors = (bn.weight, bn.bias, bn.running_mean, bn.running_var)
    c = y.shape[1]
    if any(t is None or t.shape != (c,) or t.dtype != torch.float32
           or t.device != y.device or not t.is_contiguous()
           for t in tensors):
        raise ValueError(f"the epilogue needs an affine BatchNorm of {c} "
                         "channels with running statistics, float32 and "
                         f"contiguous on {y.device}")
    return [t.data_ptr() for t in tensors] + [float(bn.eps)]


def _check_layout(name, t, y):
    if not (t.is_cuda and t.dtype == torch.float32 and t.dim() == 4
            and t.shape == y.shape and t.device == y.device
            and t.is_contiguous(memory_format=torch.channels_last)
            and t.data_ptr() % 16 == 0):
        raise ValueError(
            f"bn_epilogue needs {name} a 16-byte aligned channels_last "
            f"float32 CUDA tensor of y's shape {tuple(y.shape)}, got "
            f"{t.dtype} {tuple(t.shape)} on {t.device}, strides "
            f"{t.stride()}")


def bn_epilogue(y, bn, residual=None, residual_bn=None, relu=True):
    """y <- act(bn(y) [+ residual | + residual_bn(residual)]) in place, act
    ReLU or none; returns y.

    `y` is a convolution's (N, C, H, W) output and `residual` a tensor of
    its shape: the block's input (the identity) or, with `residual_bn`,
    the downsample convolution's raw output.  `bn` and `residual_bn` are
    BatchNorm modules, read in inference (running statistics).  On CUDA
    tensors (channels_last, float32, C a multiple of 4) it launches
    `ops/csrc/bn_epilogue.cu` on the current stream (building it at first
    use) and raises `KernelBuildError` / `KernelLaunchError` on failure;
    on CPU tensors it runs the plain version.  Each launch adds one to
    `bn_epilogue.launches`.  Inference only: it raises with grad on."""
    if torch.is_grad_enabled():
        raise RuntimeError("bn_epilogue is an inference pass: call it "
                           "with grad off")
    if residual_bn is not None and residual is None:
        raise ValueError("residual_bn without a residual")
    if y.device.type == "cpu":
        return bn_epilogue_ref(y, bn, residual, residual_bn, relu)
    from dmcnet_tpu_torch.ops._build import KernelLaunchError, load

    _check_layout("y", y, y)
    if y.shape[1] % 4:
        raise ValueError(f"bn_epilogue needs channels in fours, got "
                         f"{y.shape[1]}")
    args = _bn_args(bn, y)
    mode = 0
    if residual is not None:
        _check_layout("residual", residual, y)
        mode = 1
    if residual_bn is not None:
        mode = 2
        args += _bn_args(residual_bn, y)
    else:
        args += [None] * 4 + [0.0]
    if y.numel() == 0:
        return y
    lib = load("bn_epilogue", _declare)
    with torch.cuda.device(y.device):
        rc = lib.bn_epilogue_launch(
            y.data_ptr(), None if residual is None else residual.data_ptr(),
            mode, int(relu), *args, y.numel() // 4, y.shape[1] // 4,
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise KernelLaunchError(
            f"bn_epilogue launch failed: "
            f"{lib.bn_epilogue_error_string(rc).decode()} ({rc})")
    bn_epilogue.launches += 1
    return y


bn_epilogue.launches = 0
