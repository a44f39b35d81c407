"""Layer helpers with torch's own defaults (counterpart of
`dmcnet_tpu/models/layers.py`).

The JAX package spells out torch-style symmetric padding (`torch_pad`) and
torch BatchNorm semantics because flax's defaults differ; here they are
PyTorch's native behaviour, so the helpers only fix the constants.

I3D is the other way round: the reference emulates TensorFlow's `SAME`
padding in torch (network/i3d.py:299-325), which XLA's `SAME` is natively.
`same_pad_3d` gives that split explicitly, for an unpadded `Conv3d` or a
max pool behind `F.pad`.  A symmetric `padding=` would shift every output
of a stride-2 layer on an even size by one pixel (the 7x7x7 stem, the
(3,3,3)/(2,2,2) pools).

Rematerialization (the JAX package's `nn.remat`): `remat_call` runs a
function under `torch.utils.checkpoint`, so its activations are recomputed
in the backward instead of kept; with `dots`, a selective-checkpoint
policy keeps the convolution outputs (JAX's `save_only_these_names(
"conv_out")`) and recomputes the rest.  The recompute runs every train-mode
BatchNorm a second time, which in torch would update its running
statistics twice; flax's remat does not.  The BatchNorms here
(`BatchNorm2d/3d`, and `parallel.mesh.GlobalBatchNorm`) read `recomputing()`
and leave them alone then.

`TimeUnrolledConv3d` is the JAX package's `unroll_time` lowering of a
kt x kh x kw conv of temporal stride 1: a sum of kt 2D convs over
(B*T, C, H, W) slices of the padded clip.  The sum is one custom op
(`conv3d_unrolled`), so that `dots` keeps its output as it keeps a
convolution's, without recomputing the taps, and its backward keeps the
padded clip once instead of kt reshaped copies.
"""

from __future__ import annotations

import contextlib
import functools
import threading

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

# torch BatchNorm2d defaults: eps=1e-5, momentum=0.1.
BN_EPS = 1e-5
BN_MOMENTUM = 0.1


def conv3x3(c_in, c_out, stride=1, dilation=1, bias=True):
    """3x3 conv with symmetric padding of `dilation` pixels: SAME at stride
    1, torch's floor-mode geometry ((H + 2p - 3) // 2 + 1) at stride 2."""
    return nn.Conv2d(c_in, c_out, 3, stride=stride, padding=dilation,
                     dilation=dilation, bias=bias)


# Set by `remat_call`'s recompute context, which reaches the BatchNorms
# of the region only this way; per thread, since the recompute runs in the
# thread that runs the backward.
_remat_state = threading.local()


def recomputing():
    """True while a `remat_call` region recomputes its forward (in the
    thread that runs the backward)."""
    return getattr(_remat_state, "recomputing", False)


@contextlib.contextmanager
def _recompute_flag(inner=None):
    prev = recomputing()
    _remat_state.recomputing = True
    try:
        with inner if inner is not None else contextlib.nullcontext():
            yield
    finally:
        _remat_state.recomputing = prev


def _save_conv_outputs(ctx, op, *args, **kwargs):
    """The `dots` policy: keep what the convolutions return, recompute the
    rest (BN, ReLU, pools, concatenations)."""
    if op in (torch.ops.aten.convolution.default,
              torch.ops.dmcnet_torch.conv3d_unrolled.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat_contexts(dots):
    if not dots:
        return contextlib.nullcontext(), _recompute_flag()
    forward_ctx, recompute_ctx = create_selective_checkpoint_contexts(
        _save_conv_outputs)
    return forward_ctx, _recompute_flag(recompute_ctx)


def remat_call(fn, *args, dots=False):
    """fn(*args), its activations recomputed in the backward (`dots`: all
    but the convolution outputs) while grad is enabled; without grad
    (eval, serving, the time-sharded forward) a plain call.  The regions
    draw no random numbers, so no RNG state is stashed; autocast's state
    is restored for the recompute by `checkpoint` itself."""
    if not torch.is_grad_enabled():
        return fn(*args)
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False,
                      context_fn=functools.partial(_remat_contexts, dots))


class _RecomputeSafeBatchNorm:
    """A train-mode forward inside a `remat_call` recompute normalizes with
    the batch statistics as before but through the same op at momentum 0:
    the running statistics come out as r * 1 + 0 * batch, unchanged, and
    `num_batches_tracked` is not counted again.  The op, and the tensors
    it saves for the backward, stay those of the first forward, which the
    checkpoint's and the selective policy's replay both require (running
    statistics of None would call another op)."""

    def forward(self, x):
        if self.training and self.track_running_stats and recomputing():
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, True, 0.0, self.eps)
        return super().forward(x)


class BatchNorm2d(_RecomputeSafeBatchNorm, nn.BatchNorm2d):
    pass


class BatchNorm3d(_RecomputeSafeBatchNorm, nn.BatchNorm3d):
    pass


def batch_norm(features, eps=BN_EPS):
    return BatchNorm2d(features, eps=eps, momentum=BN_MOMENTUM)


def batch_norm3d(features, eps=BN_EPS):
    return BatchNorm3d(features, eps=eps, momentum=BN_MOMENTUM)


def _unrolled_taps(x, kt):
    """(B, C, Tp, H, W) -> the kt (B*T, C, H, W) inputs of the temporal
    taps, T = Tp - kt + 1, from one (B, Tp, C, H, W) copy (a tap is a
    view of it at batch 1)."""
    b, c, tp = x.shape[:3]
    t = tp - kt + 1
    xs = x.transpose(1, 2).contiguous()
    return [xs[:, i:i + t].reshape(b * t, c, *x.shape[3:])
            for i in range(kt)], t


@torch.library.custom_op("dmcnet_torch::conv3d_unrolled", mutates_args=())
def conv3d_unrolled(x: torch.Tensor, weight: torch.Tensor,
                    bias: torch.Tensor | None, stride_h: int,
                    stride_w: int) -> torch.Tensor:
    """Unpadded conv3d of temporal stride 1 on an already padded (B, C,
    Tp, H, W) clip, as the sum over the weight's kt temporal taps of
    `F.conv2d` on (B*T, C, H, W): tap i reads frames i .. i+T-1."""
    kt = weight.shape[2]
    taps, t = _unrolled_taps(x, kt)
    out = None
    for i, xi in enumerate(taps):
        y = F.conv2d(xi, weight[:, :, i], stride=(stride_h, stride_w))
        out = y if out is None else out.add_(y)
    out = out.view(x.shape[0], t, *out.shape[1:]).transpose(1, 2)
    if bias is not None:
        out = out + bias.view(1, -1, 1, 1, 1)
    return out.contiguous()


def _unrolled_setup(ctx, inputs, output):
    x, weight, bias, stride_h, stride_w = inputs
    ctx.save_for_backward(x, weight)
    ctx.stride, ctx.has_bias = (stride_h, stride_w), bias is not None


def _unrolled_backward(ctx, grad):
    """Each tap's input and weight gradients by the convolution's own
    backward (`aten.convolution_backward`, no forward recomputed); the
    input gradient sums the taps' over the frames they read."""
    x, weight = ctx.saved_tensors
    need_x, need_w = ctx.needs_input_grad[:2]
    b, c, tp = x.shape[:3]
    kt = weight.shape[2]
    taps, t = _unrolled_taps(x, kt)
    g = grad.transpose(1, 2).reshape(b * t, grad.shape[1], *grad.shape[3:])
    gx = x.new_zeros(b, tp, c, *x.shape[3:]) if need_x else None
    gw = torch.empty_like(weight) if need_w else None
    for i, xi in enumerate(taps):
        gxi, gwi, _ = torch.ops.aten.convolution_backward(
            g, xi, weight[:, :, i], None, list(ctx.stride), [0, 0], [1, 1],
            False, [0, 0], 1, [need_x, need_w, False])
        if need_x:
            gx[:, i:i + t] += gxi.view(b, t, c, *x.shape[3:])
        if need_w:
            gw[:, :, i] = gwi
    gb = grad.sum((0, 2, 3, 4)) if ctx.has_bias else None
    return (gx.transpose(1, 2) if need_x else None), gw, gb, None, None


conv3d_unrolled.register_autograd(_unrolled_backward,
                                  setup_context=_unrolled_setup)


class TimeUnrolledConv3d(nn.Conv3d):
    """`nn.Conv3d` (same parameters and state-dict keys) of temporal
    stride 1, no padding, dilation or groups, whose forward runs as
    `conv3d_unrolled` (the JAX package's `Unit3D(unroll_time=True)`, for
    kt > 1 and temporal stride 1 only).  It overrides `_conv_forward`,
    the hook through which tensor parallelism's forward
    (`parallel/tensor.py`) convolves its shard, so that sharded layers
    unroll too.  Under autocast the inputs are cast as autocast casts a
    convolution's."""

    def _conv_forward(self, x, weight, bias):
        dev = x.device.type
        if torch.is_autocast_enabled(dev):
            dt = torch.get_autocast_dtype(dev)
            x, weight = x.to(dt), weight.to(dt)
            bias = None if bias is None else bias.to(dt)
        return conv3d_unrolled(x, weight, bias, *self.stride[1:])


def same_pad_3d(sizes, kernel, stride):
    """XLA's `SAME` split for the (T, H, W) axes, as the `F.pad` tuple
    (w_lo, w_hi, h_lo, h_hi, t_lo, t_hi): per axis total = max((ceil(n/s)
    - 1) * s + k - n, 0), lo = total // 2, the odd pixel at the end."""
    pads = []
    for n, k, s in zip(sizes, kernel, stride):
        total = max((-(-n // s) - 1) * s + k - n, 0)
        pads.append((total // 2, total - total // 2))
    return tuple(p for lo_hi in reversed(pads) for p in lo_hi)


def window3d(x, kernel, stride, op, shard=None, same=True, pad_value=0.0):
    """`op`, an unpadded window of `kernel` and `stride`, on (B, C, T, H,
    W) padded with `pad_value` to `SAME` (`same_pad_3d`), or not at all
    (VALID).  With a `shard` (`parallel.temporal.TimeShard`), `x` is this
    rank's `Frames` of a clip split along T and the T window runs through
    `shard.window`, which pads from the global T."""
    if shard is not None:
        return shard.window(x, kernel, stride, op, same, pad_value)
    if same:
        x = F.pad(x, same_pad_3d(x.shape[2:], kernel, stride),
                  value=pad_value)
    return op(x)


def max_pool3d_same(x, kernel, stride, shard=None):
    """Max pool with `SAME` padding on (B, C, T, H, W).  The padding is
    -inf, as XLA pads a max window, so any input pools exactly."""
    return window3d(x, kernel, stride,
                    lambda v: F.max_pool3d(v, kernel, stride), shard,
                    pad_value=float("-inf"))
