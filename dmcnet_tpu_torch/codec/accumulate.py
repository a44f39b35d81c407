"""GOP accumulation in plain PyTorch on an explicit device: the port's
counterpart of `dmcnet_tpu/codec/accumulate.py`.

The native front-end decodes each GOP once into dense per-frame MV maps plus
BGR frames; these functions turn them into the accumulated (or raw) MV and
residual of every frame of the GOP at once (the reference decodes the whole
file per frame, coviar_data_loader.c:88-175, 235-253):

  * `backtrace_gop` carries the accu_src map (pixel -> source pixel in the
    I-frame) over the GOP's frames and emits it for every frame;
  * the per-step update is a 2-D gather `accu_src[p] = accu_src_old[p -
    mv[p]]`, the reference's per-block back-trace (c:111-115) written
    densely (uncovered pixels have mv == 0, so the gather is the identity).

This is the counterpart of XLA code, not of a TPU kernel, and stays plain
PyTorch on every device.  `ops.backtrace.gop_mv_residual_cuda` is the
drop-in that runs the back-trace as the B2 kernel where the motion allows.
Tensors keep the JAX package's (T, H, W, C) layout.
"""

from __future__ import annotations

import numpy as np
import torch

from dmcnet_tpu_torch import resolve_device


def _pixel_grid(height, width, device=None):
    """(H, W, 2) int32 map of each pixel's own (x, y) coordinates."""
    ys, xs = torch.meshgrid(
        torch.arange(height, dtype=torch.int32, device=device),
        torch.arange(width, dtype=torch.int32, device=device), indexing="ij")
    return torch.stack([xs, ys], dim=-1)


def _gather_hw(values, src_x, src_y):
    """values[(src_y, src_x)] for (H, W) index maps; values is (H, W, C)."""
    height, width = values.shape[0], values.shape[1]
    flat_idx = (src_y.long() * width + src_x.long()).reshape(-1)
    flat = values.reshape(height * width, -1)
    return flat[flat_idx].reshape(height, width, values.shape[-1])


def _clamped_source(ident, mv_t, height, width):
    """Source (x, y) of every pixel under motion `mv_t` (H, W, 2), clamped
    into the frame.  The native rasterizer only writes motion where both
    end points are in bounds (reference c:105-108), so the clamp never
    changes a covered pixel; it just keeps the gather total."""
    mv_t = mv_t.to(torch.int32)
    return ((ident[..., 0] - mv_t[..., 0]).clamp(0, width - 1),
            (ident[..., 1] - mv_t[..., 1]).clamp(0, height - 1))


def backtrace_gop(mv_maps):
    """Back-trace motion through a GOP, emitting accu_src for every frame.

    mv_maps (T, H, W, 2) integer tensor: `mv_maps[t]` holds (val_x, val_y) =
    dst - src for each destination pixel of frame t (zeros where no motion;
    frame 0 is the I-frame and is ignored).  Returns accu_src (T, H, W, 2)
    int32 on the same device; `accu_src[0]` is the identity map."""
    t, height, width, _ = mv_maps.shape
    ident = _pixel_grid(height, width, mv_maps.device)
    cur = ident
    out = [ident]
    for s in range(1, t):
        cur = _gather_hw(cur, *_clamped_source(ident, mv_maps[s], height,
                                               width))
        out.append(cur)
    return torch.stack(out)


def accumulated_mv_from_src(accu_src):
    """(T, H, W, 2) accumulated MV = own position - traced source
    (c:128-139)."""
    _, height, width, _ = accu_src.shape
    return _pixel_grid(height, width, accu_src.device)[None] - accu_src


def accumulated_residual_from_src(frames_bgr, accu_src):
    """(T, H, W, 3) int32 residual vs the motion-compensated I-frame
    (c:141-175): `res[t] = frames[t] - frames[0][accu_src[t]]`."""
    base = frames_bgr[0].to(torch.int32)
    comp = torch.stack([_gather_hw(base, s[..., 0], s[..., 1])
                        for s in accu_src])
    return frames_bgr.to(torch.int32) - comp


def nonaccumulated_residual(frames_bgr, mv_maps):
    """(T, H, W, 3) int32 residual vs the immediately previous frame
    (c:160-163): `res[t] = frames[t] - frames[t-1][p - mv[t][p]]`; `res[0]`
    is zeros."""
    t, height, width, _ = frames_bgr.shape
    ident = _pixel_grid(height, width, frames_bgr.device)
    frames = frames_bgr.to(torch.int32)
    res = [torch.zeros((height, width, 3), dtype=torch.int32,
                       device=frames_bgr.device)]
    for s in range(1, t):
        res.append(frames[s] - _gather_hw(
            frames[s - 1], *_clamped_source(ident, mv_maps[s], height,
                                            width)))
    return torch.stack(res)


def _as_tensor(x, device):
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.from_numpy(np.ascontiguousarray(x)).to(device)


def gop_mv_residual(mv_maps, frames_bgr, accumulate=True, device=None):
    """Accumulated (or raw) MV and residual for ALL frames of a GOP.

    mv_maps (T, H, W, 2) dense motion maps (frame 0 all-zero), frames_bgr
    (T, H, W, 3) uint8, as host arrays or tensors; `accumulate` is CoViAR's
    accumulate mode.  Runs on `device` (CUDA unless the caller passes
    "cpu").  Returns (mv (T, H, W, 2) int32: accumulated MV if `accumulate`
    else the raw maps; res (T, H, W, 3) int32: accumulated or
    frame-to-frame residual), both with frame 0 zeroed (reference
    `cur_pos > 0` guard, c:128)."""
    dev = resolve_device(device)
    mv_maps = _as_tensor(mv_maps, dev)
    frames_bgr = _as_tensor(frames_bgr, dev)
    if accumulate:
        accu_src = backtrace_gop(mv_maps)
        mv = accumulated_mv_from_src(accu_src)
        res = accumulated_residual_from_src(frames_bgr, accu_src)
    else:
        mv = mv_maps.to(torch.int32, copy=True)
        res = nonaccumulated_residual(frames_bgr, mv_maps)
    mv[0] = 0
    res[0] = 0
    return mv, res


def load_like_coviar_torch(mv_maps, frames_bgr, pos_target, representation,
                           accumulate, device=None):
    """Single-frame wrapper matching the reference `coviar.load`; for parity
    tests and the `coviar_compat` shim (production code takes every frame
    from `gop_mv_residual` at once)."""
    if representation == "iframe":
        return _as_tensor(frames_bgr, resolve_device(device))[pos_target]
    mv, res = gop_mv_residual(mv_maps, frames_bgr, accumulate, device)
    return mv[pos_target] if representation == "mv" else res[pos_target]
