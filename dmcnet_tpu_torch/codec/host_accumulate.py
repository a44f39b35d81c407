"""Host GOP accumulation: the host backend of serving and the dataset's
GOP cache (counterpart of `dmcnet_tpu/codec/host_accumulate.py`).

Same dense-map semantics as `codec.accumulate.gop_mv_residual` (tested for
bit-parity), run on the host so loader threads accumulate each decoded GOP
once and cache it.  The native functions release no Python object and need
the native library; `gop_mv_residual_numpy` needs nothing but numpy."""

from __future__ import annotations

import ctypes

import numpy as np

from dmcnet_tpu_torch.codec.semantics import _identity_src


def gop_mv_residual_native(mv_maps, frames_bgr, accumulate=True):
    """Native `cv_accumulate_gop`: the outputs of `gop_mv_residual_numpy`
    ((T, H, W, 2) and (T, H, W, 3) int32, frame 0 zero), in C++."""
    from dmcnet_tpu_torch.codec.mpeg4 import _lib

    mv_maps = np.ascontiguousarray(mv_maps, np.int16)
    frames = np.ascontiguousarray(frames_bgr, np.uint8)
    t, h, w, _ = mv_maps.shape
    mv_out = np.empty((t, h, w, 2), np.int32)
    res_out = np.empty((t, h, w, 3), np.int32)
    _lib().cv_accumulate_gop(
        mv_maps.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
        frames.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        t, h, w, int(bool(accumulate)),
        mv_out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        res_out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return mv_out, res_out


def gop_mv_residual_u8(mv_maps, frames_bgr, accumulate=True,
                       minmax_bound=None):
    """Native `cv_accumulate_gop_u8`: (T, H, W, 2) dense MV maps and
    (T, H, W, 3) uint8 frames -> the uint8-encoded loader representation
    (mv_u8 (T, H, W, 2): min-max scale by 127.5/minmax_bound, truncated,
    +128, clipped; res_u8 (T, H, W, 3): residual +128, clipped; frame 0
    zero before the offset) — reference dataset.py:195-213."""
    from dmcnet_tpu_torch.codec.mpeg4 import _lib

    mv_maps = np.ascontiguousarray(mv_maps, np.int16)
    frames = np.ascontiguousarray(frames_bgr, np.uint8)
    t, h, w, _ = mv_maps.shape
    mv_u8 = np.empty((t, h, w, 2), np.uint8)
    res_u8 = np.empty((t, h, w, 3), np.uint8)
    scale = (127.5 / minmax_bound) if minmax_bound else 0.0
    _lib().cv_accumulate_gop_u8(
        mv_maps.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
        frames.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        t, h, w, int(bool(accumulate)), scale,
        mv_u8.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        res_u8.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return mv_u8, res_u8


def gop_mv_residual_numpy(mv_maps, frames_bgr, accumulate=True):
    """NumPy twin of accumulate.gop_mv_residual: (T,H,W,2|3) int32 outputs."""
    mv_maps = np.asarray(mv_maps, np.int32)
    frames_bgr = np.asarray(frames_bgr)
    t, height, width, _ = mv_maps.shape
    ident = _identity_src(height, width)

    if accumulate:
        accu = np.empty((t, height, width, 2), np.int32)
        accu[0] = ident
        cur = ident
        for i in range(1, t):
            src_x = np.clip(ident[..., 0] - mv_maps[i, ..., 0], 0, width - 1)
            src_y = np.clip(ident[..., 1] - mv_maps[i, ..., 1], 0, height - 1)
            cur = cur[src_y, src_x]
            accu[i] = cur
        mv = ident[None] - accu
        base = frames_bgr[0].astype(np.int32)
        res = frames_bgr.astype(np.int32) - base[accu[..., 1], accu[..., 0]]
    else:
        mv = mv_maps.copy()
        res = np.zeros((t, height, width, 3), np.int32)
        for i in range(1, t):
            src_x = np.clip(ident[..., 0] - mv_maps[i, ..., 0], 0, width - 1)
            src_y = np.clip(ident[..., 1] - mv_maps[i, ..., 1], 0, height - 1)
            res[i] = (frames_bgr[i].astype(np.int32)
                      - frames_bgr[i - 1].astype(np.int32)[src_y, src_x])
    mv[0] = 0
    res[0] = 0
    return mv, res
