"""Host GOP accumulation over the native library: the host backend of
serving (counterpart of `dmcnet_tpu/codec/host_accumulate.py`)."""

from __future__ import annotations

import ctypes

import numpy as np


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
