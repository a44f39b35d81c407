"""Optical-flow pictures (counterpart of `dmcnet_tpu/utils/viz.py`): the
Middlebury colour wheel, as the reference's viz utilities draw it
(code/dmcnet/utils.py:10-100): hue is the flow's direction, saturation its
magnitude over the 99th-percentile magnitude.  Vectorised numpy, the same
arithmetic as the JAX package's copy, so both give the same image of the
same flow.

`write_png` writes 8-bit RGB with the standard library alone (zlib and
struct), so `cli/test.py --viz` needs no imaging package."""

from __future__ import annotations

import struct
import zlib

import numpy as np


def make_colorwheel():
    """(55, 3) RGB Middlebury color wheel (RY/YG/GC/CB/BM/MR sectors)."""
    RY, YG, GC, CB, BM, MR = 15, 6, 4, 11, 13, 6
    ncols = RY + YG + GC + CB + BM + MR
    wheel = np.zeros((ncols, 3))
    col = 0

    def ramp(n):
        return np.arange(n) / n

    wheel[col:col + RY, 0] = 1
    wheel[col:col + RY, 1] = ramp(RY)
    col += RY
    wheel[col:col + YG, 0] = 1 - ramp(YG)
    wheel[col:col + YG, 1] = 1
    col += YG
    wheel[col:col + GC, 1] = 1
    wheel[col:col + GC, 2] = ramp(GC)
    col += GC
    wheel[col:col + CB, 1] = 1 - ramp(CB)
    wheel[col:col + CB, 2] = 1
    col += CB
    wheel[col:col + BM, 2] = 1
    wheel[col:col + BM, 0] = ramp(BM)
    col += BM
    wheel[col:col + MR, 2] = 1 - ramp(MR)
    wheel[col:col + MR, 0] = 1
    return wheel


def viz_flow(u, v, logscale=True, scaledown=6):
    """Flow (u, v) -> (H, W, 3) float RGB in [0, 1]."""
    u = np.asarray(u, np.float64)
    v = np.asarray(v, np.float64)
    colorwheel = make_colorwheel()
    ncols = len(colorwheel)

    radius = np.sqrt(u ** 2 + v ** 2)
    norm = max(np.percentile(radius, 99), 1e-8) / scaledown
    if logscale:
        radius = np.log1p(radius / norm)
    else:
        radius = radius / norm
    radius = np.clip(radius, 0, 1)

    rot = np.arctan2(-v, -u) / np.pi  # [-1, 1]
    fk = (rot + 1) / 2 * (ncols - 1)  # map to wheel index
    k0 = np.floor(fk).astype(int)
    k1 = (k0 + 1) % ncols
    f = fk - k0

    img = np.zeros(u.shape + (3,))
    for c in range(3):
        col0 = colorwheel[k0, c]
        col1 = colorwheel[k1, c]
        col = (1 - f) * col0 + f * col1
        # increase saturation with radius, desaturate low-magnitude flow
        img[..., c] = 1 - radius * (1 - col)
    return img


def write_png(path, rgb):
    """(H, W, 3) uint8 -> an 8-bit RGB PNG file (no filtering, one IDAT)."""
    rgb = np.ascontiguousarray(rgb, np.uint8)
    h, w, c = rgb.shape
    if c != 3:
        raise ValueError(f"write_png takes (H, W, 3) RGB, got {rgb.shape}")
    # each row starts with its filter type, 0 (none)
    raw = np.concatenate([np.zeros((h, 1), np.uint8),
                          rgb.reshape(h, w * 3)], axis=1).tobytes()

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)  # 8-bit RGB
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", header)
                + chunk(b"IDAT", zlib.compress(raw, 6))
                + chunk(b"IEND", b""))
