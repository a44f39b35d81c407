"""Color-space augmentation without cv2 (the port's copy of
`dmcnet_tpu/data/color.py`): BGR<->HLS with OpenCV's conventions (H in
[0,180], L/S in [0,255]) and the reference's HLS jitter `color_aug`
(code/dmcnet/transforms.py:15-33: random shifts of H/L/S with upper clamps
H<=180, L,S<=255, lower clamp 0), which the iframe representation uses.  The
I3D jitters wait for the I3D data path.
"""

from __future__ import annotations

import numpy as np


def bgr_to_hls(img):
    """uint8 BGR (H, W, 3) -> float HLS with OpenCV ranges."""
    b, g, r = [img[..., i].astype(np.float64) / 255.0 for i in range(3)]
    maxc = np.maximum(np.maximum(r, g), b)
    minc = np.minimum(np.minimum(r, g), b)
    l = (maxc + minc) / 2.0
    diff = maxc - minc
    s = np.zeros_like(l)
    nz = diff > 1e-12
    lo = l < 0.5
    s[nz & lo] = (diff / (maxc + minc))[nz & lo]
    s[nz & ~lo] = (diff / (2.0 - maxc - minc))[nz & ~lo]
    h = np.zeros_like(l)
    with np.errstate(invalid="ignore", divide="ignore"):
        rc = np.where(nz, (maxc - r) / diff, 0)
        gc = np.where(nz, (maxc - g) / diff, 0)
        bc = np.where(nz, (maxc - b) / diff, 0)
    h = np.where(maxc == r, bc - gc,
                 np.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = (h / 6.0) % 1.0
    h = np.where(nz, h, 0.0)
    return np.stack([h * 180.0, l * 255.0, s * 255.0], axis=-1)


def hls_to_bgr(hls):
    """float HLS (OpenCV ranges) -> uint8 BGR."""
    h = (hls[..., 0] / 180.0) % 1.0
    l = np.clip(hls[..., 1] / 255.0, 0, 1)
    s = np.clip(hls[..., 2] / 255.0, 0, 1)
    m2 = np.where(l <= 0.5, l * (1.0 + s), l + s - l * s)
    m1 = 2.0 * l - m2

    def channel(hue):
        hue = hue % 1.0
        out = np.where(hue < 1 / 6, m1 + (m2 - m1) * hue * 6.0,
                       np.where(hue < 0.5, m2,
                                np.where(hue < 2 / 3,
                                         m1 + (m2 - m1) * (2 / 3 - hue) * 6.0,
                                         m1)))
        return out

    r = channel(h + 1 / 3)
    g = channel(h)
    b = channel(h - 1 / 3)
    out = np.stack([b, g, r], axis=-1)
    return np.clip(np.round(out * 255.0), 0, 255).astype(np.uint8)


def color_aug(img, rng, random_h=36, random_l=50, random_s=50):
    """HLS jitter of a uint8 BGR image (reference transforms.py:15-33)."""
    hls = bgr_to_hls(img)
    hls[..., 0] = np.minimum(hls[..., 0] + (rng.random() * 2 - 1) * random_h,
                             180)
    hls[..., 1] = np.minimum(hls[..., 1] + (rng.random() * 2 - 1) * random_l,
                             255)
    hls[..., 2] = np.minimum(hls[..., 2] + (rng.random() * 2 - 1) * random_s,
                             255)
    hls = np.maximum(hls, 0)
    return hls_to_bgr(hls)
