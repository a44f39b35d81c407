"""Group transforms and normalization on a device (counterpart of
`dmcnet_tpu/data/transforms.py`).

Every geometric transform is a per-sample "crop spec" (scale and
translation per axis, flip) sampled on the host and executed on the device
as two separable resampling matrices contracted with the frames, so train,
center-crop and 10-crop pipelines are one code path.

The JAX package executes a spec with `jax.image.scale_and_translate(...,
method="linear", antialias=False)`.  `torch.nn.functional.interpolate` is
not the same function: scale_and_translate normalises each output's
triangle weights, zeroes outputs whose weights sum to almost nothing, and
zeroes outputs whose sample centre lies outside [-0.5, in - 0.5], and the
specs translate by fractional amounts.  `_weight_mat` builds those weights
from the same formula (jax/_src/image/scale.py `compute_weight_mat`).

Semantics preserved (reference code/dmcnet/transforms.py, dataset.py):
  * GroupMultiScaleCrop (transforms.py:117-191): scales {1, .875, .75
    (, .66)}, max_distort 1, random offsets, resize to input_size with
    half-pixel sampling;
  * GroupRandomHorizontalFlip (transforms.py:47-58): mirror and map
    channels 0 and 2 (flow_x, mv_x) to 256 - x;
  * GroupScale + GroupCenterCrop (transforms.py:36-44, 60-75) as one spec;
  * GroupOverSample (transforms.py:77-110): 5 offsets x (identity, flip);
  * flow blockify (dataset.py:229-246): block mean, then nearest repeat or
    align-corners linear upsampling;
  * normalization (dataset.py:251-263): mv/flow (x-.5)/mean(std), residual
    (x-.5)/std, iframe ImageNet mean/std.

Tensors are (B, S, C, H, W) in and out (the JAX package's are (B, S, H, W,
C)).  The channels of a group frame are [flow(2), mv(2), residual(3)] = 7
(dataset.py:215), or [flow(2), RGB(3), residual(3)] for iframe groups.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)
MEAN_STD = float(IMAGENET_STD.mean())  # 0.226 (reference dataset.py:260-262)


# ---------------------------------------------------------------------------
# Host-side crop-spec sampling
# ---------------------------------------------------------------------------

def fill_fix_offset(more_fix_crop, image_w, image_h, crop_w, crop_h):
    """The reference's 5/13 fixed crop anchor list (transforms.py:168-191)."""
    w_step = (image_w - crop_w) // 4
    h_step = (image_h - crop_h) // 4
    ret = [(0, 0), (4 * w_step, 0), (0, 4 * h_step),
           (4 * w_step, 4 * h_step), (2 * w_step, 2 * h_step)]
    if more_fix_crop:
        ret += [(0, 2 * h_step), (4 * w_step, 2 * h_step),
                (2 * w_step, 4 * h_step), (2 * w_step, 0),
                (1 * w_step, 1 * h_step), (3 * w_step, 1 * h_step),
                (1 * w_step, 3 * h_step), (3 * w_step, 3 * h_step)]
    return ret


def sample_multiscale_crop(rng, image_h, image_w, input_size,
                           scales=(1, .875, .75), max_distort=1,
                           fix_crop=False, more_fix_crop=True):
    """One (offset_h, offset_w, crop_h, crop_w) spec (reference
    _sample_crop_size, transforms.py:141-166, which names image_w what is
    shape[0]; the behaviour is kept, the names here are honest)."""
    base_size = min(image_h, image_w)
    crop_sizes = [int(base_size * s) for s in scales]
    snap = lambda c: input_size if abs(c - input_size) < 3 else c
    crop_hs = [snap(c) for c in crop_sizes]
    crop_ws = [snap(c) for c in crop_sizes]
    pairs = [(ch, cw) for i, ch in enumerate(crop_hs)
             for j, cw in enumerate(crop_ws) if abs(i - j) <= max_distort]
    crop_h, crop_w = pairs[rng.integers(len(pairs))]
    if not fix_crop:
        offset_h = int(rng.integers(0, image_h - crop_h + 1))
        offset_w = int(rng.integers(0, image_w - crop_w + 1))
    else:
        offsets = fill_fix_offset(more_fix_crop, image_w, image_h,
                                  crop_w, crop_h)
        offset_w, offset_h = offsets[rng.integers(len(offsets))]
    return offset_h, offset_w, crop_h, crop_w


def crop_spec_to_scale_translate(offset_h, offset_w, crop_h, crop_w,
                                 out_size):
    """(scale_h, scale_w, t_h, t_w) such that the output equals the bilinear
    resize of img[oh:oh+ch, ow:ow+cw] to out_size, half-pixel sampling."""
    sh = out_size / crop_h
    sw = out_size / crop_w
    return sh, sw, -offset_h * sh, -offset_w * sw


def center_crop_spec(image_h, image_w, scale_size, crop_size):
    """GroupScale(scale_size) + GroupCenterCrop(crop_size) as one spec in
    original-image coordinates: output pixel i samples resized coordinate
    i + off, i.e. original ((i + off + 0.5) * H / scale_size) - 0.5."""
    off = (scale_size - crop_size) // 2
    sh = scale_size / image_h
    sw = scale_size / image_w
    return sh, sw, -float(off), -float(off)


def oversample_specs(image_h, image_w, scale_size, crop_size):
    """GroupOverSample: scale to (scale_size)^2, then 5 fixed crops x
    (identity, flip) = 10 specs (transforms.py:77-110).  The reference's
    "w" offset indexes rows; fill_fix_offset is symmetric for the square
    scaled image, so (row, col) are used honestly."""
    sh = scale_size / image_h
    sw = scale_size / image_w
    specs = []
    for o_row, o_col in fill_fix_offset(False, scale_size, scale_size,
                                        crop_size, crop_size):
        for flip in (False, True):
            specs.append((sh, sw, -float(o_row), -float(o_col), flip))
    return specs


# ---------------------------------------------------------------------------
# Device-side resampling
# ---------------------------------------------------------------------------

_TINY_SUM = 1000.0 * float(np.finfo(np.float32).eps)


def _weight_mat(in_size, out_size, scale, translation):
    """Linear (triangle) resampling weights of `jax.image.scale_and_translate`
    with antialias=False, in float32.

    scale, translation: (B,) float32 tensors -> (B, in_size, out_size):
    output j samples input coordinate (j + 0.5 - t) / s - 0.5; each
    column's weights are normalised to sum 1 (0 where the sum is tiny), and
    zero where the sample lies outside [-0.5, in_size - 0.5]."""
    dev = scale.device
    inv_scale = 1.0 / scale
    out_pos = torch.arange(out_size, dtype=torch.float32, device=dev) + 0.5
    sample_f = (out_pos[None] * inv_scale[:, None]
                - (translation * inv_scale)[:, None] - 0.5)   # (B, out)
    in_pos = torch.arange(in_size, dtype=torch.float32, device=dev)
    x = (sample_f[:, None, :] - in_pos[None, :, None]).abs()  # (B, in, out)
    weights = (1.0 - x).clamp_min(0.0)
    total = weights.sum(dim=1, keepdim=True)
    weights = torch.where(
        total.abs() > _TINY_SUM,
        weights / torch.where(total != 0, total, torch.ones_like(total)),
        torch.zeros_like(weights))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[:, None, :], weights, torch.zeros_like(weights))


def apply_crops(frames, scales_hw, translations_hw, flips, out_size=224,
                negate_channels=(0, 2), vflips=None):
    """Batched crop + resize + flip.

    frames (B, S, C, H, W) float32 group frames (encoded domain 0..255);
    scales_hw, translations_hw (B, 2) float32 per-sample specs; flips (B,)
    bool.  `negate_channels` are mapped to 256 - x on a mirror: (0, 2) for
    the [flow, mv, residual] layout (flow_x, mv_x), (0,) for iframe groups.
    `vflips` (B,) bool are vertical flips with no channel negation
    (reference RandomVerticalFlip, image_transforms.py:202-212).  Returns
    (B, S, C, out_size, out_size) float32 on the frames' device."""
    dev = frames.device
    scales_hw = torch.as_tensor(scales_hw, dtype=torch.float32, device=dev)
    translations_hw = torch.as_tensor(translations_hw, dtype=torch.float32,
                                      device=dev)
    flips = torch.as_tensor(flips, dtype=torch.bool, device=dev)
    h, w = frames.shape[-2:]
    wh = _weight_mat(h, out_size, scales_hw[:, 0], translations_hw[:, 0])
    ww = _weight_mat(w, out_size, scales_hw[:, 1], translations_hw[:, 1])
    out = torch.einsum("bschw,bwq->bschq", frames, ww)
    out = torch.einsum("bschq,bhp->bscpq", out, wh)
    mirrored = out.flip(-1)
    if negate_channels:
        ch = list(negate_channels)
        mirrored[:, :, ch] = 256.0 - mirrored[:, :, ch]
    out = torch.where(flips[:, None, None, None, None], mirrored, out)
    if vflips is not None:
        vflips = torch.as_tensor(vflips, dtype=torch.bool, device=dev)
        out = torch.where(vflips[:, None, None, None, None], out.flip(-2),
                          out)
    return out


def _align_corners_upsample_axis(x, factor, axis):
    """scipy interp1d(linspace(0,1,n)) evaluated at linspace(0,1,n*f):
    align-corners linear upsampling (dataset.py:239-245), as the JAX
    package's scale_and_translate with x_in = a * x_out."""
    n_in = x.shape[axis]
    n_out = n_in * factor
    a = (n_in - 1) / (n_out - 1) if n_out > 1 else 0.0
    scale = 1.0 / a if a else 1.0
    # scale_and_translate samples x_in = (x_out + 0.5 - t)/s - 0.5
    trans = 0.5 - 0.5 * scale
    wmat = _weight_mat(
        n_in, n_out,
        torch.full((1,), scale, dtype=torch.float32, device=x.device),
        torch.full((1,), trans, dtype=torch.float32, device=x.device))[0]
    out = torch.tensordot(x.movedim(axis, -1), wmat, dims=1)
    return out.movedim(-1, axis)


def blockify_flow(flow, factor, upsample_interp=False):
    """Block-mean the flow, then upsample back (dataset.py:229-246).

    flow (..., C, H, W); `factor` divides H and W (0 = unchanged)."""
    if factor == 0:
        return flow
    *lead, c, h, w = flow.shape
    x = F.avg_pool2d(flow.reshape(-1, c, h, w), factor)
    if upsample_interp:
        x = _align_corners_upsample_axis(x, factor, 2)
        x = _align_corners_upsample_axis(x, factor, 3)
    else:
        x = x.repeat_interleave(factor, 2).repeat_interleave(factor, 3)
    return x.reshape(tuple(lead) + (c, h, w))


def normalize_group(frames, representation, flow_ds_factor=0,
                    upsample_interp=False):
    """Split a (B, S, C, out, out) group stack into normalized model inputs.

    Returns dict(flow, mv, residual), each (B, S, c, out, out) float32
    (dataset.py:224-263).  For `representation == "iframe"` the `mv` slot
    carries the RGB iframe instead (the reference reuses the variable)."""
    dev = frames.device

    def per_channel(v):
        return torch.as_tensor(v, device=dev).reshape(-1, 1, 1)

    x = frames / 255.0
    flow = (x[:, :, 0:2] - 0.5) / MEAN_STD
    if flow_ds_factor:
        flow = blockify_flow(flow, flow_ds_factor, upsample_interp)
    if representation == "iframe":
        mv = (x[:, :, 2:5] - per_channel(IMAGENET_MEAN)) \
            / per_channel(IMAGENET_STD)
        residual = x[:, :, 5:]
    else:
        mv = (x[:, :, 2:4] - 0.5) / MEAN_STD
        residual = (x[:, :, 4:7] - 0.5) / per_channel(IMAGENET_STD)
    return {"flow": flow, "mv": mv, "residual": residual}


def clip_and_scale(img, bound=20.0):
    """MV min-max normalization: +-bound -> +-127.5 (dataset.py:40-43)."""
    return np.asarray(img, np.float64) * (127.5 / bound)
