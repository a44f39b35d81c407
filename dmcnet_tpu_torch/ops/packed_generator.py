"""Space-to-depth packed DMC generator: the port's counterpart of
`dmcnet_tpu/ops/packed_generator.py`.

The dense estimators' convolutions have tiny channel counts (5 -> 8/8/6/4/2
-> 2 for DenseNetTiny, reference code/dmcnet/model.py:172-194).  Packing
rewrites the generator as an exactly equivalent sequence of convolutions
on a space-to-depth layout:

    pack s=2: (B, C, 224, 224) -> (B, 4C, 112, 112)

Each 3x3 convolution becomes one packed 3x3 convolution whose input and
output channel counts are s*s times larger (20 -> 32, ..., 132 -> 8 at
s=2).  LeakyReLU and the dense concatenation act position by position, so
they commute with packing; the packed weights are a zero-filled
block-Toeplitz rearrangement of the original ones.

Tensors are NCHW.  The packed channel order is the JAX package's,
(py*s + px)*C + c, not `F.pixel_unshuffle`'s c*s*s + py*s + px, so packed
weights (OIHW here) equal the JAX package's packed HWIO weights bit for bit
after a transpose.

  * `PackedDenseEstimator` is the serving generator
    (`serving.DMCPredictor(pack=True)`): bfloat16, the u8 normalize folded
    into the weights (`input_affine`), the `+mv` delta fused into
    `predict_flow` (`fuse_mv_delta`) and its output left packed for
    `ops.packed_resnet.PackedResNet18` (`packed_output`).
  * `pack_conv3x3_torch` is the differentiable pack that
    `models.generators._DenseEstimator(packed=s)` (`--packed-gen s`) trains
    and scores with: the same parameters, gradients reaching them.
  * `QuantizedPackedEstimator` is experimental int8 inference, off every
    path, as in the JAX package.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

_LEAKY_SLOPE = 0.1


def space_to_depth(x, s):
    """(B, C, H, W) -> (B, s*s*C, H/s, W/s); channel index (py*s+px)*C + c."""
    b, c, h, w = x.shape
    x = x.reshape(b, c, h // s, s, w // s, s).permute(0, 3, 5, 1, 2, 4)
    return x.reshape(b, s * s * c, h // s, w // s)


def depth_to_space(x, s):
    """Inverse of `space_to_depth`: (B, s*s*C, H/s, W/s) -> (B, C, H, W)."""
    b, sc, hs, ws = x.shape
    c = sc // (s * s)
    x = x.reshape(b, s, s, c, hs, ws).permute(0, 3, 4, 1, 5, 2)
    return x.reshape(b, c, hs * s, ws * s)


def repack(x, s_from, s_to, c):
    """Re-express an s_from packing of `c` channels as an s_to packing
    without a round trip through the unpacked layout:
    (B, s_from^2*c, H/s_from, W/s_from) -> (B, s_to^2*c, H/s_to, W/s_to).
    Bridges a generator run at s=4 into the s=2 classifier stem."""
    if s_from % s_to:
        raise ValueError(f"s_from {s_from} is not a multiple of s_to {s_to}")
    b, _, hf, wf = x.shape
    r = s_from // s_to
    # channel (ry, ty, rx, tx, c) -> (ty, tx, c); rows (hf, ry), cols (wf, rx)
    x = x.reshape(b, r, s_to, r, s_to, c, hf, wf).permute(
        0, 2, 4, 5, 6, 1, 7, 3)
    return x.reshape(b, s_to * s_to * c, hf * r, wf * r)


def _packed_index(segments, s, p, ci):
    """Packed channel index of (block position p, original channel ci) in a
    packed concat of tensors with original channel counts `segments`."""
    off = 0
    for seg in segments:
        if ci < seg:
            return off + p * seg + ci
        off += seg * s * s
        ci -= seg
    raise IndexError(ci)


def _tap_split(s, q, d):
    """Block-local position `q` and 3x3 tap offset `d` -> (packed tap in
    0..2, position in the neighbouring block)."""
    a = q + d - 1
    return (a + s) // s, (a + s) % s


def pack_conv3x3(w, b, s, in_segments):
    """A 3x3 stride-1 SAME conv (C_out, C_in, 3, 3) in the packed layout.
    `in_segments`: original channel counts of the packed concat segments
    making up the input, in order.  Returns (w_packed (s*s*C_out, s*s*C_in,
    3, 3), b_packed (s*s*C_out,) or None); numpy in, numpy out."""
    c_out, c_in, kh, kw = w.shape
    if (kh, kw) != (3, 3) or sum(in_segments) != c_in:
        raise ValueError(f"a 3x3 conv over {sum(in_segments)} channels, "
                         f"not {w.shape}")
    wp = np.zeros((s * s * c_out, s * s * c_in, 3, 3), w.dtype)
    for qy in range(s):
        for qx in range(s):
            q_out = qy * s + qx
            for dy in range(3):
                for dx in range(3):
                    ky, py = _tap_split(s, qy, dy)
                    kx, px = _tap_split(s, qx, dx)
                    idx = [_packed_index(in_segments, s, py * s + px, ci)
                           for ci in range(c_in)]
                    wp[q_out * c_out:(q_out + 1) * c_out, idx, ky, kx] = \
                        w[:, :, dy, dx]
    bp = None if b is None else np.tile(np.asarray(b), s * s)
    return wp, bp


@functools.lru_cache(maxsize=None)
def _pack_plan(s, in_segments, c_in):
    """Static scatter plan of `pack_conv3x3`: index arrays (ky, kx, rows,
    q_outs, sdy, sdx, sci), one entry per placed (C_in -> C_out) weight
    column: its packed tap, packed input row and output block, and its
    source tap and input channel.  No two entries share a destination."""
    plan = [[] for _ in range(7)]
    for qy in range(s):
        for qx in range(s):
            for dy in range(3):
                for dx in range(3):
                    ky, py = _tap_split(s, qy, dy)
                    kx, px = _tap_split(s, qx, dx)
                    for ci in range(c_in):
                        row = _packed_index(in_segments, s, py * s + px, ci)
                        for lst, v in zip(plan, (ky, kx, row, qy * s + qx,
                                                 dy, dx, ci)):
                            lst.append(v)
    return tuple(np.asarray(a, np.int64) for a in plan)


@functools.lru_cache(maxsize=None)
def _plan_on(s, in_segments, c_in, device):
    return tuple(torch.as_tensor(a, device=device)
                 for a in _pack_plan(s, in_segments, c_in))


def pack_conv3x3_torch(w, b, s, in_segments):
    """Differentiable twin of `pack_conv3x3` on torch tensors (the JAX
    package's `pack_conv3x3_jnp`): one `index_put` with accumulate over the
    cached static plan, so gradients reach the unpacked `w` and `b`."""
    c_out, c_in = w.shape[:2]
    ky, kx, rows, q_outs, sdy, sdx, sci = _plan_on(
        s, tuple(in_segments), c_in, w.device)
    cols = w.permute(2, 3, 1, 0)[sdy, sdx, sci]           # (N, C_out)
    wp = w.new_zeros((3, 3, s * s * c_in, s * s, c_out)).index_put(
        (ky, kx, rows, q_outs), cols, accumulate=True)
    wp = wp.reshape(3, 3, s * s * c_in, s * s * c_out).permute(3, 2, 0, 1)
    return wp.contiguous(), None if b is None else b.repeat(s * s)


def _dense_convs(estimator):
    """[(name, nn.Conv2d)] of a `models.generators._DenseEstimator`."""
    names = [f"conv_{i}" for i in range(len(estimator.widths))] \
        + ["predict_flow"]
    convs = []
    for name in names:
        m = getattr(estimator, name)
        convs.append((name, m[0] if isinstance(m, nn.Sequential) else m))
    return convs


class PackedDenseEstimator(nn.Module):
    """Packed inference twin of a dense estimator
    (`models.generators._DenseEstimator`), built from its weights; called
    on NCHW inputs whose H and W divide by `s`, it returns what the
    estimator does.  The packed weights are buffers in `dtype`, so
    `.to(device)` moves them.

    `packed_output` keeps the result packed, (B, s*s*2, H/s, W/s), for a
    packed consumer (`PackedResNet18`'s stem).  `fuse_mv_delta` adds the
    input's mv (channels 0:2) to the output through an identity tap of
    `predict_flow`, whose input concat ends with the raw input
    (`gen_flow_or_delta=1`, reference model.py:345-346).
    `input_affine=(scale, shift)`, each (C_in,): the estimator was trained
    on `scale*x + shift` but is called with raw x (the serving normalize,
    reference dataset.py:260-262); the raw input rides the dense concat
    into every conv, so each layer's raw rows are rescaled and the shift
    becomes a bias.  SAME zero padding gives border pixels fewer raw taps,
    so that bias is a per-position plane (`bias_plane`: interior the full
    sum, the border ring its in-bounds taps only), built once per shape
    and device.  `memory_format` is the layout the convolutions run in
    (NCHW, or `torch.channels_last` throughout the dense concat)."""

    def __init__(self, estimator, s=2, dtype=torch.bfloat16,
                 packed_output=False, fuse_mv_delta=False, input_affine=None,
                 memory_format=torch.contiguous_format):
        super().__init__()
        convs = _dense_convs(estimator)
        ch_in = convs[0][1].in_channels
        self.s, self.ch_in, self.dtype = s, ch_in, dtype
        self.packed_output = packed_output
        self.input_affine = input_affine
        self.memory_format = memory_format
        if input_affine is not None:
            a_in = np.asarray(input_affine[0], np.float32)
            b_in = np.asarray(input_affine[1], np.float32)
            if a_in.shape != (ch_in,) or b_in.shape != (ch_in,):
                raise ValueError(f"input_affine needs two ({ch_in},) arrays")
        self._tap_shift = []   # per layer: (C_out, 3, 3) = sum_raw w*shift
        self._planes = {}      # (layer, H, W, device, dtype) -> plane
        self.n_layers = len(convs)
        segments = [ch_in]
        for i, (name, conv) in enumerate(convs):
            w = conv.weight.detach().float().cpu().numpy()
            b = conv.bias.detach().float().cpu().numpy()
            wp, bp = pack_conv3x3(w, b, s, segments)
            if name == "predict_flow" and fuse_mv_delta:
                # with input_affine the tap is folded below like any raw
                # row, so the output still adds the NORMALIZED mv
                for p in range(s * s):
                    for c in range(2):
                        wp[p * 2 + c, _packed_index(
                            segments, s, p, c + sum(segments[:-1])), 1, 1] \
                            += 1.0
            if input_affine is not None:
                off = (sum(segments) - ch_in) * s * s  # the raw segment last
                tap_s = np.zeros((wp.shape[0], 3, 3), np.float32)
                for p in range(s * s):
                    for ci in range(ch_in):
                        row = off + p * ch_in + ci
                        tap_s += wp[:, row] * b_in[ci]
                        wp[:, row] *= a_in[ci]
                self._tap_shift.append(tap_s)
            self.register_buffer(f"weight_{i}", torch.from_numpy(wp).to(
                dtype).contiguous(memory_format=memory_format))
            self.register_buffer(f"bias_{i}", torch.from_numpy(bp).to(dtype))
            if i < len(convs) - 1:
                segments = [conv.out_channels] + segments

    def layer(self, i):
        """(packed weight, packed bias) of layer `i`."""
        return getattr(self, f"weight_{i}"), getattr(self, f"bias_{i}")

    def bias_plane(self, i, hh, ww, device):
        """(C_out, hh, ww) float32 bias of layer `i` under `input_affine`:
        the layer's bias (as stored, in `dtype`) plus the absorbed input
        shift, border positions crediting their in-bounds taps only."""
        key = (i, hh, ww, torch.device(device), self.dtype)
        if key not in self._planes:
            tap_s = self._tap_shift[i]
            bias = self.layer(i)[1].float().cpu().numpy()
            plane = np.broadcast_to(bias[:, None, None],
                                    (tap_s.shape[0], hh, ww)).copy()
            for dy in range(3):
                for dx in range(3):
                    y0, y1 = max(0, 1 - dy), min(hh, hh + 1 - dy)
                    x0, x1 = max(0, 1 - dx), min(ww, ww + 1 - dx)
                    plane[:, y0:y1, x0:x1] += tap_s[:, dy, dx, None, None]
            self._planes[key] = torch.from_numpy(plane).to(device)
        return self._planes[key]

    def forward(self, x):
        """x: (B, C_in, H, W), H and W divisible by `s` -> (B, 2, H, W), or
        packed with `packed_output`.  With `input_affine`, x is raw."""
        s = self.s
        if x.shape[2] % s or x.shape[3] % s:
            raise ValueError(f"H, W = {tuple(x.shape[2:])} do not divide by "
                             f"the packing factor {s}")
        h = space_to_depth(x.to(self.dtype), s).contiguous(
            memory_format=self.memory_format)
        for i in range(self.n_layers):
            wp, bp = self.layer(i)
            if self.input_affine is not None:
                y = F.conv2d(h, wp, padding=1)
                y = (y + self.bias_plane(i, y.shape[2], y.shape[3],
                                         y.device)).to(self.dtype)
            else:
                y = F.conv2d(h, wp, bp, padding=1)
            if i < self.n_layers - 1:
                h = torch.cat([F.leaky_relu(y, _LEAKY_SLOPE), h], dim=1)
        return y if self.packed_output else depth_to_space(y, s)


def int_conv3x3_f64(h_q, w_q):
    """Exact int32 sums of a 3x3 SAME conv of int8 activations `h_q` (B, C,
    H, W) with int8 weights `w_q` (N, C, 3, 3): a float64 convolution of
    the int8 values, exact since every partial sum stays far below 2**53.
    The CPU route of `QuantizedPackedEstimator`."""
    return F.conv2d(h_q.double(), w_q.double(), padding=1).to(torch.int32)


def int_conv3x3_gemm(h_q, w_q):
    """The same sums as an int8 implicit GEMM, the card's route: the 9
    shifted views gathered into (B*H*W, 9C) int8 rows, K and N padded to
    multiples of 8, one `torch._int_mm` accumulating in int32."""
    b, c, hh, ww = h_q.shape
    n, k = w_q.shape[0], 9 * c
    k8, n8 = -(-k // 8) * 8, -(-n // 8) * 8
    hp = F.pad(h_q, (1, 1, 1, 1))
    a = h_q.new_zeros((b * hh * ww, k8))
    # row (b, y, x), column (c, ky, kx): the OIHW weight's flattening
    a[:, :k] = torch.stack([hp[:, :, dy:dy + hh, dx:dx + ww]
                            for dy in range(3) for dx in range(3)], dim=-1) \
        .permute(0, 2, 3, 1, 4).reshape(b * hh * ww, k)
    wt = w_q.new_zeros((n8, k8))
    wt[:n, :k] = w_q.reshape(n, k)
    out = torch._int_mm(a, wt.t())[:, :n]
    return out.reshape(b, hh, ww, n).permute(0, 3, 1, 2)


class QuantizedPackedEstimator(nn.Module):
    """EXPERIMENTAL int8 inference of the packed generator, as in the JAX
    package: off every path.

    Per-output-channel weight scales and per-layer activation scales from
    one float32 calibration forward over `calib_x`; each packed conv runs
    int8 x int8 -> int32 (`int_conv3x3_gemm` on the card,
    `int_conv3x3_f64` on the CPU: the same exact sums), then dequantizes
    and adds the bias in float32.  Its error against float32 is bounded
    by the tests (under 5% mean relative)."""

    def __init__(self, estimator, calib_x, s=2):
        super().__init__()
        base = PackedDenseEstimator(estimator, s=s, dtype=torch.float32)
        self.s, self.n_layers = s, base.n_layers
        self.a_scales = []
        h = space_to_depth(calib_x.detach().float().cpu(), s)
        for i in range(self.n_layers):
            wp, bp = base.layer(i)
            a_scale = float(h.abs().max()) / 127.0 + 1e-8
            w = wp.numpy()
            w_scale = np.abs(w).reshape(w.shape[0], -1).max(axis=1) \
                / 127.0 + 1e-8
            w_q = np.clip(np.round(w / w_scale[:, None, None, None]),
                          -127, 127).astype(np.int8)
            self.a_scales.append(a_scale)
            self.register_buffer(f"weight_q_{i}", torch.from_numpy(w_q))
            self.register_buffer(f"dequant_{i}", torch.from_numpy(
                (w_scale * a_scale).astype(np.float32)))
            self.register_buffer(f"bias_{i}", bp.clone())
            with torch.no_grad():
                y = F.conv2d(h, wp, bp, padding=1)
            if i < self.n_layers - 1:
                h = torch.cat([F.leaky_relu(y, _LEAKY_SLOPE), h], dim=1)

    def forward(self, x, int_conv=None):
        """`int_conv` replaces the route chosen by the device (a check
        runs both on one card)."""
        if int_conv is None:
            int_conv = int_conv3x3_gemm if x.device.type == "cuda" \
                else int_conv3x3_f64
        s = self.s
        h = space_to_depth(x.float(), s)
        for i in range(self.n_layers):
            h_q = torch.clamp(torch.round(h / self.a_scales[i]), -127, 127) \
                .to(torch.int8)
            y = int_conv(h_q, getattr(self, f"weight_q_{i}")).float() \
                * getattr(self, f"dequant_{i}")[:, None, None] \
                + getattr(self, f"bias_{i}")[:, None, None]
            if i < self.n_layers - 1:
                h = torch.cat([F.leaky_relu(y, _LEAKY_SLOPE), h], dim=1)
        return depth_to_space(y, s)
