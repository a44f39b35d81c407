"""GOP motion back-trace: the port's counterpart of
`dmcnet_tpu/ops/pallas_backtrace.py`.

  * `cell_mv_from_blocks` / `cell_mv_from_blocks_np` turn MV block lists
    into per-cell motion grids, and `cell_mv_from_dense` / `coarsen_cell_mv`
    turn dense per-pixel maps into them, with the JAX package's acceptance
    rules (`max_mv(cell)` = 64 - cell, cell-uniform motion), so that GOPs
    route to the kernel or the dense path exactly as they do there.
  * `backtrace_warp_batch` (B1: G GOPs, source map and warped I-frame) and
    `backtrace_gop_cells` (B2: one GOP, source map only) are the wrappers of
    the hand-written CUDA kernels in `ops/csrc/backtrace_warp.cu`, which
    replace the TPU kernels of the same names.  For CUDA tensors they launch
    the kernel or raise; for CPU tensors they run the plain version.
  * `backtrace_warp_batch_ref` / `backtrace_gop_cells_ref` are those plain
    PyTorch versions: the same computation as the JAX package's exact twin
    `backtrace_warp_batch_xla` (densify the cells, zero the motion whose
    source is out of bounds, then a sequential gather over t).
  * `backtrace_gop_cuda` / `gop_mv_residual_cuda` are the dense-map drop-ins
    for `codec.accumulate.backtrace_gop` / `gop_mv_residual`
    (`backtrace_gop_pallas` / `gop_mv_residual_pallas` there), with the
    same routing between B2 and the dense scan.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from dmcnet_tpu_torch import resolve_device
from dmcnet_tpu_torch.codec.accumulate import (
    accumulated_mv_from_src,
    accumulated_residual_from_src,
    backtrace_gop,
)

CELL = 8
_PAD = 64  # motion slack of the TPU kernel's fetch windows: max_mv = 64 - cell


def max_mv(cell=CELL):
    """Largest |mv| a stream may carry at `cell` and still take the device
    path (the JAX package's kernel bound, kept so routing matches)."""
    return _PAD - cell


def cell_mv_from_blocks(blocks, n_blocks, height, width):
    """Per-cell MV grid straight from MV block lists.

    `blocks` (T, max_blocks, 6) int32 [src_x, src_y, dst_x, dst_y, w, h]
    (block centres, FFmpeg AVMotionVector convention); `n_blocks` (T,)
    valid-row counts.  Returns (cell_mv (T, H/cell, W/cell, 2) int32, cell)
    at the largest uniform cell (16 for pure-1MV frames, 8 when 4MV blocks
    appear), or (None, 0) when any block is unaligned to an 8-pixel grid,
    |mv| exceeds `max_mv(cell)`, or H/W do not divide.  Runs the native
    `cv_cells_from_blocks`; `cell_mv_from_blocks_np` is its executable spec
    and the fallback when the native library cannot be built."""
    from dmcnet_tpu_torch.codec.mpeg4 import NativeCodecUnavailable, _lib

    blocks = np.ascontiguousarray(blocks, np.int32)
    n_blocks = np.ascontiguousarray(n_blocks, np.int32)
    try:
        lib = _lib()
    except NativeCodecUnavailable:
        return cell_mv_from_blocks_np(blocks, n_blocks, height, width)
    t = blocks.shape[0]
    i32p = ctypes.POINTER(ctypes.c_int32)
    for cell in (16, 8):
        if height % cell or width % cell:
            continue
        grids = np.zeros((t, height // cell, width // cell, 2), np.int32)
        if lib.cv_cells_from_blocks(
                blocks.ctypes.data_as(i32p), n_blocks.ctypes.data_as(i32p),
                t, blocks.shape[1], height, width, cell, max_mv(cell),
                grids.ctypes.data_as(i32p)):
            return grids, cell
    return None, 0


def cell_mv_from_blocks_np(blocks, n_blocks, height, width):
    """Pure-numpy `cell_mv_from_blocks` (the executable spec)."""
    blocks = np.asarray(blocks, np.int32)
    n_blocks = np.asarray(n_blocks, np.int32)
    t = blocks.shape[0]
    for cell in (16, 8):
        if height % cell or width % cell:
            continue
        grids = np.zeros((t, height // cell, width // cell, 2), np.int32)
        ok = True
        for ti in range(t):
            bs = blocks[ti, :n_blocks[ti]]
            if not len(bs):
                continue
            w_, h_ = bs[:, 4], bs[:, 5]
            x0 = bs[:, 2] - w_ // 2
            y0 = bs[:, 3] - h_ // 2
            val = bs[:, 2:4] - bs[:, 0:2]
            if (np.abs(val).max(initial=0) > max_mv(cell)
                    or (w_ % cell).any() or (h_ % cell).any()
                    or (x0 % cell).any() or (y0 % cell).any()
                    or (x0 < 0).any() or (y0 < 0).any()
                    or (x0 + w_ > width).any() or (y0 + h_ > height).any()):
                ok = False
                break
            # MPEG-4 blocks never overlap, so scatter order is irrelevant.
            for (bw, bh) in {(int(a), int(b))
                             for a, b in zip(w_ // cell, h_ // cell)}:
                sel = (w_ // cell == bw) & (h_ // cell == bh)
                cy = y0[sel] // cell
                cx = x0[sel] // cell
                v = val[sel]
                for dy in range(bh):
                    for dx in range(bw):
                        grids[ti, cy + dy, cx + dx] = v
        if ok:
            return grids, cell
    return None, 0


def cell_mv_from_dense(mv_maps, cell=CELL):
    """Per-cell MV grid from dense (T, H, W, 2) per-pixel maps.

    Returns (cell_mv (T, H/cell, W/cell, 2) int32, ok); ok is False when a
    cell carries two different nonzero motions or |mv| exceeds
    `max_mv(cell)` (the caller then takes the dense path)."""
    mv = np.asarray(mv_maps, np.int32)
    t, h, w, _ = mv.shape
    if h % cell or w % cell:
        raise ValueError(f"cell {cell} does not divide {h}x{w}")
    cells = mv.reshape(t, h // cell, cell, w // cell, cell, 2)
    cells = cells.transpose(0, 1, 3, 2, 4, 5)
    flat = cells.reshape(t, h // cell, w // cell, cell * cell, 2)
    mag = np.abs(flat).sum(-1)
    pick = mag.argmax(-1)
    cell_mv = np.take_along_axis(
        flat, pick[..., None, None], axis=3)[..., 0, :]
    nonzero = mag > 0
    matches = (flat == cell_mv[..., None, :]).all(-1)
    ok = bool((matches | ~nonzero).all()) and bool(
        np.abs(cell_mv).max(initial=0) <= max_mv(cell))
    return cell_mv, ok


def coarsen_cell_mv(cell_mv, height, width, factor=2, cell=CELL):
    """Coarsen a per-cell MV grid by `factor` (8x8 cells -> 16x16).

    A zero sub-cell inside a moving group is mergeable only when it is
    fully clipped under the group's motion (its whole source window out of
    bounds): the kernel's per-pixel validity test then reproduces it
    exactly; a static sub-cell (4MV mode, 8x8 blocks) refuses.  Returns
    (coarse (T, ncy/f, ncx/f, 2), ok); ok is False when any group mixes
    motions, the grid does not divide, or |mv| exceeds the coarser cell's
    `max_mv`."""
    cm = np.asarray(cell_mv, np.int32)
    t, ncy, ncx, _ = cm.shape
    if ncy % factor or ncx % factor:
        return cm, False
    g = cm.reshape(t, ncy // factor, factor, ncx // factor, factor, 2)
    gt = g.transpose(0, 1, 3, 2, 4, 5).reshape(
        t, ncy // factor, ncx // factor, factor * factor, 2)
    mag = np.abs(gt).sum(-1)
    pick = mag.argmax(-1)
    coarse = np.take_along_axis(gt, pick[..., None, None], axis=3)[..., 0, :]
    nonzero = mag > 0
    matches = (gt == coarse[..., None, :]).all(-1)
    # Sub-cell pixel origins (y0, x0) per group slot q = ry*factor + rx.
    ry = np.repeat(np.arange(factor), factor)
    rx = np.tile(np.arange(factor), factor)
    y0 = (np.arange(ncy // factor)[None, :, None, None] * factor
          + ry[None, None, None, :]) * cell
    x0 = (np.arange(ncx // factor)[None, None, :, None] * factor
          + rx[None, None, None, :]) * cell
    mx, my = coarse[..., 0:1], coarse[..., 1:2]
    clipped_y = (y0 + cell - my <= 0) | (y0 - my >= height)
    clipped_x = (x0 + cell - mx <= 0) | (x0 - mx >= width)
    safe_zero = clipped_y | clipped_x
    ok = bool((matches | (~nonzero & safe_zero)).all()) and bool(
        np.abs(coarse).max(initial=0) <= max_mv(cell * factor))
    return coarse, ok


def _check_cells(cell_mv, lead, height, width, cell):
    """`cell_mv` must be int32 of shape lead + (H/cell, W/cell, 2), where
    `lead` names the leading axes ("G, T" or "T")."""
    if cell not in (8, 16):
        raise ValueError(f"cell must be 8 or 16, got {cell}")
    if height % cell or width % cell:
        raise ValueError(f"cell {cell} does not divide {height}x{width}")
    n_lead = len(lead.split(","))
    if cell_mv.dim() != n_lead + 3 or cell_mv.shape[n_lead:] != (
            height // cell, width // cell, 2):
        raise ValueError(f"cell_mv shape {tuple(cell_mv.shape)} is not "
                         f"({lead}, {height // cell}, {width // cell}, 2)")
    if cell_mv.dtype != torch.int32:
        raise TypeError(f"cell_mv must be int32, got {cell_mv.dtype}")


def _check_args(cell_mv, iframes, height, width, cell):
    _check_cells(cell_mv, "G, T", height, width, cell)
    g = cell_mv.shape[0]
    if iframes.shape != (g, 3, height, width):
        raise ValueError(f"iframes shape {tuple(iframes.shape)} is not "
                         f"({g}, 3, {height}, {width})")
    if iframes.dtype != torch.int32:
        raise TypeError(f"iframes must be int32, got {iframes.dtype}")
    if cell_mv.device != iframes.device:
        raise ValueError(f"cell_mv on {cell_mv.device}, iframes on "
                         f"{iframes.device}")


def _trace_ref(cell_mv, height, width, cell):
    """Plain back-trace of (G, T, ncy, ncx, 2) cells -> (G, T, H*W) int64
    flat source index of every pixel in its GOP's I-frame."""
    g, t = cell_mv.shape[:2]
    dev = cell_mv.device
    dense = cell_mv.repeat_interleave(cell, 2).repeat_interleave(cell, 3)
    xs = torch.arange(width, dtype=torch.int32, device=dev)
    ys = torch.arange(height, dtype=torch.int32, device=dev)[:, None]
    sx = xs - dense[..., 0]
    sy = ys - dense[..., 1]
    ok = (sx >= 0) & (sx < width) & (sy >= 0) & (sy < height)
    # flat source index of every pixel at every step; identity where the
    # source falls outside the frame
    src = torch.where(ok, sy * width + sx, ys * width + xs)
    src = src.reshape(g, t, height * width).long()
    cur = torch.arange(height * width, device=dev).expand(g, -1)
    steps = [cur]
    for s in range(1, t):
        cur = torch.gather(cur, 1, src[:, s])
        steps.append(cur)
    return torch.stack(steps, 1)


def _flat_to_accu(flat, width):
    """(..., H*W) flat source index -> (..., 2, H*W) int32 (src_x, src_y)."""
    return torch.stack([flat % width, flat // width], -2).to(torch.int32)


def backtrace_warp_batch_ref(cell_mv, iframes, height, width, cell=CELL):
    """Plain PyTorch back-trace + warped I-frame (any device).

    cell_mv (G, T, H/cell, W/cell, 2) int32, iframes (G, 3, H, W) int32 ->
    (accu (G, T, 2, H, W) int32 [ch 0 = src_x, ch 1 = src_y],
     warped (G, T, 3, H, W) int32)."""
    _check_args(cell_mv, iframes, height, width, cell)
    g, t = cell_mv.shape[:2]
    flat = _trace_ref(cell_mv, height, width, cell)
    accu = _flat_to_accu(flat, width)
    base = iframes.reshape(g, 1, 3, height * width).expand(g, t, 3, -1)
    warped = torch.gather(base, 3, flat[:, :, None].expand(g, t, 3, -1))
    return (accu.reshape(g, t, 2, height, width),
            warped.reshape(g, t, 3, height, width))


def _declare(lib):
    lib.backtrace_warp_launch.restype = ctypes.c_int
    lib.backtrace_warp_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p]
    lib.backtrace_gop_launch.restype = ctypes.c_int
    lib.backtrace_gop_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.backtrace_warp_error_string.restype = ctypes.c_char_p
    lib.backtrace_warp_error_string.argtypes = [ctypes.c_int]


def _launch(name, lib, launch, device):
    """Run `launch(stream)` on `device`'s current stream; raise
    `KernelLaunchError` when it returns a CUDA error."""
    from dmcnet_tpu_torch.ops._build import KernelLaunchError

    with torch.cuda.device(device):
        rc = launch(torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise KernelLaunchError(
            f"{name} launch failed: "
            f"{lib.backtrace_warp_error_string(rc).decode()} ({rc})")


def _check_launchable(name, cell_mv, *others):
    if not (cell_mv.is_cuda and cell_mv.is_contiguous()
            and all(o.is_contiguous() for o in others)
            and cell_mv.data_ptr() % 8 == 0):
        raise ValueError(f"{name} needs contiguous CUDA tensors, cell_mv "
                         "8-byte aligned (read as int2)")


def backtrace_warp_batch(cell_mv, iframes, height, width, cell=CELL):
    """Back-trace + warped I-frame for G GOPs in one kernel launch.

    Same contract as `backtrace_warp_batch_ref`.  On CUDA tensors it
    launches `ops/csrc/backtrace_warp.cu` on the current stream (building
    it at first use) and raises `KernelBuildError` / `KernelLaunchError`
    on failure; on CPU tensors it runs the plain version.  Each launch adds
    one to `backtrace_warp_batch.launches`."""
    if cell_mv.device.type == "cpu" and iframes.device.type == "cpu":
        return backtrace_warp_batch_ref(cell_mv, iframes, height, width, cell)
    from dmcnet_tpu_torch.ops._build import load

    _check_args(cell_mv, iframes, height, width, cell)
    _check_launchable("backtrace_warp_batch", cell_mv, iframes)
    g, t = cell_mv.shape[:2]
    lib = load("backtrace_warp", _declare)
    accu = torch.empty((g, t, 2, height, width), dtype=torch.int32,
                       device=cell_mv.device)
    warped = torch.empty((g, t, 3, height, width), dtype=torch.int32,
                         device=cell_mv.device)
    if accu.numel() == 0:
        return accu, warped
    _launch("backtrace_warp", lib, lambda stream: lib.backtrace_warp_launch(
        cell_mv.data_ptr(), iframes.data_ptr(), accu.data_ptr(),
        warped.data_ptr(), g, t, height, width, cell, stream), cell_mv.device)
    backtrace_warp_batch.launches += 1
    return accu, warped


backtrace_warp_batch.launches = 0


def backtrace_warp_gop_cells(cell_mv, iframe_chw, height, width, cell=CELL):
    """Single-GOP convenience wrapper over `backtrace_warp_batch`:
    (T, ncy, ncx, 2), (3, H, W) -> (accu (T, 2, H, W), warped (T, 3, H, W))."""
    accu, warped = backtrace_warp_batch(cell_mv[None], iframe_chw[None],
                                        height, width, cell)
    return accu[0], warped[0]


def backtrace_gop_cells_ref(cell_mv, height, width, cell=CELL):
    """Plain PyTorch back-trace of one GOP (any device): cell_mv (T, H/cell,
    W/cell, 2) int32 -> accu (T, 2, H, W) int32, ch 0 = src_x, 1 = src_y.
    `backtrace_warp_batch_ref` without the warp."""
    _check_cells(cell_mv, "T", height, width, cell)
    flat = _trace_ref(cell_mv[None], height, width, cell)[0]
    return _flat_to_accu(flat, width).reshape(-1, 2, height, width)


def backtrace_gop_cells(cell_mv, height, width, cell=CELL):
    """Back-trace of one GOP in one kernel launch (B2).

    Same contract as `backtrace_gop_cells_ref`.  On a CUDA tensor it
    launches `backtrace_gop_launch` of `ops/csrc/backtrace_warp.cu` on the
    current stream and raises `KernelBuildError` / `KernelLaunchError` on
    failure; on a CPU tensor it runs the plain version.  Each launch adds
    one to `backtrace_gop_cells.launches`."""
    if cell_mv.device.type == "cpu":
        return backtrace_gop_cells_ref(cell_mv, height, width, cell)
    from dmcnet_tpu_torch.ops._build import load

    _check_cells(cell_mv, "T", height, width, cell)
    _check_launchable("backtrace_gop_cells", cell_mv)
    t = cell_mv.shape[0]
    lib = load("backtrace_warp", _declare)
    accu = torch.empty((t, 2, height, width), dtype=torch.int32,
                       device=cell_mv.device)
    if accu.numel() == 0:
        return accu
    _launch("backtrace_gop", lib, lambda stream: lib.backtrace_gop_launch(
        cell_mv.data_ptr(), accu.data_ptr(), t, height, width, cell, stream),
        cell_mv.device)
    backtrace_gop_cells.launches += 1
    return accu


backtrace_gop_cells.launches = 0


def accu_to_hwc(accu):
    """(T, 2, H, W) -> (T, H, W, 2), the `codec.accumulate` layout."""
    return accu.permute(0, 2, 3, 1)


def backtrace_gop_cuda(mv_maps, device=None):
    """Dense-map drop-in for `codec.accumulate.backtrace_gop`, through B2.

    `mv_maps` (T, H, W, 2) host array -> accu_src (T, H, W, 2) int32 on
    `device` (CUDA unless the caller passes "cpu").  Routing is the JAX
    package's (`backtrace_gop_pallas`): motion uniform on 16x16 cells runs
    B2 at cell 16, other cell-uniform motion at cell 8, and a frame size
    that 8 does not divide, or motion that is not cell-uniform, runs the
    dense scan `codec.accumulate.backtrace_gop` on the same device.  The
    dense route is the reference semantics for such input, not a fallback:
    an error from the kernel propagates.  Each call adds one to
    `backtrace_gop_cuda.routes[route]` ("cell16", "cell8" or "dense")."""
    dev = resolve_device(device)
    mv_maps = np.asarray(mv_maps)
    _, h, w, _ = mv_maps.shape
    cells, cell = None, 0
    if not (h % CELL or w % CELL):
        cell_mv, ok = cell_mv_from_dense(mv_maps)
        if ok:
            coarse, ok16 = coarsen_cell_mv(cell_mv, h, w)
            cells, cell = (coarse, 2 * CELL) if ok16 else (cell_mv, CELL)
    if cells is None:
        out = backtrace_gop(torch.from_numpy(
            np.ascontiguousarray(mv_maps, np.int32)).to(dev))
        backtrace_gop_cuda.routes["dense"] += 1
        return out
    accu = backtrace_gop_cells(torch.from_numpy(
        np.ascontiguousarray(cells, np.int32)).to(dev), h, w, cell)
    backtrace_gop_cuda.routes[f"cell{cell}"] += 1
    return accu_to_hwc(accu)


backtrace_gop_cuda.routes = {"cell16": 0, "cell8": 0, "dense": 0}


def gop_mv_residual_cuda(mv_maps, frames_bgr, device=None):
    """Drop-in for `codec.accumulate.gop_mv_residual` in accumulate mode:
    back-trace by `backtrace_gop_cuda`, then the residual gather in plain
    PyTorch (accumulated sources are per-pixel arbitrary).

    mv_maps (T, H, W, 2), frames_bgr (T, H, W, 3) uint8 host arrays ->
    (mv (T, H, W, 2) int32, res (T, H, W, 3) int32) on `device`, frame 0
    zeroed."""
    dev = resolve_device(device)
    accu_src = backtrace_gop_cuda(mv_maps, dev)
    frames = torch.from_numpy(np.ascontiguousarray(frames_bgr)).to(dev)
    mv = accumulated_mv_from_src(accu_src)
    res = accumulated_residual_from_src(frames, accu_src)
    mv[0] = 0
    res[0] = 0
    return mv, res
