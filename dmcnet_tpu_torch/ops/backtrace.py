"""GOP motion back-trace: the port's counterpart of
`dmcnet_tpu/ops/pallas_backtrace.py`.

  * `cell_mv_from_blocks` / `cell_mv_from_blocks_np` turn MV block lists
    into per-cell motion grids, with the JAX package's acceptance rule
    (`max_mv(cell)` = 64 - cell, cell-aligned blocks), so that streams route
    to the device or the host path exactly as they do there.
  * `backtrace_warp_batch` is the wrapper of the hand-written CUDA kernel
    `ops/csrc/backtrace_warp.cu` (replacing the TPU kernel
    `pallas_backtrace.backtrace_warp_batch`).  For a CUDA tensor it launches
    the kernel or raises; for a CPU tensor it runs the plain version.
  * `backtrace_warp_batch_ref` is that plain PyTorch version: the same
    computation as the JAX package's exact twin `backtrace_warp_batch_xla`
    (densify the cells, zero the motion whose source is out of bounds, then
    a sequential gather over t).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

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


def _check_args(cell_mv, iframes, height, width, cell):
    if cell not in (8, 16):
        raise ValueError(f"cell must be 8 or 16, got {cell}")
    if height % cell or width % cell:
        raise ValueError(f"cell {cell} does not divide {height}x{width}")
    if cell_mv.dim() != 5 or cell_mv.shape[2:] != (height // cell,
                                                   width // cell, 2):
        raise ValueError(f"cell_mv shape {tuple(cell_mv.shape)} is not "
                         f"(G, T, {height // cell}, {width // cell}, 2)")
    g = cell_mv.shape[0]
    if iframes.shape != (g, 3, height, width):
        raise ValueError(f"iframes shape {tuple(iframes.shape)} is not "
                         f"({g}, 3, {height}, {width})")
    if cell_mv.dtype != torch.int32 or iframes.dtype != torch.int32:
        raise TypeError(f"cell_mv and iframes must be int32, got "
                        f"{cell_mv.dtype} and {iframes.dtype}")
    if cell_mv.device != iframes.device:
        raise ValueError(f"cell_mv on {cell_mv.device}, iframes on "
                         f"{iframes.device}")


def backtrace_warp_batch_ref(cell_mv, iframes, height, width, cell=CELL):
    """Plain PyTorch back-trace + warped I-frame (any device).

    cell_mv (G, T, H/cell, W/cell, 2) int32, iframes (G, 3, H, W) int32 ->
    (accu (G, T, 2, H, W) int32 [ch 0 = src_x, ch 1 = src_y],
     warped (G, T, 3, H, W) int32)."""
    _check_args(cell_mv, iframes, height, width, cell)
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
    flat = torch.stack(steps, 1)  # (G, T, H*W) source index in the I-frame
    accu = torch.stack([flat % width, flat // width], 2).to(torch.int32)
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
    lib.backtrace_warp_error_string.restype = ctypes.c_char_p
    lib.backtrace_warp_error_string.argtypes = [ctypes.c_int]


def backtrace_warp_batch(cell_mv, iframes, height, width, cell=CELL):
    """Back-trace + warped I-frame for G GOPs in one kernel launch.

    Same contract as `backtrace_warp_batch_ref`.  On CUDA tensors it
    launches `ops/csrc/backtrace_warp.cu` on the current stream (building
    it at first use) and raises `KernelBuildError` / `KernelLaunchError`
    on failure; on CPU tensors it runs the plain version.  Each launch adds
    one to `backtrace_warp_batch.launches`."""
    if cell_mv.device.type == "cpu" and iframes.device.type == "cpu":
        return backtrace_warp_batch_ref(cell_mv, iframes, height, width, cell)
    from dmcnet_tpu_torch.ops._build import KernelLaunchError, load

    _check_args(cell_mv, iframes, height, width, cell)
    if not (cell_mv.is_cuda and cell_mv.is_contiguous()
            and iframes.is_contiguous() and cell_mv.data_ptr() % 8 == 0):
        raise ValueError("backtrace_warp_batch needs contiguous CUDA "
                         "tensors, cell_mv 8-byte aligned (read as int2)")
    g, t = cell_mv.shape[:2]
    if g * t > 65535:
        raise ValueError(f"G*T = {g * t} exceeds the kernel's grid limit "
                         "(65535); split the batch")
    lib = load("backtrace_warp", _declare)
    accu = torch.empty((g, t, 2, height, width), dtype=torch.int32,
                       device=cell_mv.device)
    warped = torch.empty((g, t, 3, height, width), dtype=torch.int32,
                         device=cell_mv.device)
    if accu.numel() == 0:
        return accu, warped
    with torch.cuda.device(cell_mv.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.backtrace_warp_launch(
            cell_mv.data_ptr(), iframes.data_ptr(), accu.data_ptr(),
            warped.data_ptr(), g, t, height, width, cell, stream)
    if rc != 0:
        raise KernelLaunchError(
            "backtrace_warp launch failed: "
            f"{lib.backtrace_warp_error_string(rc).decode()} ({rc})")
    backtrace_warp_batch.launches += 1
    return accu, warped


backtrace_warp_batch.launches = 0
