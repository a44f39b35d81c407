"""Synthetic GOP generation for tests and `chip_smoke.py` (the port's copy of
`dmcnet_tpu/codec/synthetic.py`).

Produces random-but-plausible MPEG-4-style GOPs: macroblock-aligned motion
vector block lists plus frames, so codec kernels can be validated bit-for-bit
against the NumPy golden model without any real video file, and benchmarked
at arbitrary sizes.
"""

from __future__ import annotations

import numpy as np

from dmcnet_tpu_torch.codec.semantics import MVBlock, rasterize_blocks


def synthetic_gop(rng, num_frames=12, height=64, width=96, block_size=16,
                  max_motion=12, moving_fraction=0.7):
    """Generate one synthetic GOP.

    Returns:
      block_lists: list of per-frame MVBlock lists (index 0 empty — I-frame).
      frames_bgr:  (T, H, W, 3) uint8 frames with spatial structure (so
                   residual tests exercise real pixel differences).
    """
    if height % block_size or width % block_size:
        raise ValueError(f"block_size {block_size} does not divide "
                         f"{height}x{width}")
    block_lists = [[]]
    for _ in range(1, num_frames):
        blocks = []
        for by in range(height // block_size):
            for bx in range(width // block_size):
                dst_x = bx * block_size + block_size // 2
                dst_y = by * block_size + block_size // 2
                if rng.random() < moving_fraction:
                    val_x = int(rng.integers(-max_motion, max_motion + 1))
                    val_y = int(rng.integers(-max_motion, max_motion + 1))
                else:
                    val_x = val_y = 0
                blocks.append(MVBlock(
                    src_x=dst_x - val_x, src_y=dst_y - val_y,
                    dst_x=dst_x, dst_y=dst_y, w=block_size, h=block_size))
        block_lists.append(blocks)

    # Smooth-ish frames: low-frequency random field + noise, drifting in time.
    base = rng.integers(0, 256, size=(height // 8, width // 8, 3))
    base = np.kron(base, np.ones((8, 8, 1)))
    frames = []
    for t in range(num_frames):
        noise = rng.integers(-20, 21, size=(height, width, 3))
        frame = np.clip(base + 5 * t + noise, 0, 255).astype(np.uint8)
        frames.append(frame)
    return block_lists, np.stack(frames)


def dense_mv_maps(block_lists, height, width, dtype=np.int32):
    """Rasterize per-frame block lists to a (T, H, W, 2) dense map stack."""
    return np.stack([
        rasterize_blocks(blocks, height, width).astype(dtype)
        for blocks in block_lists
    ])


def block_arrays(block_lists):
    """Per-frame MVBlock lists -> the native decoder's block-list arrays:
    (blocks (T, max_blocks, 6) int32 [src_x, src_y, dst_x, dst_y, w, h],
    n_blocks (T,) int32), zero-motion blocks dropped as the decoder drops
    them — the input of `ops.backtrace.cell_mv_from_blocks`."""
    kept = [[b for b in bl if b.val != (0, 0)] for bl in block_lists]
    blocks = np.zeros((len(kept), max(1, max(map(len, kept))), 6), np.int32)
    for t, bl in enumerate(kept):
        for i, b in enumerate(bl):
            blocks[t, i] = (b.src_x, b.src_y, b.dst_x, b.dst_y, b.w, b.h)
    return blocks, np.array([len(bl) for bl in kept], np.int32)
