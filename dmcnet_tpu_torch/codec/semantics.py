"""Pure-NumPy golden model of CoViAR compressed-video semantics.

The port's own copy of `dmcnet_tpu/codec/semantics.py` (the port imports
nothing of the JAX package).  It mirrors, loop for loop, what the reference C
extension computes per decoded frame (reference
`code/dmcnet/data_loader/coviar_data_loader.c:71-177`), so the back-trace
kernel and the native decoder can be tested for bit-parity against it on
synthetic GOPs.  It is deliberately simple and slow — it is NEVER on the
production path.

Terminology
-----------
A GOP (group of pictures) is one I-frame followed by P-frames.  Every P-frame
carries exported motion vectors: blocks saying "pixels around (dst_x, dst_y)
came from pixels around (src_x, src_y) of the previous frame".

* "accumulated MV" back-traces each pixel of frame t to its source pixel in
  the I-frame: maintain `accu_src[x, y] = (sx, sy)`; per frame, for every
  motion block, `accu_src[dst] = accu_src_old[src]` over the block's pixels
  (reference c:111-115); the accumulated MV at the target frame is
  `(x, y) - accu_src[x, y]` (c:128-139).
* "accumulated residual" is `frame_t_bgr - iframe_bgr[accu_src]`
  (c:141-175) — the difference w.r.t. the motion-compensated I-frame pixel.
* non-accumulated mode returns the raw per-frame MV map (`dst - src`,
  c:116-119) and the residual w.r.t. the immediately previous frame
  (c:160-163).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class MVBlock:
    """One exported motion vector, matching FFmpeg's AVMotionVector fields.

    (src_x, src_y) and (dst_x, dst_y) are block *centres*; (w, h) the block
    size.  The reference iterates offsets in [-w//2, w//2) x [-h//2, h//2)
    around the centres (c:97-103).
    """

    src_x: int
    src_y: int
    dst_x: int
    dst_y: int
    w: int = 16
    h: int = 16

    @property
    def val(self) -> tuple[int, int]:
        return (self.dst_x - self.src_x, self.dst_y - self.src_y)


def rasterize_blocks(blocks, height, width):
    """Rasterize a frame's MV block list into a dense (H, W, 2) int32 map.

    A pixel's entry is (val_x, val_y) = dst - src of the last block covering
    it, written only where BOTH the dst pixel and its src pixel are in bounds
    (reference boundary clipping, c:105-108); zero-motion blocks are skipped
    (c:92), leaving zeros.  Iteration order matches the reference (block
    order, then x offset outer / y offset inner), so overlapping blocks
    resolve identically.
    """
    mv_map = np.zeros((height, width, 2), dtype=np.int32)
    for b in blocks:
        val_x, val_y = b.val
        if val_x == 0 and val_y == 0:
            continue
        for x_start in range(-b.w // 2, b.w // 2):
            for y_start in range(-b.h // 2, b.h // 2):
                p_dst_x = b.dst_x + x_start
                p_dst_y = b.dst_y + y_start
                p_src_x = b.src_x + x_start
                p_src_y = b.src_y + y_start
                if (0 <= p_dst_y < height and 0 <= p_dst_x < width
                        and 0 <= p_src_y < height and 0 <= p_src_x < width):
                    mv_map[p_dst_y, p_dst_x, 0] = val_x
                    mv_map[p_dst_y, p_dst_x, 1] = val_y
    return mv_map


def _identity_src(height, width):
    """accu_src identity init: pixel (x, y) sources from itself (c:316-328)."""
    xs, ys = np.meshgrid(np.arange(width), np.arange(height))
    return np.stack([xs, ys], axis=-1).astype(np.int32)  # (H, W, 2) = (sx, sy)


def accumulate_gop_numpy(block_lists, height, width, pos_target):
    """Back-trace accu_src through frames 1..pos_target of a GOP.

    `block_lists[t]` is the MV block list of frame t (frame 0 is the I-frame
    and must have an empty list).  Returns the (H, W, 2) accu_src map after
    processing frame `pos_target`, with channels (src_x, src_y).
    """
    accu_src_old = _identity_src(height, width)
    accu_src = accu_src_old.copy()
    for t in range(1, pos_target + 1):
        for b in block_lists[t]:
            val_x, val_y = b.val
            if val_x == 0 and val_y == 0:
                continue
            for x_start in range(-b.w // 2, b.w // 2):
                for y_start in range(-b.h // 2, b.h // 2):
                    p_dst_x = b.dst_x + x_start
                    p_dst_y = b.dst_y + y_start
                    p_src_x = b.src_x + x_start
                    p_src_y = b.src_y + y_start
                    if (0 <= p_dst_y < height and 0 <= p_dst_x < width
                            and 0 <= p_src_y < height and 0 <= p_src_x < width):
                        accu_src[p_dst_y, p_dst_x] = accu_src_old[p_src_y, p_src_x]
        accu_src_old = accu_src.copy()
    return accu_src
