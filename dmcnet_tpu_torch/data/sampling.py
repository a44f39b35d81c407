"""TSN temporal sampling (the port's copy of the dmcnet part of
`dmcnet_tpu/data/sampling.py`), with the reference's semantics exactly:

  * get_seg_range / get_gop_pos: code/dmcnet/dataset.py:46-73 (GOP position
    0 for MV/residual maps to the PREVIOUS GOP's last frame);
  * train/test frame index: dataset.py:130-149.

The I3D clip samplers wait for the I3D data path.
"""

from __future__ import annotations

import numpy as np


def get_seg_range(n, num_segments, seg, representation):
    """Frame range of TSN segment `seg` (reference dataset.py:46-60)."""
    if representation in ("residual", "mv", "flow"):
        n -= 1
    seg_size = float(n - 1) / num_segments
    seg_begin = int(np.round(seg_size * seg))
    seg_end = int(np.round(seg_size * (seg + 1)))
    if seg_end == seg_begin:
        seg_end = seg_begin + 1
    if representation in ("residual", "mv", "flow"):
        # Exclude frame 0: it is an I-frame with no motion.
        return seg_begin + 1, seg_end + 1
    return seg_begin, seg_end


def get_gop_pos(frame_idx, representation, gop_size=12):
    """frame index -> (gop_index, gop_pos), dmcnet flavour (dataset.py:63-73).

    MV/residual at an I-frame position use the previous GOP's last frame;
    iframe representation always takes position 0.
    """
    gop_index, gop_pos = divmod(frame_idx, gop_size)
    if representation in ("residual", "mv", "flow"):
        if gop_pos == 0:
            gop_index -= 1
            gop_pos = gop_size - 1
    else:
        gop_pos = 0
    return gop_index, gop_pos


def train_frame_index(num_frames, num_segments, seg, representation, rng,
                      gop_size=12):
    """Random frame in the segment (dataset.py:130-137)."""
    seg_begin, seg_end = get_seg_range(num_frames, num_segments, seg,
                                       representation)
    v_frame_idx = int(rng.integers(seg_begin, seg_end))
    return get_gop_pos(v_frame_idx, representation, gop_size)


def test_frame_index(num_frames, num_segments, seg, representation,
                     gop_size=12):
    """Segment-centre frame (dataset.py:139-149)."""
    if representation in ("mv", "residual", "flow"):
        num_frames -= 1
    seg_size = float(num_frames - 1) / num_segments
    v_frame_idx = int(np.round(seg_size * (seg + 0.5)))
    if representation in ("mv", "residual", "flow"):
        v_frame_idx += 1
    return get_gop_pos(v_frame_idx, representation, gop_size)
