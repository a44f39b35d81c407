"""Temporal sampling (the port's copy of `dmcnet_tpu/data/sampling.py`):
TSN segments for dmcnet and clip samplers for I3D, with the reference's
semantics exactly:

  * get_seg_range / get_gop_pos: code/dmcnet/dataset.py:46-73 (GOP position
    0 for MV/residual maps to the PREVIOUS GOP's last frame);
  * get_gop_pos_i3d: code/dmcnet_I3D/data/video_iterator.py:80-89 (position
    0 maps to position 1 of the SAME GOP instead);
  * train/test frame index: dataset.py:130-149;
  * RandomSampling / SequentialSampling: data/video_sampler.py:11-67, on
    numpy `default_rng(seed)` as in the JAX package, so one seed draws the
    same frames in both.
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


def get_gop_pos_i3d(frame_idx, representation, gop_size=12):
    """I3D flavour (video_iterator.py:80-89): position 0 -> position 1."""
    gop_index, gop_pos = divmod(frame_idx, gop_size)
    if representation in ("residual", "mv", "flow"):
        if gop_pos == 0:
            gop_pos = 1
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


class RandomSampling:
    """Random clip sampler (reference data/video_sampler.py:11-34)."""

    def __init__(self, num, interval=1, speed=(1.0, 1.0), seed=0):
        assert num > 0
        self.num = num
        self.interval = interval if isinstance(interval, list) else [interval]
        self.speed = speed
        self.rng = np.random.default_rng(seed)

    def sampling(self, range_max):
        assert range_max > 0
        interval = self.rng.choice(self.interval)
        if self.num == 1:
            return [int(self.rng.integers(0, range_max))]
        clip_extent = (self.num - 1) * interval + 1
        speed_min = self.speed[0]
        speed_max = min(self.speed[1],
                        (range_max - 1) / float(clip_extent - 1))
        if speed_max < speed_min:
            # Clip longer than the video: uniformly stretch.
            idxs = np.linspace(0, max(range_max - 1, 0), self.num)
            return np.round(idxs).astype(int).tolist()
        random_speed = self.rng.uniform(speed_min, speed_max)
        span = (clip_extent - 1) * random_speed
        start = self.rng.uniform(0, (range_max - 1) - span)
        idxs = start + np.arange(self.num) * interval * random_speed
        return np.round(idxs).astype(int).tolist()


class SequentialSampling:
    """Non-overlapping sequential clips with per-video cursor memory
    (reference data/video_sampler.py:37-67)."""

    def __init__(self, num, interval=1, shuffle=False, fix_cursor=False,
                 seed=0):
        self.num = num
        self.interval = interval if isinstance(interval, list) else [interval]
        self.shuffle = shuffle
        self.fix_cursor = fix_cursor
        self.rng = np.random.default_rng(seed)
        self.memory = {}

    def sampling(self, range_max, v_id=0):
        assert range_max > 0
        num = self.num
        interval = self.rng.choice(self.interval)
        frame_range = (num - 1) * interval + 1
        clips = list(range(0, max(range_max - (frame_range - 1), 1),
                           frame_range))
        if self.shuffle:
            self.rng.shuffle(clips)
        if v_id not in self.memory:
            self.memory[v_id] = [0, clips]
        cursor, clips = self.memory[v_id]
        if not clips:
            idxs = np.linspace(0, max(range_max - 1, 0), num)
            return np.round(idxs).astype(int).tolist()
        cursor = cursor % len(clips)
        start = clips[cursor]
        if not self.fix_cursor:
            self.memory[v_id][0] = cursor + 1
        idxs = [min(start + i * interval, range_max - 1) for i in range(num)]
        return idxs
