"""Video list parsing (the port's copy of `dmcnet_tpu/data/lists.py`).

dmcnet list format (reference code/dmcnet/dataset.py:116-128): lines of
`<video> <dummy> <label>`, video paths made absolute against data_root with
extension swapped to .mp4, and the usable frame count min'ed with the number
of precomputed flow images.  (The I3D list format waits for the I3D data
path.)
"""

from __future__ import annotations

import os
from dataclasses import dataclass


@dataclass(frozen=True)
class VideoItem:
    path: str
    label: int
    num_frames: int
    flow_path: str | None = None


def video_path_to_flow_path(flow_root, video_path):
    """<flow_root>/<class_dir>/<video_stem> (reference dataset.py:34-37)."""
    parts = video_path.split("/")
    return os.path.join(flow_root, parts[-2], parts[-1][:-4])


def load_video_list(list_path, data_root, flow_root=None,
                    num_frames_fn=None, check_flow_dir=True):
    """Parse a dmcnet-format list into VideoItems.

    `num_frames_fn(path)` supplies frame counts (the coviar-compat
    get_num_frames by default); when a flow_root is given the count is
    clamped by available flow images like the reference (dataset.py:126).
    """
    if num_frames_fn is None:
        from dmcnet_tpu_torch.codec.coviar_compat import get_num_frames
        num_frames_fn = get_num_frames
    items = []
    with open(list_path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            video, _, label = line.split()
            video_path = os.path.join(data_root, video[:-4] + ".mp4")
            flow_path = None
            n = num_frames_fn(video_path)
            if flow_root is not None:
                flow_path = video_path_to_flow_path(flow_root, video_path)
                if check_flow_dir and os.path.isdir(flow_path):
                    n = min(n, len(os.listdir(flow_path)) // 3)
            items.append(VideoItem(video_path, int(label), int(n), flow_path))
    return items
