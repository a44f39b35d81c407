"""Data pipeline of the port: list parsing, TSN sampling, the CoViAR dataset
and its batches, crop/flip/normalize on a device (counterpart of
`dmcnet_tpu/data`; the I3D data path is not ported yet)."""

from dmcnet_tpu_torch.data.lists import VideoItem, load_video_list
from dmcnet_tpu_torch.data.sampling import (
    get_seg_range,
    get_gop_pos,
    train_frame_index,
    test_frame_index,
)
from dmcnet_tpu_torch.data import transforms
