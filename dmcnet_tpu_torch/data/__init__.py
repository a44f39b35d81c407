"""Data pipeline of the port (counterpart of `dmcnet_tpu/data`): list
parsing, TSN sampling, the CoViAR dataset and its batches, crop/flip/
normalize on a device, the I3D clip dataset and its batches
(`video_iter`, `iterator_factory`), the image-list dataset and the
prefetching loader."""

from dmcnet_tpu_torch.data.lists import VideoItem, load_video_list
from dmcnet_tpu_torch.data.sampling import (
    get_seg_range,
    get_gop_pos,
    train_frame_index,
    test_frame_index,
)
from dmcnet_tpu_torch.data import transforms
