"""Dataset factory for the I3D variant (counterpart of
`dmcnet_tpu/data/iterator_factory.py`): reference
code/dmcnet_I3D/data/iterator_factory.py (get_hmdb51 :16-95, get_ucf101
:97-179, creat :184-202) without the hard-coded cluster paths: list files
live under `<data_root>/raw/list_cvt/<name>_split<k>_{train,test}.txt`,
video and flow locations are explicit arguments.
"""

from __future__ import annotations

import os

from dmcnet_tpu_torch.data.lists import VideoItem, load_i3d_list
from dmcnet_tpu_torch.data.sampling import RandomSampling, SequentialSampling
from dmcnet_tpu_torch.data.video_iter import DECODE_ERRORS, VideoClipDataset

_NUM_CLASSES = {"ucf101": 101, "hmdb51": 51}


def dataset_num_classes(name):
    """reference dataset/config.py:9-23."""
    key = name.lower()
    if key not in _NUM_CLASSES:
        raise ValueError(f"unknown dataset {name!r}")
    return _NUM_CLASSES[key]


def list_path(data_root, name, split, subset):
    return os.path.join(data_root, "raw", "list_cvt",
                        f"{name.lower()}_split{split}_{subset}.txt")


def _items_from_list(path, video_prefix, flow_prefix, num_frames_fn):
    """VideoItems of an I3D list; a video whose frame count cannot be read
    (a decode error) is left out, as the reference's retry logic tolerates
    missing videos."""
    items = []
    for _vid, label, subpath in load_i3d_list(path):
        stem = os.path.splitext(subpath)[0]
        video_path = os.path.join(video_prefix, stem + ".mp4")
        flow_path = (os.path.join(flow_prefix, stem)
                     if flow_prefix else None)
        try:
            n = num_frames_fn(video_path)
        except DECODE_ERRORS:
            continue
        items.append(VideoItem(video_path, label, n, flow_path))
    return items


def creat(name, data_root, video_prefix, flow_prefix=None, split=1,
          clip_length=16, train_interval=2, val_interval=2,
          modality="flow+mp4", accumulate=True, mv_minmaxnorm=False, seed=0,
          num_frames_fn=None):
    """Build (train_ds, val_ds) VideoClipDatasets (reference creat
    :184-202; the flow blockify factor is `i3d_augment_batch`'s)."""
    if num_frames_fn is None:
        from dmcnet_tpu_torch.codec.coviar_compat import get_num_frames
        num_frames_fn = get_num_frames
    train_items = _items_from_list(list_path(data_root, name, split, "train"),
                                   video_prefix, flow_prefix, num_frames_fn)
    val_items = _items_from_list(list_path(data_root, name, split, "test"),
                                 video_prefix, flow_prefix, num_frames_fn)
    train = VideoClipDataset(
        train_items,
        RandomSampling(num=clip_length, interval=train_interval,
                       speed=[1.0, 1.0], seed=seed),
        modality=modality, accumulate=accumulate,
        mv_minmaxnorm=mv_minmaxnorm, seed=seed + 2)
    val = VideoClipDataset(
        val_items,
        SequentialSampling(num=clip_length, interval=val_interval,
                           fix_cursor=True, shuffle=True, seed=seed),
        modality=modality, accumulate=accumulate,
        mv_minmaxnorm=mv_minmaxnorm, seed=seed + 3)
    return train, val
