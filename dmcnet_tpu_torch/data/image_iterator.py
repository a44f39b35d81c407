"""Labelled-image dataset (the port's copy of
`dmcnet_tpu/data/image_iterator.py`).

Equivalent of the reference's `ImageListIter`, which its main path does not
use (code/dmcnet_I3D/data/image_iterator.py:15-78): a list file of
`<id> <label> <relpath>` image entries, loaded as RGB numpy arrays with an
optional transform callable.
"""

from __future__ import annotations

import os

import numpy as np


class ImageListDataset:
    def __init__(self, image_prefix, txt_list, transform=None,
                 force_color=True):
        self.image_prefix = image_prefix
        self.transform = transform
        self.force_color = force_color
        self.items = []
        with open(txt_list) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                vid, label, subpath = line.split()
                self.items.append((int(vid), int(label), subpath))

    def __len__(self):
        return len(self.items)

    def __getitem__(self, index):
        from PIL import Image

        _vid, label, subpath = self.items[index]
        path = os.path.join(self.image_prefix, subpath)
        img = Image.open(path)
        img = img.convert("RGB") if self.force_color else img
        arr = np.asarray(img)
        if self.transform is not None:
            arr = self.transform(arr)
        return arr, label
