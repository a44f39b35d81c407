"""Normalisation constants of the loader (counterpart of
`dmcnet_tpu/data/transforms.py:37-38`)."""

from __future__ import annotations

import numpy as np

IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)
MEAN_STD = float(IMAGENET_STD.mean())  # 0.226 (reference dataset.py:260-262)
