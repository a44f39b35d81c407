#!/usr/bin/env python3
"""Run chosen phases of `chip_smoke.py` on the card, for a quicker turn
than the whole smoke:

    python3 tools/smoke_phases.py pipeline utils

Each name is a `<name>_phase(torch, bt, dev, gops, smi, workdir)` of
`chip_smoke.py` (pipeline, utils, train, gan, dist, parallel, i3d,
i3d_train, packed, epilogue).  The phases get the smoke's three synthetic
256x320 GOPs (16x16, 8x8 and 4x4 blocks, seed 0) and a temporary work
directory, TF32 off, as in the smoke; the card's name and power limit come
first.  The back-trace kernels' build and checks are the smoke's alone (the
epilogue phase builds and checks its own kernel): run it whole before
trusting a change."""

import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402
from dmcnet_tpu_torch.codec.synthetic import (  # noqa: E402
    dense_mv_maps,
    synthetic_gop,
)
from dmcnet_tpu_torch.ops import backtrace as bt  # noqa: E402


def main(names):
    if not torch.cuda.is_available():
        print("smoke_phases: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60
                         ).stdout.strip().splitlines()[0]
    print(smi)
    rng = np.random.default_rng(0)
    gops = {}
    for name, block in (("16x16 blocks", 16), ("8x8 blocks", 8),
                        ("4x4 blocks", 4)):
        bl, frames = synthetic_gop(rng, num_frames=cs.T, height=cs.H,
                                   width=cs.W, block_size=block,
                                   max_motion=16)
        gops[name] = (bl, dense_mv_maps(bl, cs.H, cs.W), frames)
    dev = torch.device("cuda")
    for name in names:
        print(cs.in_workdir(getattr(cs, name + "_phase"), torch, bt, dev,
                            gops, smi))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
