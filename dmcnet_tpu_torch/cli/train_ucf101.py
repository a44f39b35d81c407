"""UCF-101 I3D training command (the port's counterpart of
`dmcnet_tpu/cli/train_ucf101.py`, reference code/dmcnet_I3D/train_ucf101.py):
`cli.train_i3d` with `--dataset` defaulting to UCF101."""

import sys

from dmcnet_tpu_torch.cli.train_i3d import main as _i3d_main


def main(argv=None, **kwargs):
    kwargs.setdefault("dataset_default", "UCF101")
    return _i3d_main(argv, **kwargs)


if __name__ == "__main__":
    main(sys.argv[1:])
