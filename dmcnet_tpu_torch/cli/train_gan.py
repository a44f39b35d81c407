"""dmcnet_GAN training command: `cli/train.py` with the GAN options, the
counterpart of `dmcnet_tpu/cli/train_gan.py` (reference
code/dmcnet_GAN/train.py)."""

import sys

from dmcnet_tpu_torch.cli.train import main as _train_main


def main(argv=None, **kwargs):
    kwargs.setdefault("gan", True)
    return _train_main(argv, **kwargs)


if __name__ == "__main__":
    main(sys.argv[1:])
