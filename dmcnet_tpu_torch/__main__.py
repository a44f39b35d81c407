"""Command dispatcher: ``python -m dmcnet_tpu_torch <command> ...``
(counterpart of `dmcnet_tpu/__main__.py`, with the same command names):

    python -m dmcnet_tpu_torch train --data-name hmdb51 ...
    python -m dmcnet_tpu_torch serve --weights ckpt video.mp4
"""

import importlib
import sys

COMMANDS = {
    "train": "dmcnet_tpu_torch.cli.train",
    "test": "dmcnet_tpu_torch.cli.test",
    "combine": "dmcnet_tpu_torch.cli.combine",
    "train-gan": "dmcnet_tpu_torch.cli.train_gan",
    "train-i3d": "dmcnet_tpu_torch.cli.train_i3d",
    "train-hmdb51": "dmcnet_tpu_torch.cli.train_hmdb51",
    "train-ucf101": "dmcnet_tpu_torch.cli.train_ucf101",
    "evaluate-i3d": "dmcnet_tpu_torch.cli.evaluate_video_i3d",
    "serve": "dmcnet_tpu_torch.cli.serve",
}


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] in ("-h", "--help"):
        print("usage: python -m dmcnet_tpu_torch <command> [args]\n\n"
              "commands:")
        for name in COMMANDS:
            print(f"  {name}")
        return 0
    cmd, rest = argv[0], argv[1:]
    if cmd not in COMMANDS:
        print(f"unknown command {cmd!r}; choose from "
              f"{', '.join(COMMANDS)}", file=sys.stderr)
        return 2
    # The commands return what they computed (an accuracy, scores) for
    # callers in Python, not an exit code: returning is success.
    result = importlib.import_module(COMMANDS[cmd]).main(rest)
    return result if isinstance(result, int) else 0


if __name__ == "__main__":
    sys.exit(main())
