"""Helpers shared by the `train`, `test`, `serve` and `evaluate_video_i3d`
commands: the class count of a dataset, the torch device of `--device` /
`--gpus`, the refusal of flags whose slice is not ported yet, and the
reference score dump."""

import numpy as np
import torch

from dmcnet_tpu_torch import resolve_device


def num_classes_for(data_name):
    table = {"ucf101": 101, "hmdb51": 51, "kinetics400": 400}
    if data_name not in table:
        raise ValueError("Unknown dataset " + str(data_name))
    return table[data_name]


def device_for(args):
    """`--device`, with `--gpus N` selecting cuda:N; a CUDA device raises
    when CUDA is unavailable."""
    if args.device.startswith("cuda"):
        resolve_device()
        if getattr(args, "gpus", None):
            return torch.device(f"cuda:{args.gpus[0]}")
    return torch.device(args.device)


def refuse_unported(refusals):
    """SystemExit for the first (condition, flag, ROADMAP item) whose
    condition holds: a flag of a slice not ported yet is never ignored."""
    for bad, flag, item in refusals:
        if bad:
            raise SystemExit(f"{flag} is not ported yet (ROADMAP {item})")


def save_scores_npz(path, outputs, labels, name_list):
    """Bit-compatible with reference test.py:183-198: reorder everything by
    sorted(video name) and savez object arrays."""
    order_dict = {e: i for i, e in enumerate(sorted(name_list))}
    n = len(outputs)
    reorder_output = [None] * n
    reorder_label = [None] * n
    reorder_name = [None] * n
    for i in range(n):
        idx = order_dict[name_list[i]]
        reorder_output[idx] = outputs[i]
        reorder_label[idx] = labels[i]
        reorder_name[idx] = name_list[i]
    scores = np.empty(n, dtype=object)
    scores[:] = reorder_output
    np.savez(path, scores=scores, labels=reorder_label, names=reorder_name)
