"""Whole-video I3D evaluation — the port's counterpart of
`dmcnet_tpu/cli/evaluate_video_i3d.py`, with its flags plus `--device`
(default `cuda`).

Reference: code/dmcnet_I3D/test/evaluate_video_{hmdb,ucf101}_i3d.py:98-253:
RandomSampling clips, `--num-sample` rounds per video with per-video score
averaging (float64), the npz dump {scores (N, C), labels, top1} and the
samples/sec report.  `--load-weights` reads a torch file (the port's
`state_dict` or checkpoint, or a reference I3D `.pth`, through
`models.weights.load_reference_i3d`), a JAX package msgpack checkpoint or
a step directory of the port's `--ckpt-backend orbax`; a JAX orbax
directory raises naming its format.

`--shard-time 1` shards each clip's T axis over several cards
(`parallel/temporal.py`): the largest number of visible cards (or of
`--gpus` ids) that divides `--clip-length`, as the JAX command picks its
devices (250 frames over 5 of 8), one process per card joined by
`--dist-*` flags, each rank assembling its frames of every clip and
exchanging halos with its neighbours; rank 0 prints and writes the scores.
On one card it runs the unsharded forward and says so.

    python -m dmcnet_tpu_torch.cli.evaluate_video_i3d --dataset HMDB51 \\
        --split 1 --clip-length 250 --modality flow+mp4 \\
        --arch-estimator DenseNetTiny --mv-minmaxnorm 1 --accumulate 0 \\
        --load-weights hmdb_1_ep-0010.pth --score-file hmdb_1_eval \\
        --data-root ./dataset/HMDB51 --video-prefix /data/hmdb51/mpeg4
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from dmcnet_tpu_torch.cli.common import device_for
from dmcnet_tpu_torch.data.iterator_factory import (
    _items_from_list,
    dataset_num_classes,
    list_path,
)
from dmcnet_tpu_torch.data.sampling import RandomSampling
from dmcnet_tpu_torch.data.video_iter import (
    I3DBatchAssembler,
    VideoClipDataset,
    i3d_augment_batch,
)
from dmcnet_tpu_torch.models.i3d import get_symbol
from dmcnet_tpu_torch.models.weights import load_reference_i3d
from dmcnet_tpu_torch.parallel.multihost import (
    initialize_distributed,
    shutdown,
    spawn_ranks,
    world,
)
from dmcnet_tpu_torch.train.checkpoints import read_model_state
from dmcnet_tpu_torch.train.engine_i3d import make_i3d_eval_step
from dmcnet_tpu_torch.train.jax_checkpoint import (  # noqa: F401 (old name)
    is_jax_checkpoint,
)
from dmcnet_tpu_torch.train.metrics import topk_accuracy


def build_parser():
    p = argparse.ArgumentParser(description="I3D video-level evaluation")
    p.add_argument('--dataset', default='HMDB51',
                   choices=['UCF101', 'HMDB51'])
    p.add_argument('--split', type=int, default=1)
    p.add_argument('--clip-length', type=int, default=250)
    p.add_argument('--frame-interval', type=int, default=1)
    p.add_argument('--modality', type=str, default='flow+mp4')
    p.add_argument('--arch-estimator', type=str, default='DenseNetTiny')
    p.add_argument('--arch-d', type=str, default=None)
    p.add_argument('--accumulate', type=int, default=1)
    p.add_argument('--mv-minmaxnorm', type=int, default=0)
    p.add_argument('--ds_factor', type=int, default=16)
    p.add_argument('--num-sample', type=int, default=1,
                   help='sampling rounds per video')
    p.add_argument('--batch-size', type=int, default=1)
    p.add_argument('--load-weights', type=str, required=True,
                   help='a torch file (the port\'s state_dict or checkpoint, '
                        'or a reference I3D .pth), a JAX msgpack checkpoint '
                        'or a --ckpt-backend orbax directory')
    p.add_argument('--score-file', type=str, default=None)
    p.add_argument('--data-root', type=str, required=True)
    p.add_argument('--video-prefix', type=str, required=True)
    p.add_argument('--flow-prefix', type=str, default=None)
    p.add_argument('--input-size', type=int, default=224)
    p.add_argument('--shard-time', type=int, default=0,
                   help='shard each clip\'s T axis over the largest number '
                        'of cards (or --gpus ids) that divides '
                        '--clip-length, one process per card, with halo '
                        'exchanges between neighbours '
                        '(parallel/temporal.py)')
    p.add_argument('--gpus', nargs='+', type=int, default=None,
                   help='card ids for --shard-time (default: every visible '
                        'card; with --device cpu, gloo processes on the '
                        'CPU, one per id)')
    p.add_argument('--device', type=str, default='cuda',
                   help='torch device to evaluate on (cuda, cuda:N, cpu)')
    p.add_argument('--dist-coordinator', type=str, default=None,
                   help='host:port of rank 0 of a --shard-time process '
                        'group (set by the command for its processes)')
    p.add_argument('--dist-num-processes', type=int, default=None)
    p.add_argument('--dist-process-id', type=int, default=None)
    return p


def load_weights(net, path, modality):
    """--load-weights into `net`, in any of the port's formats
    (`train.checkpoints.read_model_state`).  Every parameter and BN
    statistic of `net` must come from the file (a 3-channel stem adapted to
    a 2-channel model counts), as the JAX command's checkpoint restore
    demands; a file that leaves any of them at its initialisation raises."""
    report, unfilled = load_reference_i3d(read_model_state(path), net,
                                          modality)
    print(f"loaded --load-weights {path}: {report}")
    if unfilled:
        shown = ", ".join(unfilled[:8]) + (", ..." if len(unfilled) > 8
                                            else "")
        raise SystemExit(f"--load-weights {path} does not fill "
                         f"{len(unfilled)} keys of the model (missing or of "
                         f"another shape): {shown}")


def time_sharded_step(net, shard, aug):
    """step(raw batch) -> {logits, label}: the clip's frames of this rank
    (`split_frames` of its T) augmented and run through
    `parallel.temporal.time_sharded_forward`; the logits on every rank."""
    from dmcnet_tpu_torch.parallel.temporal import (
        Frames,
        split_frames,
        time_sharded_forward,
    )

    def step(raw):
        ranges = split_frames(raw["frames"].shape[1], shard.size)
        a, b = ranges[shard.rank]
        batch = i3d_augment_batch(dict(raw, frames=raw["frames"][:, a:b]),
                                  **aug)
        mv_res = torch.cat([batch["mv"], batch["residual"]], dim=1)
        logits, _ = time_sharded_forward(net, shard, Frames(mv_res, ranges))
        return {"logits": logits, "label": batch["label"]}

    return step


def evaluate(args, ds, *, device, shard=None):
    """Score every video of `ds` (a VideoClipDataset) over
    `args.num_sample` rounds on `device`; returns (scores (N, C) float64,
    the per-video mean of the rounds' logits, labels (N,) int64, top1 %),
    and writes `args.score_file`.npz when it is set.  With `shard` (a
    `parallel.temporal.TimeShard`) each clip's T axis is split over its
    ranks, and rank 0 alone prints and writes."""
    device = torch.device(device)
    say = print if shard is None or world()[0] == 0 else (lambda *a: None)
    if args.modality != "flow+mp4" or not args.arch_estimator:
        raise SystemExit("evaluate_video_i3d scores flow+mp4 clips through "
                         "a generator (--modality flow+mp4 with "
                         "--arch-estimator)")
    num_classes = dataset_num_classes(args.dataset)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        net, input_conf = get_symbol(
            "I3D", modality=args.modality, num_classes=num_classes,
            arch_estimator=args.arch_estimator, arch_d=args.arch_d,
            input_size=args.input_size)
    load_weights(net, args.load_weights, args.modality)
    net.to(device)
    asm = I3DBatchAssembler(ds, input_size=args.input_size, is_train=False)
    aug = dict(modality=args.modality, ds_factor=args.ds_factor,
               input_size=args.input_size, mean=input_conf["mean"][0],
               std=input_conf["std"][0], device=device)
    if shard is None:
        eval_step = make_i3d_eval_step(net)

        def step(raw):
            return eval_step(i3d_augment_batch(raw, **aug))
    else:
        step = time_sharded_step(net, shard, aug)
    avg_scores = np.zeros((len(ds), num_classes), np.float64)
    labels = np.zeros((len(ds),), np.int64)
    t0 = time.time()
    done = 0
    for _ in range(args.num_sample):
        for start in range(0, len(ds), args.batch_size):
            idx = list(range(start, min(start + args.batch_size, len(ds))))
            m = step(asm.batch(idx))
            avg_scores[idx] += m["logits"].cpu().numpy()
            labels[idx] = m["label"].cpu().numpy()
            done += len(idx)
            if done % 100 == 0:
                say(f"{done} clips, {done / (time.time() - t0):.2f} "
                    f"samples/sec")
    avg_scores /= args.num_sample
    top1, top5 = topk_accuracy(avg_scores, labels, ks=(1, 5))
    say(f"Final top-1: {top1:.2f}%  top-5: {top5:.2f}% "
        f"({len(ds)} videos, "
        f"{len(ds) * args.num_sample / (time.time() - t0):.2f} "
        f"samples/sec)")
    if args.score_file and world()[0] == 0:
        np.savez(args.score_file, scores=avg_scores, labels=labels,
                 top1=top1)
    return avg_scores, labels, top1


def shard_cards(args):
    """The card ids `--shard-time` runs on: the largest leading share of
    `--gpus` (default every visible card) whose count divides
    `--clip-length`."""
    if args.gpus:
        ids = list(args.gpus)
    elif torch.device(args.device).type == "cuda":
        device_for(args)       # raises without CUDA
        ids = list(range(torch.cuda.device_count()))
    else:
        ids = [0]
    n = len(ids)
    while args.clip_length % n:
        n -= 1
    return ids[:n]


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_parser().parse_args(argv)
    ranked = args.dist_num_processes is not None
    if args.shard_time and not ranked:
        cards = shard_cards(args)
        print(f"sequence parallelism: clip T={args.clip_length} over "
              f"{len(cards)} devices"
              + ("" if len(cards) > 1 else " (the unsharded forward)"))
        if len(cards) > 1:
            return spawn_ranks(main, argv, cards)
    device = device_for(args)
    if device.type == "cuda" and ranked:
        torch.cuda.set_device(device)
    shard = None
    if initialize_distributed(args.dist_coordinator, args.dist_num_processes,
                              args.dist_process_id, device=device.type):
        from dmcnet_tpu_torch.parallel.temporal import TimeShard

        shard = TimeShard()
    try:
        return _evaluate_list(args, device, shard)
    finally:
        shutdown()


def _evaluate_list(args, device, shard):
    from dmcnet_tpu_torch.codec.coviar_compat import get_num_frames
    items = _items_from_list(
        list_path(args.data_root, args.dataset, args.split, "test"),
        args.video_prefix, args.flow_prefix, get_num_frames)
    ds = VideoClipDataset(
        items, RandomSampling(num=args.clip_length,
                              interval=args.frame_interval, seed=0),
        modality=args.modality, accumulate=bool(args.accumulate),
        mv_minmaxnorm=bool(args.mv_minmaxnorm))
    return evaluate(args, ds, device=device, shard=shard)[2]


if __name__ == "__main__":
    main(sys.argv[1:])
