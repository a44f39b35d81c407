"""DMC-Net I3D training — the port's counterpart of
`dmcnet_tpu/cli/train_i3d.py` (reference code/dmcnet_I3D/train_{hmdb51,
ucf101}.py and train_model.py), with its flags plus `--device` (default
`cuda`).  examples/i3d/train.sh on the port:

    python -m dmcnet_tpu_torch.cli.train_hmdb51 --task-name hmdb_1 \\
        --split 1 --network I3D --clip-length 64 --iter-size 32 \\
        --batch-size 3 --optimizer adam --modality flow+mp4 \\
        --train-frame-interval 1 --val-frame-interval 1 --lr-base 0.0004 \\
        --lr-base2 0.0004 --lr-d 0.002 --detach 1 --lr-factor 0.2 \\
        --drop-out 0.85 --fine_tune 0 --arch-estimator DenseNetTiny \\
        --arch-d Discriminator --adv 1 --epoch-thre 6 --ds_factor 16 \\
        --mv-minmaxnorm 1 --accumulate 0 --data-root ./dataset/HMDB51 \\
        --video-prefix /data/hmdb51/mpeg4 --flow-prefix /data/hmdb51/tvl1 \\
        --pretrained_3d ./exps/models/model_flow.pth

Orchestration mirrors the JAX command: the per-iteration
MultiFactorScheduler with its lr steps divided by the batch size, driven by
`I3DLRDriver` with every stale-value quirk of the reference; a D macro step
on even batches and a G macro step on odd ones when `--adv` is on; the
classification term dropped from the G loss in epoch 0; weight decay 1e-4;
the stage-2 swap at `--epoch-thre` (fresh classifier and generator
optimizers, the discriminator's kept with its moments and step count, the
carried `.grad` kept); per-epoch evaluation with softmax scores, top-1 and
`score_best.npz` {scores (N, C), labels, top1}; a checkpoint
`{model_prefix}_ep-{epoch:04d}.pth` after epoch 0 and every
`--save-frequency` epochs (`train/checkpoints.save_i3d_checkpoint`), or
with `--ckpt-backend orbax | orbax-async` the step directory
`{model_prefix}_ep-{epoch:04d}.pth.orbax/<epoch>/` written through
`torch.distributed.checkpoint` (the second in the background), and
`--resume-epoch` / `--auto-resume`, which read the port's torch files, the
JAX package's files or such directories and skip a torn step.  The
microbatches of a macro step come from `PrefetchLoader` threads in the JAX
command's sample order and reach the card one at a time.

Differences from the JAX command:
  * it trains flow+mp4 clips through a generator only: the JAX steps read
    the batches' mv, residual and flow, which only that modality has;
  * the ragged last validation batch runs at its own size (the JAX command
    pads it to keep one compiled shape);
  * a `--pretrained_3d` or `--new_classifier` file that does not exist
    raises instead of being skipped;
  * `--accum-chunk` parses and changes nothing: the JAX command's chunked
    steps feed the macro step's microbatches to the chip in chunks, which
    the sequential accumulation here already does one at a time, with the
    same result.  Its refusal beside `--tp > 1` or `--fsdp` is kept.

`--remat 1` recomputes the I3D's Mixed blocks and the generator in the
backward, `--remat dots` the Mixed blocks' BN/ReLU tails only
(`models/i3d.py`); the running statistics are updated once.

Several processes (`parallel/`), as `cli.train`: `--dist-coordinator
host:port --dist-num-processes N --dist-process-id R` starts rank R of N,
and `--gpus a,b,...` starts one process per id.  Each rank assembles its
rows of every microbatch of a macro step (the JAX command's batch axis 1 of
the stacked (iter_size, B, ...) layout) from its own seed (`process_seed`),
BatchNorm normalizes over the global microbatch, and each stepping
optimizer averages its gradients once, just before it steps: a gradient
carried from the D phase into the G phase (or back) is each rank's own sum
until then, and by linearity the average of carry plus this phase's sums
is the global batch's.  `--fsdp 1` shards parameters and moments with
FSDP2 (on one process it trains unsharded and says so); `--tp N` shards
the large layers' output channels over N adjacent ranks
(`parallel/tensor.py`); across processes both need a step directory
(`--ckpt-backend orbax*`).  `--auto-resume` resumes at the oldest newest
epoch over the ranks (an all-reduce min), so that no rank runs ahead.
Rank 0 alone prints and writes torch files and scores; before a
checkpoint the carried gradients are averaged over the ranks (a file keeps
one copy), which leaves the next step the same.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

import numpy as np
import torch

from dmcnet_tpu_torch.cli.common import (
    check_parallel_flags,
    device_for,
    place,
)
from dmcnet_tpu_torch.data.iterator_factory import creat, dataset_num_classes
from dmcnet_tpu_torch.data.loader import PrefetchLoader
from dmcnet_tpu_torch.data.video_iter import (
    I3DBatchAssembler,
    i3d_augment_batch,
)
from dmcnet_tpu_torch.models.i3d import get_symbol
from dmcnet_tpu_torch.models.import_tf_i3d import load_tf_weights
from dmcnet_tpu_torch.models.weights import (
    load_reference_i3d,
    load_reference_i3d_2d,
)
from dmcnet_tpu_torch.parallel.mesh import all_reduce_mean
from dmcnet_tpu_torch.parallel.multihost import (
    initialize_distributed,
    local_shard_indices,
    process_seed,
    shutdown,
    spawn_ranks,
    world,
)
from dmcnet_tpu_torch.train.checkpoints import (
    dcp_checkpoint_committed,
    i3d_checkpoint_name,
    load_i3d_checkpoint,
    save_i3d_checkpoint,
    save_i3d_checkpoint_dcp,
    wait_for_checkpoints,
)
from dmcnet_tpu_torch.train.engine import _autocast
from dmcnet_tpu_torch.train.engine_i3d import (
    make_i3d_eval_step,
    make_i3d_steps,
)
from dmcnet_tpu_torch.train.lr_scheduler import (
    I3DLRDriver,
    MultiFactorScheduler,
)
from dmcnet_tpu_torch.train.metrics import AverageMeter
from dmcnet_tpu_torch.train.optimizers import make_i3d_optimizers
from dmcnet_tpu_torch.utils.metrics_log import MetricsLogger

WEIGHT_DECAY = 1e-4
PRINT_FREQ = 50
_ACCUM_CHUNK = ("the JAX command's chunked accumulation; the port's "
                "sequential accumulation already computes what the chunked "
                "steps compute, one microbatch on the card at a time, so "
                "this parses and changes nothing")


def build_parser(dataset_default="HMDB51"):
    p = argparse.ArgumentParser(description="DMC-Net Parser")
    p.add_argument('--debug-mode', type=bool, default=True)
    p.add_argument('--dataset', default=dataset_default,
                   choices=['UCF101', 'HMDB51'])
    p.add_argument('--split', type=int, default=1)
    p.add_argument('--clip-length', type=int, default=16)
    p.add_argument('--train-frame-interval', type=int, default=2)
    p.add_argument('--val-frame-interval', type=int, default=2)
    p.add_argument('--task-name', type=str, default='')
    p.add_argument('--model-dir', type=str, default="./exps/models")
    p.add_argument('--log-file', type=str, default="")
    p.add_argument('--accumulate', type=int, default=1)
    p.add_argument('--mv-minmaxnorm', type=int, default=0)
    p.add_argument('--mv-loadimg', type=int, default=0)
    p.add_argument('--detach', type=int, default=0)
    p.add_argument('--ds_factor', type=int, default=16)
    p.add_argument('--gpus', type=str, default="0",
                   help='card ids, comma-separated; several start one '
                        'data-parallel process per id on this host (with '
                        '--device cpu, gloo processes on the CPU)')
    p.add_argument('--network', type=str, default='I3D', choices=['I3D'])
    p.add_argument('--arch-estimator', type=str, default=None,
                   choices=['DenseNet', 'DenseNetSmall', 'DenseNetTiny'])
    p.add_argument('--arch-d', type=str, default=None)
    p.add_argument('--pretrained_2d', type=bool, default=False)
    p.add_argument('--pretrained_3d', type=str, default=None)
    p.add_argument('--new_classifier', type=bool, default=False)
    p.add_argument('--new-classifier-weights', type=str,
                   default='./network/pretrained/model_flow.pth',
                   help="classifier re-init source (the reference hardcodes "
                        "this path, train_model.py:193)")
    p.add_argument('--resume-epoch', type=int, default=-1)
    p.add_argument('--metrics-jsonl', type=str, default=None,
                   help='append one JSON object per train/eval log event '
                        '(machine-readable twin of the stdout lines).')
    p.add_argument('--auto-resume', type=int, default=0,
                   help="resume from this run's newest per-epoch checkpoint "
                        'if any exists (--resume-epoch takes precedence).')
    p.add_argument('--modality', type=str, default='rgb',
                   choices=['rgb', 'flow', 'mv', 'res', 'flow+mp4', 'I'])
    p.add_argument('--drop-out', type=float, default=0.5)
    p.add_argument('--adv', type=float, default=0.)
    p.add_argument('--epoch-thre', type=int, default=1)
    p.add_argument('--optimizer', type=str, default='sgd',
                   choices=['sgd', 'adam'])
    p.add_argument('--fine_tune', type=int, default=1)
    p.add_argument('--batch-size', type=int, default=32)
    p.add_argument('--iter-size', type=int, default=1)
    p.add_argument('--lr-base', type=float, default=0.005)
    p.add_argument('--lr-base2', type=float, default=0.002)
    p.add_argument('--lr-d', type=float, default=None)
    p.add_argument('--lr-steps', type=float, nargs="+",
                   default=[int(1e4 * x) for x in
                            [3.5, 6, 8.5, 11, 13.5, 16]])
    p.add_argument('--lr-factor', type=float, default=0.1)
    p.add_argument('--save-frequency', type=float, default=1)
    p.add_argument('--end-epoch', type=int, default=50)
    p.add_argument('--random-seed', type=int, default=1)
    p.add_argument('--data-root', type=str, default=None,
                   help="dataset dir containing raw/list_cvt lists")
    p.add_argument('--video-prefix', type=str, required=False)
    p.add_argument('--flow-prefix', type=str, default=None)
    p.add_argument('--remat', type=str, default="0",
                   choices=["0", "1", "dots"],
                   help="rematerialize Mixed blocks (activation ckpt; the "
                        "reference imports checkpoint_sequential unused, "
                        "i3d.py:19)")
    p.add_argument('--ckpt-backend', type=str, default='msgpack',
                   choices=['msgpack', 'orbax', 'orbax-async'],
                   help="msgpack (the JAX package's name for its default) "
                        "writes the port's torch checkpoints; orbax writes "
                        "step directories (torch.distributed.checkpoint), "
                        "orbax-async in the background")
    p.add_argument('--bf16', type=int, default=0,
                   help='mixed-precision training (bfloat16 autocast; '
                        'params/BN stats/losses stay float32)')
    p.add_argument('--packed-gen', type=int, default=0,
                   help='space-to-depth factor (e.g. 2) for the dense DMC '
                        'estimators: exact packed reparameterization, same '
                        'parameter tree/checkpoints; 0 = faithful layout')
    p.add_argument('--workers', type=int, default=8,
                   help='host loader threads (the reference hardcodes '
                        'DataLoader num_workers=8, iterator_factory.py:184)')
    p.add_argument('--accum-chunk', type=int, default=0, help=_ACCUM_CHUNK)
    p.add_argument('--tp', type=int, default=0,
                   help='tensor parallelism degree: the large layers '
                        'sharded on their output channels over this many '
                        'adjacent processes (parallel/tensor.py)')
    p.add_argument('--fsdp', type=int, default=0,
                   help='shard parameters and optimizer moments over the '
                        'processes (FSDP2); across processes it needs '
                        '--ckpt-backend orbax')
    p.add_argument('--dist-coordinator', type=str, default=None,
                   help='host:port of rank 0 for multi-process training '
                        '(torch.distributed, tcp://); needs '
                        '--dist-num-processes and --dist-process-id')
    p.add_argument('--dist-num-processes', type=int, default=None)
    p.add_argument('--dist-process-id', type=int, default=None)
    p.add_argument('--device', type=str, default='cuda',
                   help='torch device to train on (cuda, cpu)')
    return p


def autofill(args):
    if not args.task_name:
        args.task_name = os.path.basename(os.getcwd())
    args.model_prefix = os.path.join(args.model_dir, args.task_name)
    args.score_dir = ('./exps/score/{}_{}/'.format(args.dataset, args.split)
                      + args.task_name)
    if args.data_root is None:
        args.data_root = f"./dataset/{args.dataset}"
    return args


def build_model(args, num_classes, input_size=224):
    """The I3D of `args` with its generator, its discriminator when
    `--arch-d` names one and dropout `--drop-out` before the classifier,
    initialised from a fixed seed."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        return get_symbol(  # (model, input config)
            args.network, modality=args.modality, num_classes=num_classes,
            arch_estimator=args.arch_estimator, arch_d=args.arch_d,
            input_size=input_size, dropout_prob=args.drop_out,
            packed_gen=args.packed_gen,
            remat=("dots" if args.remat == "dots"
                   else bool(int(args.remat))))


def init_pretrained(args, model):
    """Pretrained initialisation, skipped when resuming (reference
    train_model.py:181-206): an .npz holds an exported Kinetics TF
    checkpoint (`models.import_tf_i3d`), `--pretrained_2d` flags a 2D
    torch checkpoint inflated in time, otherwise a reference 3D .pth;
    `--new_classifier` then overlays `--new-classifier-weights`."""
    if args.resume_epoch >= 0 or not args.pretrained_3d:
        return
    for flag, path in (("--pretrained_3d", args.pretrained_3d),
                       ("--new-classifier-weights",
                        args.new_classifier_weights if args.new_classifier
                        else None)):
        if path and not os.path.exists(path):
            raise SystemExit(f"{flag} {path} does not exist")
    in_ch = model.in_channels
    if args.pretrained_3d.endswith(".npz"):
        report, _ = load_tf_weights(
            args.pretrained_3d, model,
            modality=("rgb" if args.modality == "rgb" else "flow"),
            in_channels=in_ch)
    elif args.pretrained_2d:
        report, _ = load_reference_i3d_2d(args.pretrained_3d, model,
                                          args.modality,
                                          seed=args.random_seed)
    else:
        report, _ = load_reference_i3d(args.pretrained_3d, model,
                                       args.modality)
    print(f"pretrained_3d: {report}")
    if args.new_classifier:
        report, _ = load_reference_i3d(args.new_classifier_weights, model,
                                       args.modality)
        print(f"new_classifier: {report}")


@dataclasses.dataclass
class TrainResult:
    best_top1: float
    model: torch.nn.Module
    optimizers: dict           # {"cls", "gf"[, "d"]}
    epochs: list               # per epoch: {epoch, data_time, batch_time}
    #                            (averages, s) and the per-macro-step lists
    #                            data_times, batch_times
    checkpoint: str = None     # the last checkpoint written, if any


def train(args, train_ds, val_ds, *, device, input_size=224):
    """The JAX command's epoch loop over `train_ds` / `val_ds`
    (`VideoClipDataset` contract) on `device`.  `args` come from
    `build_parser` through `autofill`; `input_size` is the reference's 224
    unless a caller shrinks it."""
    device = torch.device(device)
    rank, world_size = world()
    parallel = world_size > 1
    say = print if rank == 0 else _silent
    tp = max(args.tp or 1, 1)
    # the dropout masks: each data row draws its own
    torch.manual_seed(process_seed(args.random_seed, tp))
    has_gan = args.adv > 0
    model, conf = build_model(args, dataset_num_classes(args.dataset),
                              input_size)
    init_pretrained(args, model)
    model.to(device)
    if args.fsdp and not parallel:
        say("--fsdp 1 on one process: nothing to shard")
    placement = place(model, fsdp=args.fsdp, tp=tp)
    if placement.tp > 1:
        say(f"tensor-parallel {world_size // tp}x{tp} mesh (batch "
            f"{args.batch_size} -> "
            f"{args.batch_size * tp // world_size}/data row)")
    train_asm = I3DBatchAssembler(train_ds, input_size=input_size,
                                  is_train=True,
                                  seed=process_seed(args.random_seed, tp))
    val_asm = I3DBatchAssembler(val_ds, input_size=input_size,
                                is_train=False)
    aug = dict(modality=args.modality, ds_factor=args.ds_factor,
               input_size=input_size, mean=conf["mean"][0],
               std=conf["std"][0], device=device)
    # The JAX command assembles one clip of video 0 to initialise its
    # variables; drawing it here too keeps both commands' streams of
    # frames and crops the same.
    sample = i3d_augment_batch(train_asm.batch([0]), **aug)
    say("sample clip: " + ", ".join(
        f"{k} {tuple(v.shape)}" for k, v in sorted(sample.items())))
    del sample

    def optimizers_for(stage2):
        # Stage 1 of flow+mp4 freezes the base I3D whatever --detach says
        # (reference model.py:273-277).  Across processes every optimizer,
        # the stage-2 ones too, averages its gradients before it steps.
        return placement.prepare(make_i3d_optimizers(
            model, optim=args.optimizer,
            lr_mul=0.2 if args.fine_tune else 0.5, has_gan=has_gan,
            stage2=stage2, freeze_base=args.epoch_thre > 0 and not stage2))

    def steps_for(opts, stage2):
        # Stage 1 under --detach steps the classifier at lr 0; its moments
        # die at the swap, so those steps skip its parameter gradients.
        # Only with epoch_thre <= 1: a later stage-1 epoch accumulates real
        # classifier gradients whose carry crosses the swap.
        frozen = not stage2 and bool(args.detach) and args.epoch_thre <= 1
        return make_i3d_steps(model, opts, adv=args.adv,
                              train_backbone=not frozen, bf16=bool(args.bf16))

    directory = args.ckpt_backend.startswith("orbax")

    def ckpt_path(epoch):
        name = i3d_checkpoint_name(args.model_prefix, epoch)
        return name + ".orbax" if directory else name

    def found(epoch):  # a torn step directory does not count
        return (dcp_checkpoint_committed(ckpt_path(epoch)) if directory
                else os.path.exists(ckpt_path(epoch)))

    if args.auto_resume and args.resume_epoch < 0:
        newest = next((e for e in range(args.end_epoch, 0, -1)
                       if found(e)), -1)
        if parallel:   # the oldest newest epoch over the ranks
            newest = agree_min(newest)
        if newest >= 0:
            args.resume_epoch = newest
            say(f"--auto-resume: epoch {newest}")
    # A resume at or after epoch_thre builds the stage-2 optimizers first,
    # so that the checkpoint's states restore into them.
    switched = args.resume_epoch >= max(args.epoch_thre, 0)
    opts = optimizers_for(switched)
    if args.resume_epoch >= 0:
        ckpt = ckpt_path(args.resume_epoch)
        meta = load_i3d_checkpoint(ckpt, model, opts, stage2=switched)
        say(f"resumed from {ckpt} (epoch {meta['epoch']})")
    d_step, g_step = steps_for(opts, switched)
    eval_step = make_i3d_eval_step(model)

    # lr steps divided by the samples of one scheduler tick
    # (train_model.py:217-222)
    step_div = max(1, int(args.batch_size))
    sched_steps = sorted({max(1, int(s // step_div)) for s in args.lr_steps})
    lr_driver = I3DLRDriver(
        MultiFactorScheduler(sched_steps, args.lr_base, args.lr_factor),
        MultiFactorScheduler(sched_steps, args.lr_base2, args.lr_factor),
        MultiFactorScheduler(sched_steps, args.lr_d or args.lr_base,
                             args.lr_factor),
        epoch_thre=args.epoch_thre, detach=bool(args.detach),
        has_gan=has_gan)

    bs, iters = args.batch_size, args.iter_size
    batches_per_epoch = max(1, len(train_ds) // (bs * iters))

    rows = list(local_shard_indices(bs, tp))

    def host_micro(i):
        """This rank's clips of macro step i, in the JAX command's order;
        host work only (decode and assembly), run by the loader threads."""
        start = i * bs * iters
        return [train_asm.batch([(start + k * bs + j) % len(train_ds)
                                 for j in rows])
                for k in range(iters)]

    result = TrainResult(-1.0, model, opts, [])
    os.makedirs(args.score_dir, exist_ok=True)
    os.makedirs(args.model_dir, exist_ok=True)
    mlog = MetricsLogger(args.metrics_jsonl if rank == 0 else None)
    try:
        for epoch in range(max(args.resume_epoch, 0), args.end_epoch):
            if epoch >= args.epoch_thre and not switched:
                say("stage 2: fresh classifier and generator optimizers "
                    "(reference model.py:347-351)")
                fresh = optimizers_for(True)
                opts.update(cls=fresh["cls"], gf=fresh["gf"])
                d_step, g_step = steps_for(opts, True)
                switched = True
            meters = {k: AverageMeter() for k in
                      ("loss", "loss_cls", "loss_mse", "top1", "speed")}
            t_epoch = time.time()
            loader = PrefetchLoader(host_micro, batches_per_epoch,
                                    workers=args.workers)
            data_times, batch_times = [], []
            end = time.time()
            for i_batch, micros in enumerate(loader):
                t0 = time.time()
                data_times.append(t0 - end)
                use_d = has_gan and i_batch % 2 == 0
                lr, lr1, lr_d = lr_driver.macro_step(epoch, use_d, iters)
                step = d_step if use_d else g_step
                metrics = step((i3d_augment_batch(m, **aug) for m in micros),
                               lr, lr1, lr_d or 0.0, WEIGHT_DECAY, epoch < 1)
                n = bs * iters
                keys = [k for k in ("loss", "loss_cls", "loss_mse", "top1")
                        if k in metrics]
                # the ranks' means over equally many rows: the global ones
                for k, v in zip(keys, all_reduce_mean(
                        [metrics[k] for k in keys])):
                    meters[k].update(v, n)
                now = time.time()
                batch_times.append(now - end)
                meters["speed"].update(n / (now - t0))
                end = now
                if i_batch % PRINT_FREQ == 0:
                    say(f"Epoch[{epoch}] Batch [{i_batch}]  "
                          f"Speed: {meters['speed'].avg:.2f} samples/sec  "
                          f"loss-ce {meters['loss_cls'].avg:.5f}  "
                          f"top-1 {meters['top1'].avg:.5f}")
                    mlog.log("train", epoch=epoch, step=i_batch,
                             speed=meters["speed"].avg,
                             loss_cls=meters["loss_cls"].avg,
                             loss_mse=meters["loss_mse"].avg,
                             top1=meters["top1"].avg)
            result.epochs.append({
                "epoch": epoch, "data_time": float(np.mean(data_times)),
                "batch_time": float(np.mean(batch_times)),
                "data_times": data_times, "batch_times": batch_times})

            scores, labels, top1 = validate(val_asm, eval_step, bs, aug,
                                            bool(args.bf16), tp)
            say(f"Epoch[{epoch}] eval top-1: {top1:.3f} "
                f"({time.time() - t_epoch:.1f}s)")
            mlog.log("eval", epoch=epoch, top1=top1,
                     epoch_s=round(time.time() - t_epoch, 1))
            if top1 > result.best_top1:
                result.best_top1 = top1
                if rank == 0:
                    np.savez(os.path.join(args.score_dir, "score_best.npz"),
                             scores=scores, labels=labels, top1=top1)
            if epoch == 0 or (epoch + 1) % max(int(args.save_frequency),
                                               1) == 0:
                # ep-N is the state ready to train epoch N (reference
                # epoch_end_callback, train/model.py:253-260)
                meta = {"epoch": epoch + 1, "top1": top1,
                        "stage2": switched}
                placement.average_carry(model)
                if directory:   # every rank writes its shards
                    result.checkpoint = save_i3d_checkpoint_dcp(
                        model, opts, meta, ckpt_path(epoch + 1),
                        wait=args.ckpt_backend != "orbax-async")
                elif rank == 0:
                    result.checkpoint = save_i3d_checkpoint(
                        model, opts, meta, ckpt_path(epoch + 1))
                else:
                    result.checkpoint = ckpt_path(epoch + 1)
    finally:
        mlog.close()
        wait_for_checkpoints()  # drain background writes before returning
    return result


def _silent(*args, **kwargs):
    pass


def agree_min(value):
    """The least of the ranks' integer `value`s (an all-reduce min)."""
    import torch.distributed as dist

    t = torch.tensor([int(value)], dtype=torch.int64)
    dist.all_reduce(t, op=dist.ReduceOp.MIN)
    return int(t.item())


def validate(val_asm, eval_step, batch_size, aug, bf16, tp=1):
    """Softmax scores (N, C), labels (N,) and top-1 in percent over the
    validation set, batch by batch (reference train/model.py:531-577).
    Each data row scores its rows of each batch (a rank with none left in
    the ragged last batch scores the last row and drops it: the sharded
    forwards need every rank) and every rank gets all of them."""
    n = len(val_asm.ds)
    rows = list(local_shard_indices(batch_size, tp))
    got = {}
    for start in range(0, n, batch_size):
        stop = min(start + batch_size, n)
        idx = [start + j for j in rows if start + j < stop]
        b = i3d_augment_batch(val_asm.batch(idx or [stop - 1]), **aug)
        with _autocast(b["label"].device, bf16):
            m = eval_step(b)
        s = torch.softmax(m["logits"].float(), -1).cpu().numpy()
        for i, row, label in zip(idx, s, m["label"].cpu().numpy()):
            got[i] = (row, label)
    if world()[1] > 1:
        import torch.distributed as dist

        parts = [None] * world()[1]
        dist.all_gather_object(parts, got)
        for part in parts:
            got.update(part)
    scores = np.stack([got[i][0] for i in range(n)])
    labels = np.asarray([got[i][1] for i in range(n)])
    return scores, labels, 100.0 * float((scores.argmax(-1) == labels).mean())


def main(argv=None, dataset_default="HMDB51", input_size=224):
    """`input_size` is the reference's 224; tests shrink it."""
    argv = sys.argv[1:] if argv is None else list(argv)
    args = autofill(build_parser(dataset_default).parse_args(argv))
    args.gpus = [int(g) for g in args.gpus.split(",") if g.strip()]
    spawn = len(args.gpus) > 1 and args.dist_num_processes is None
    n_proc = len(args.gpus) if spawn else (args.dist_num_processes or 1)
    if args.accum_chunk and args.accum_chunk < args.iter_size and (
            (args.tp and args.tp > 1) or args.fsdp):
        raise SystemExit(
            "--accum-chunk composes with plain data parallelism "
            "only; --fsdp/--tp already cut per-chip residency by "
            "sharding state and batch over the mesh")
    check_parallel_flags(n_proc, args.batch_size, args.tp, args.fsdp,
                         args.ckpt_backend.startswith("orbax"))
    if args.modality != "flow+mp4" or not args.arch_estimator:
        raise SystemExit("train_i3d trains flow+mp4 clips through a "
                         "generator (--modality flow+mp4 with "
                         "--arch-estimator)")
    if args.adv > 0 and not args.arch_d:
        raise SystemExit(f"--adv {args.adv} needs a discriminator "
                         "(--arch-d)")
    if spawn:
        return spawn_ranks(main, argv, args.gpus,
                           dataset_default=dataset_default,
                           input_size=input_size)
    if args.accum_chunk and (args.dist_process_id or 0) == 0:
        print(f"--accum-chunk: {_ACCUM_CHUNK}")
    device = device_for(args)
    if device.type == "cuda" and args.dist_num_processes:
        if not any(a.startswith("--gpus") for a in argv):
            # rank r drives card r of its host
            device = torch.device("cuda", (args.dist_process_id or 0)
                                  % torch.cuda.device_count())
        torch.cuda.set_device(device)
    initialize_distributed(args.dist_coordinator, args.dist_num_processes,
                           args.dist_process_id, device=device.type)
    try:
        train_ds, val_ds = creat(
            args.dataset, args.data_root, args.video_prefix,
            args.flow_prefix, split=args.split,
            clip_length=args.clip_length,
            train_interval=args.train_frame_interval,
            val_interval=args.val_frame_interval, modality=args.modality,
            accumulate=bool(args.accumulate),
            mv_minmaxnorm=bool(args.mv_minmaxnorm),
            seed=process_seed(args.random_seed, args.tp or 1))
        return train(args, train_ds, val_ds, device=device,
                     input_size=input_size).best_top1
    finally:
        shutdown()


if __name__ == "__main__":
    main(sys.argv[1:])
