"""dmcnet training command on one card — the port's counterpart of
`dmcnet_tpu/cli/train.py`, flag-compatible with reference
code/dmcnet/train.py (and, with `gan` — `cli/train_gan.py` — with
code/dmcnet_GAN/train.py), plus `--device` (default `cuda`):

    python -m dmcnet_tpu_torch.cli.train --data-name hmdb51 \
        --representation mv --arch resnet18 --arch_estimator DenseNetTiny \
        --num_segments 3 --no-accumulation --mv_minmaxnorm 1 \
        --flow_ds_factor 16 --gen_flow_or_delta 1 --data-root ... \
        --flow-root ... --train-list ... --test-list ... --lr 0.01 \
        --lr-mse 1 --lr-steps 55 110 165 --lr-decay 0.25 --epochs 220 \
        --batch-size 40 --model-prefix model

Orchestration mirrors the reference `main()` (train.py:31-201): partial
init from `--weights`, per-epoch stepwise lr with the freeze phase, train
steps fed by `PrefetchLoader` threads, periodic validation, best and
periodic checkpoints.  The GAN variant alternates a D step (even batches)
and a G step (odd batches) of `train/engine_gan.py` over three optimizers;
its freeze phase steps the classifier at lr 0.  `train()` holds the epoch
loop and takes the datasets, so a caller with its own datasets drives the
same loop.  The
ragged last validation batch runs at its own size (the JAX package pads it
to keep one compiled shape); the means are the same.  Flags of slices not
ported yet raise `SystemExit` naming their ROADMAP item.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import time

import torch

from dmcnet_tpu_torch.cli.common import (
    device_for,
    num_classes_for,
    refuse_unported,
)
from dmcnet_tpu_torch.cli.train_options import build_parser
from dmcnet_tpu_torch.data.dmc_dataset import (
    BatchAssembler,
    CoviarDataset,
    augment_eval_batch,
    augment_train_batch,
)
from dmcnet_tpu_torch.data.loader import PrefetchLoader
from dmcnet_tpu_torch.models.tsn import DMCNet
from dmcnet_tpu_torch.train.checkpoints import (
    checkpoint_name,
    load_checkpoint,
    load_reference_weights,
    save_checkpoint,
)
from dmcnet_tpu_torch.train.engine import make_eval_step, make_train_step
from dmcnet_tpu_torch.train.engine_gan import make_gan_train_steps
from dmcnet_tpu_torch.train.metrics import AverageMeter
from dmcnet_tpu_torch.train.optimizers import (
    adjust_learning_rate,
    make_optimizers,
    step_decay_lr,
)
from dmcnet_tpu_torch.utils.metrics_log import MetricsLogger

SAVE_FREQ = 40
PRINT_FREQ = 20
_METRICS = ("loss", "loss_cls", "loss_mse", "top1", "top5")
_GAN_METRICS = ("loss_adv", "acc_D_adv", "acc_G_adv")


def build_model(args, num_class, input_size=224):
    """The reference `Model`, with the discriminator `args.arch_d` when the
    options have one (the GAN parser's), initialised from a fixed seed."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        return DMCNet(num_class, num_segments=args.num_segments,
                      arch=args.arch, arch_estimator=args.arch_estimator,
                      gen_flow_or_delta=args.gen_flow_or_delta,
                      gen_flow_ds_factor=args.gen_flow_ds_factor,
                      att=args.att, arch_d=getattr(args, "arch_d", None),
                      input_size=input_size)


def make_datasets(args):
    common = dict(
        data_root=args.data_root, flow_root=args.flow_root,
        representation=args.representation, num_segments=args.num_segments,
        accumulate=(not args.no_accumulation), gop=args.gop,
        flow_ds_factor=args.flow_ds_factor,
        upsample_interp=args.upsample_interp,
        mv_minmaxnorm=args.mv_minmaxnorm, flow_folder=args.data_flow,
        new_length=args.new_length, gop_cache_mb=args.gop_cache_mb,
        reader_cache=args.reader_cache)
    return (CoviarDataset(video_list=args.train_list, is_train=True,
                          **common),
            CoviarDataset(video_list=args.test_list, is_train=False,
                          **common))


@dataclasses.dataclass
class TrainResult:
    best_prec1: float
    model: torch.nn.Module
    optimizers: tuple          # (opt_cls, opt_gf[, opt_d])
    epochs: list               # per epoch: {epoch, data_time, batch_time}
    #                            (averages, s) and the per-batch lists
    #                            data_times, batch_times
    checkpoint: str = None     # the last checkpoint written, if any


def flush_pending(pending, meters):
    """Read the deferred device metrics into the meters (exact values; the
    deferral only keeps a device sync off every step)."""
    for metrics, n in pending:
        for k, v in metrics.items():
            meters[k].update(v.item(), n)
    pending.clear()


def train(args, train_ds, val_ds, *, device, input_size=224):
    """The epoch loop of reference main() over `train_ds` / `val_ds`
    (CoviarDataset contract) on `device`; the dmcnet_GAN loop when `args`
    name a discriminator (`build_parser(gan=True)`), which also gives the
    model one.  `input_size` is the reference's fixed 224 (model.py:306)
    unless a caller shrinks it."""
    device = torch.device(device)
    gan = getattr(args, "arch_d", None) is not None
    num_class = num_classes_for(args.data_name)
    model = build_model(args, num_class, input_size).to(device)
    if args.packed_gen:
        print(f"--packed-gen {args.packed_gen}: the port trains the unpacked "
              "layout (packing is an exact reparameterization of it)")
    scale_size = input_size * 256 // 224
    train_asm = BatchAssembler(train_ds, input_size=input_size,
                               scale_size=scale_size)
    val_asm = BatchAssembler(val_ds, input_size=input_size,
                             scale_size=scale_size, test_crops=1)
    aug = dict(representation=args.representation,
               flow_ds_factor=args.flow_ds_factor,
               upsample_interp=args.upsample_interp, input_size=input_size,
               device=device)

    # The JAX trainer draws a 2-video batch to initialise its state; drawing
    # it here too keeps both packages' streams of videos, frames and crops
    # the same from the same seeds.
    sample = augment_train_batch(
        train_asm.train_batch(range(min(2, len(train_ds)))), **aug)
    print("sample batch: " + ", ".join(
        f"{k} {tuple(v.shape)}" for k, v in sorted(sample.items())))

    optimizers = make_optimizers(model, args.lr_cls_mult, args.lr_mse_mult,
                                 args.lr_d_mult if gan else None)
    start_epoch, best_prec1 = 0, 0.0
    if args.weights:
        skipped, missing = load_reference_weights(model, args.weights)
        print(f"loaded --weights {args.weights} (skipped {len(skipped)}, "
              f"missing {len(missing)})")
    if args.auto_resume and not args.resume:
        cand = checkpoint_name(args.model_prefix, args.representation)
        if os.path.exists(cand):
            args.resume = cand
            print(f"--auto-resume: found {cand}")
    if args.resume:
        meta = load_checkpoint(args.resume, model, optimizers)
        start_epoch = meta["epoch"]
        best_prec1 = meta["best_prec1"] or 0.0
        print(f"=> loaded checkpoint '{args.resume}' (epoch {start_epoch})")

    steps = dict(num_segments=args.num_segments, lr_cls_w=args.lr_cls,
                 lr_mse_w=args.lr_mse, loss_mse=args.loss_mse,
                 bf16=bool(args.bf16))
    eval_step = make_eval_step(model, **steps)
    if gan:
        gan_steps = make_gan_train_steps(
            model, *optimizers, lr_adv_g=args.lr_adv_g,
            lr_adv_d=args.lr_adv_d, **steps)
    else:
        train_step = make_train_step(model, *optimizers, **steps)
    metric_keys = _METRICS + (_GAN_METRICS if gan else ())

    bs = args.batch_size
    batches_per_epoch = max(1, len(train_ds) // bs)
    result = TrainResult(best_prec1, model, optimizers, [])
    mlog = MetricsLogger(args.metrics_jsonl)
    try:
        for epoch in range(start_epoch, args.epochs):
            lr = step_decay_lr(args.lr, epoch, args.lr_steps, args.lr_decay)
            freeze = epoch < args.epoch_thre
            print(f"current epoch freeze?: {freeze}")
            if gan:  # the classifier steps at lr 0 while frozen
                adjust_learning_rate(optimizers[:1], 0.0 if freeze else lr,
                                     args.weight_decay)
                adjust_learning_rate(optimizers[1:], lr, args.weight_decay)
            else:
                adjust_learning_rate(optimizers, lr, args.weight_decay)
            loader = PrefetchLoader(
                lambda i: train_asm.train_batch(range(i * bs, (i + 1) * bs)),
                batches_per_epoch, workers=args.workers)
            meters = {k: AverageMeter()
                      for k in ("batch_time", "data_time") + metric_keys}
            pending, data_times, batch_times = [], [], []
            end = time.time()
            for i, raw in enumerate(loader):
                data_times.append(time.time() - end)
                meters["data_time"].update(data_times[-1])
                batch = augment_train_batch(raw, **aug)
                if gan:
                    metrics = gan_steps[i % 2](batch)
                else:
                    metrics = train_step(batch, not freeze)
                pending.append((metrics, len(raw["label"])))
                batch_times.append(time.time() - end)
                meters["batch_time"].update(batch_times[-1])
                end = time.time()
                if i % PRINT_FREQ == 0:
                    flush_pending(pending, meters)
                    line = (f"Epoch: [{epoch}][{i}/{batches_per_epoch}], "
                            f"lr_gf: {lr:.7f}\t"
                            f"Time {meters['batch_time'].val:.3f} "
                            f"({meters['batch_time'].avg:.3f})\t"
                            f"Data {meters['data_time'].val:.3f} "
                            f"({meters['data_time'].avg:.3f})\t"
                            f"Loss {meters['loss'].val:.4f} "
                            f"({meters['loss'].avg:.4f})\t"
                            f"Prec@1 {meters['top1'].val:.3f} "
                            f"({meters['top1'].avg:.3f})\t"
                            f"Prec@5 {meters['top5'].val:.3f} "
                            f"({meters['top5'].avg:.3f})")
                    extra = {}
                    if gan:
                        line = (("D " if i % 2 == 0 else "G ") + line
                                + f"\tLoss_adv {meters['loss_adv'].avg:.4f}"
                                f"\tacc_D_adv {meters['acc_D_adv'].avg:.3f}"
                                f"\tacc_G_adv {meters['acc_G_adv'].avg:.3f}")
                        extra["loss_adv"] = meters["loss_adv"].avg
                    print(line)
                    mlog.log("train", epoch=epoch, step=i, lr=lr,
                             loss=meters["loss"].avg,
                             top1=meters["top1"].avg,
                             top5=meters["top5"].avg,
                             batch_time=meters["batch_time"].avg,
                             data_time=meters["data_time"].avg, **extra)
            flush_pending(pending, meters)
            result.epochs.append({"epoch": epoch,
                                  "data_time": meters["data_time"].avg,
                                  "batch_time": meters["batch_time"].avg,
                                  "data_times": data_times,
                                  "batch_times": batch_times})

            if epoch % args.eval_freq == 0 or epoch == args.epochs - 1:
                prec1 = validate(val_asm, eval_step, bs, aug)
                mlog.log("eval", epoch=epoch, prec1=prec1)
                is_best = prec1 > best_prec1
                best_prec1 = max(prec1, best_prec1)
                result.best_prec1 = best_prec1
                if is_best or epoch % SAVE_FREQ == 0:
                    name = checkpoint_name(args.model_prefix,
                                           args.representation)
                    meta = {"epoch": epoch + 1, "arch": args.arch,
                            "best_prec1": best_prec1}
                    result.checkpoint = save_checkpoint(
                        model, meta, name, optimizers, is_best)
                    if args.save_reference_ckpt:
                        ref = save_checkpoint(model, meta,
                                              name + ".ref.pth.tar")
                        print(f"reference-format checkpoint: {ref}")
    finally:
        mlog.close()
    return result


def validate(val_asm, eval_step, batch_size, aug):
    """Reference validate() (train.py:292-369): Prec@1 over the validation
    set, batch by batch; returns it."""
    top1, losses = AverageMeter(), AverageMeter()
    n = len(val_asm.ds)
    for start in range(0, n, batch_size):
        idx = range(start, min(start + batch_size, n))
        m = eval_step(augment_eval_batch(val_asm.eval_batch(idx), **aug))
        top1.update(m["top1"].item(), len(idx))
        losses.update(m["loss"].item(), len(idx))
    print(f"Testing Results: Prec@1 {top1.avg:.3f} Loss {losses.avg:.5f}")
    return top1.avg


def main(argv=None, gan=False, input_size=224):
    """`gan` selects the dmcnet_GAN parser, whose `--arch_d` makes
    `train()` the dmcnet_GAN trainer; `input_size` defaults to the
    reference's fixed 224, and tests shrink it."""
    args = build_parser(gan=gan).parse_args(argv)
    print("Training arguments:")
    for k, v in sorted(vars(args).items()):
        print(f"\t{k}: {v}")
    refuse_unported([
        (args.fsdp, "--fsdp", "A item 9 (parallel layer)"),
        ((args.tp or 0) > 1, "--tp > 1", "A item 9 (parallel layer)"),
        (args.gpus is not None and len(args.gpus) > 1,
         "--gpus with several ids", "A item 9 (parallel layer)"),
        (args.dist_coordinator is not None
         or args.dist_num_processes is not None
         or args.dist_process_id is not None,
         "--dist-*", "A item 9 (parallel layer)"),
        (args.ckpt_backend.startswith("orbax"),
         f"--ckpt-backend {args.ckpt_backend}",
         "A item 2 (checkpoint formats)"),
        (args.profile_dir is not None, "--profile-dir",
         "A item 10 (utils/profiling)"),
    ])
    device = device_for(args)
    train_ds, val_ds = make_datasets(args)
    return train(args, train_ds, val_ds, device=device,
                 input_size=input_size).best_prec1


if __name__ == "__main__":
    main(sys.argv[1:])
