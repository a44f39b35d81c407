"""dmcnet training command — the port's counterpart of
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
to keep one compiled shape); the means are the same.

Checkpoints: `--ckpt-backend msgpack` (the default) writes the torch file
`<prefix>_<representation>_checkpoint.pth.tar`; `orbax` and `orbax-async`
write step directories `<that name>.orbax/<epoch>/` through
`torch.distributed.checkpoint` (`train/checkpoints.save_checkpoint_dcp`),
the second in the background.  `--resume` reads a torch file, a JAX
package file or such a directory; `--auto-resume` finds the run's own and
skips a torn step.

Several processes (`parallel/`): `--dist-coordinator host:port
--dist-num-processes N --dist-process-id R` starts rank R of N (NCCL and
gloo on the card, gloo alone with `--device cpu`), and `--gpus` with
several ids starts one process per id on this host.  Each rank assembles
its rows of the global batch, BatchNorm normalizes over the global batch
and the gradients are averaged, so a step is the single-process step on
the global batch; `--fsdp 1` shards parameters and moments with FSDP2 and
then, across processes, needs a directory backend.  `--tp N` shards every
large convolution and linear layer's output channels over N adjacent
ranks (`parallel/tensor.py`, a (processes / N, N) mesh: the batch splits
over the data rows), with `--fsdp` also FSDP2 over the data dim; it writes
and resumes step directories only.  Rank 0 alone prints, logs and writes
torch files; every rank writes its shards of a directory.  `--fsdp` on one
process has nothing to shard and says so.

`--profile-dir DIR` traces training steps 2-7 of the first epoch (from
step 0 in an epoch of fewer than 3 batches, to the epoch's end in one of
fewer than 8) with `torch.profiler`, each step a `ProfilerStep#<step>`
span, CUDA kernels included on a card, and writes a Chrome trace JSON
into DIR (`utils/profiling.py`), as the JAX command traces its window
with `jax.profiler`.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import time

import torch

from dmcnet_tpu_torch.cli.common import (
    check_parallel_flags,
    device_for,
    num_classes_for,
    place,
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
from dmcnet_tpu_torch.parallel.mesh import all_reduce_mean, all_reduce_sum
from dmcnet_tpu_torch.parallel.multihost import (
    initialize_distributed,
    local_shard_indices,
    process_seed,
    shutdown,
    spawn_ranks,
    world,
)
from dmcnet_tpu_torch.train.checkpoints import (
    best_name,
    checkpoint_format,
    checkpoint_name,
    dcp_checkpoint_committed,
    load_checkpoint,
    load_reference_weights,
    save_checkpoint,
    save_checkpoint_dcp,
    wait_for_checkpoints,
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
from dmcnet_tpu_torch.utils.profiling import start_trace, stop_trace

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
                      input_size=input_size, packed_gen=args.packed_gen)


def make_datasets(args):
    """The train and validation `CoviarDataset`s of `args`.  A training
    dataset draws its videos from its seed and a counter, whatever the
    index, so each data row seeds its own (`process_seed`): with one seed
    every rank would draw the same videos, and the `--tp` ranks of a row
    must draw the same."""
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
                          seed=process_seed(0, args.tp), **common),
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
    saves: list = dataclasses.field(default_factory=list)
    #                            per save: {epoch, is_best, checkpoint_s,
    #                            best_s}, the s the loop blocked on the
    #                            checkpoint and on a directory's best copy


def flush_pending(pending, meters):
    """Read the deferred device metrics into the meters (exact values; the
    deferral only keeps a device sync off every step), each averaged over
    the ranks first, which makes them the global batch's (the ranks' rows
    are equally many)."""
    flat = iter(all_reduce_mean([v for metrics, _ in pending
                                 for v in metrics.values()]))
    for metrics, n in pending:
        for k in metrics:
            meters[k].update(next(flat), n * world()[1])
    pending.clear()


def _silent(*args, **kwargs):
    pass


def train(args, train_ds, val_ds, *, device, input_size=224):
    """The epoch loop of reference main() over `train_ds` / `val_ds`
    (CoviarDataset contract) on `device`; the dmcnet_GAN loop when `args`
    name a discriminator (`build_parser(gan=True)`), which also gives the
    model one.  `input_size` is the reference's fixed 224 (model.py:306)
    unless a caller shrinks it."""
    device = torch.device(device)
    rank, world_size = world()
    parallel = world_size > 1
    say = print if rank == 0 else _silent
    gan = getattr(args, "arch_d", None) is not None
    num_class = num_classes_for(args.data_name)
    model = build_model(args, num_class, input_size).to(device)
    if args.fsdp and not parallel:
        say("--fsdp 1 on one process: nothing to shard")
    tp = max(args.tp or 1, 1)
    scale_size = input_size * 256 // 224
    train_asm = BatchAssembler(train_ds, input_size=input_size,
                               scale_size=scale_size,
                               seed=process_seed(0, tp))
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
    say("sample batch: " + ", ".join(
        f"{k} {tuple(v.shape)}" for k, v in sorted(sample.items())))

    start_epoch, best_prec1 = 0, 0.0
    if args.weights:
        skipped, missing = load_reference_weights(model, args.weights)
        say(f"loaded --weights {args.weights} (skipped {len(skipped)}, "
            f"missing {len(missing)})")
    placement = place(model, fsdp=args.fsdp, tp=tp)
    if placement.tp > 1:
        say(f"tensor-parallel {world_size // tp}x{tp} mesh (batch "
            f"{args.batch_size} -> "
            f"{args.batch_size * tp // world_size}/data row)")
    optimizers = placement.prepare(make_optimizers(
        model, args.lr_cls_mult, args.lr_mse_mult,
        args.lr_d_mult if gan else None))
    directory = args.ckpt_backend.startswith("orbax")
    if args.auto_resume and not args.resume:
        cand = checkpoint_name(args.model_prefix, args.representation)
        if directory:
            cand += ".orbax"
            ok = dcp_checkpoint_committed(cand)  # skips a torn write
        else:
            ok = os.path.exists(cand)
        # every rank must see it, or the ranks' programs part ways
        ok = all_reduce_sum([float(ok)])[0] == world_size
        if ok:
            args.resume = cand
            say(f"--auto-resume: found {cand}")
    if args.resume:
        if parallel and (args.fsdp or tp > 1) and \
                checkpoint_format(args.resume) != "dcp":
            raise SystemExit(f"{'--fsdp' if args.fsdp else '--tp'} across "
                             "processes resumes from a --ckpt-backend orbax "
                             "directory")
        meta = load_checkpoint(args.resume, model, optimizers)
        start_epoch = meta["epoch"]
        best_prec1 = meta["best_prec1"] or 0.0
        say(f"=> loaded checkpoint '{args.resume}' (epoch {start_epoch})")

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
    rows = list(local_shard_indices(bs, tp))
    batches_per_epoch = max(1, len(train_ds) // bs)
    result = TrainResult(best_prec1, model, optimizers, [])
    mlog = MetricsLogger(args.metrics_jsonl if rank == 0 else None)
    try:
        for epoch in range(start_epoch, args.epochs):
            lr = step_decay_lr(args.lr, epoch, args.lr_steps, args.lr_decay)
            freeze = epoch < args.epoch_thre
            say(f"current epoch freeze?: {freeze}")
            if gan:  # the classifier steps at lr 0 while frozen
                adjust_learning_rate(optimizers[:1], 0.0 if freeze else lr,
                                     args.weight_decay)
                adjust_learning_rate(optimizers[1:], lr, args.weight_decay)
            else:
                adjust_learning_rate(optimizers, lr, args.weight_decay)
            # each rank assembles only its rows of the global batch
            loader = PrefetchLoader(
                lambda i: train_asm.train_batch([i * bs + j for j in rows]),
                batches_per_epoch, workers=args.workers)
            meters = {k: AverageMeter()
                      for k in ("batch_time", "data_time") + metric_keys}
            pending, data_times, batch_times = [], [], []
            prof = None
            end = time.time()
            for i, raw in enumerate(loader):
                if args.profile_dir and epoch == start_epoch:
                    # steps 2-7: past the first steps' warm-up, short
                    # enough to read (epochs shorter than 3 batches trace
                    # from step 0)
                    if i == min(2, batches_per_epoch - 1):
                        prof = start_trace(device, first_step=i)
                    elif i == 8 and prof is not None:
                        _stop_profile(prof, args.profile_dir, device, say)
                        prof = None
                    elif prof is not None:
                        prof.step()
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
                    say(line)
                    mlog.log("train", epoch=epoch, step=i, lr=lr,
                             loss=meters["loss"].avg,
                             top1=meters["top1"].avg,
                             top5=meters["top5"].avg,
                             batch_time=meters["batch_time"].avg,
                             data_time=meters["data_time"].avg, **extra)
            flush_pending(pending, meters)
            if prof is not None:  # an epoch shorter than the window
                _stop_profile(prof, args.profile_dir, device, say)
            result.epochs.append({"epoch": epoch,
                                  "data_time": meters["data_time"].avg,
                                  "batch_time": meters["batch_time"].avg,
                                  "data_times": data_times,
                                  "batch_times": batch_times})

            if epoch % args.eval_freq == 0 or epoch == args.epochs - 1:
                prec1 = validate(val_asm, eval_step, bs, aug, tp)
                mlog.log("eval", epoch=epoch, prec1=prec1)
                is_best = prec1 > best_prec1
                best_prec1 = max(prec1, best_prec1)
                result.best_prec1 = best_prec1
                if is_best or epoch % SAVE_FREQ == 0:
                    meta = {"epoch": epoch + 1, "arch": args.arch,
                            "best_prec1": best_prec1}
                    save = {"epoch": epoch, "is_best": is_best}
                    result.checkpoint = _save(args, model, optimizers, meta,
                                              is_best, rank, save)
                    result.saves.append(save)
    finally:
        mlog.close()
        wait_for_checkpoints()  # background writes commit before returning
    return result


def _stop_profile(prof, logdir, device, say):
    """Wait for the traced steps' work on `device`, stop `prof` and say
    where its trace went."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    say(f"profiler trace written to {stop_trace(prof, logdir)}")


def _save(args, model, optimizers, meta, is_best, rank, times):
    """The epoch's checkpoint in `--ckpt-backend`'s format (a directory
    beside a best copy, or rank 0's torch file), and `--save-reference-ckpt`'s
    reference-layout file beside it; returns the checkpoint's path.
    `times` gets the s spent on the checkpoint (`checkpoint_s`, a torch
    file's best copy included) and on a directory's best copy (`best_s`,
    None without one).  An orbax-async best copy drains the checkpoint's
    write first, as the JAX package's does: it blocks for a full write."""
    name = checkpoint_name(args.model_prefix, args.representation)
    t0 = time.perf_counter()
    times["best_s"] = None
    if args.ckpt_backend.startswith("orbax"):
        wait = args.ckpt_backend != "orbax-async"
        opts = dict(zip(("optimizer_cls", "optimizer_gf", "optimizer_d"),
                        optimizers))
        path = save_checkpoint_dcp(model, meta, name + ".orbax", opts,
                                   wait=wait)
        times["checkpoint_s"] = time.perf_counter() - t0
        if is_best:  # a best-model copy (reference train.py:375)
            t0 = time.perf_counter()
            save_checkpoint_dcp(model, meta, best_name(name) + ".orbax",
                                opts, wait=wait)
            times["best_s"] = time.perf_counter() - t0
    else:
        path = (save_checkpoint(model, meta, name, optimizers, is_best)
                if rank == 0 else name)
        times["checkpoint_s"] = time.perf_counter() - t0
    if args.save_reference_ckpt:
        state = None
        if (args.fsdp or (args.tp or 1) > 1) and world()[1] > 1:
            # every rank gathers its shards
            from dmcnet_tpu_torch.parallel.fsdp import gather_state

            state = gather_state(model)
        if rank == 0:
            ref = save_checkpoint(model, meta, name + ".ref.pth.tar",
                                  state_dict=state)
            print(f"reference-format checkpoint: {ref}")
    return path


def validate(val_asm, eval_step, batch_size, aug, tp=1):
    """Reference validate() (train.py:292-369): Prec@1 over the validation
    set, batch by batch; returns it.  Each data row scores its rows of each
    batch (the `tp` ranks of a row the same ones) and the sums are
    all-reduced, so Prec@1 and the loss are the global ones.  A rank with
    no row left in the ragged last batch scores the last row and counts it
    0 times: FSDP2's and the sharded layers' forwards need every rank."""
    n = len(val_asm.ds)
    rows = list(local_shard_indices(batch_size, tp))
    sums = [0.0, 0.0, 0.0]       # top1 x rows, loss x rows, rows
    for start in range(0, n, batch_size):
        stop = min(start + batch_size, n)
        idx = [start + j for j in rows if start + j < stop]
        m = eval_step(augment_eval_batch(
            val_asm.eval_batch(idx or [stop - 1]), **aug))
        sums[0] += m["top1"].item() * len(idx)
        sums[1] += m["loss"].item() * len(idx)
        sums[2] += len(idx)
    top1_sum, loss_sum, count = all_reduce_sum(sums)
    prec1, loss = top1_sum / count, loss_sum / count
    if world()[0] == 0:
        print(f"Testing Results: Prec@1 {prec1:.3f} Loss {loss:.5f}")
    return prec1


def main(argv=None, gan=False, input_size=224):
    """`gan` selects the dmcnet_GAN parser, whose `--arch_d` makes
    `train()` the dmcnet_GAN trainer; `input_size` defaults to the
    reference's fixed 224, and tests shrink it."""
    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_parser(gan=gan).parse_args(argv)
    if args.representation == "iframe":
        # an iframe group carries RGB in the mv slot: the generator, which
        # reads mv and residual, has no input (CoViAR trains the bare TSN)
        raise SystemExit("--representation iframe: the DMC generator has "
                         "no generator input in an iframe group; score a "
                         "CoViAR I-frame TSN with cli.test --plain 1")
    spawn = args.gpus and len(args.gpus) > 1 and \
        args.dist_num_processes is None
    n_proc = len(args.gpus) if spawn else (args.dist_num_processes or 1)
    check_parallel_flags(n_proc, args.batch_size, args.tp, args.fsdp,
                         args.ckpt_backend.startswith("orbax"))
    if spawn:
        return spawn_ranks(main, argv, args.gpus, gan=gan,
                           input_size=input_size)
    device = device_for(args)
    if device.type == "cuda" and args.dist_num_processes:
        if not args.gpus:  # rank r drives card r of its host
            device = torch.device(
                "cuda", (args.dist_process_id or 0)
                % torch.cuda.device_count())
        torch.cuda.set_device(device)
    initialize_distributed(args.dist_coordinator, args.dist_num_processes,
                           args.dist_process_id, device=device.type)
    try:
        if world()[0] == 0:
            print("Training arguments:")
            for k, v in sorted(vars(args).items()):
                print(f"\t{k}: {v}")
        train_ds, val_ds = make_datasets(args)
        return train(args, train_ds, val_ds, device=device,
                     input_size=input_size).best_prec1
    finally:
        shutdown()



if __name__ == "__main__":
    main(sys.argv[1:])
