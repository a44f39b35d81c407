"""Video-level testing command — the port's counterpart of
`dmcnet_tpu/cli/test.py`, flag-compatible with reference
code/dmcnet/test.py, plus `--device` (default `cuda`).

25 segments x 10 crops by default, scores averaged per video, and a
bit-compatible `.npz` score dump: `scores` is an object array of (score
(1, C) float array, label) pairs REORDERED by sorted video name (reference
test.py:183-198), plus `labels` and `names`, so the reference combine.py /
run_combine.sh consume it unchanged.  `--weights` takes the port's
checkpoint or a reference `.pth.tar`, a JAX package msgpack checkpoint or
a `--ckpt-backend orbax` step directory (a partial load, as in JAX);
`--plain 1` scores the bare TSN
backbone on the modality input (`models.tsn.PlainTSN`).  `--arch_d` scores
a GAN checkpoint with its discriminator, built for `--input_size`, and
prints the G adversarial accuracy: the share of generated cues the
discriminator rates real, over every video's segments x crops (reference
dmcnet_GAN test.py:158,184-192).  `--gpus` with several ids scores on
the first, as the JAX command ignores the flag.

`--pp N` (2 or 4) scores with the ResNet-18 backbone pipelined over N
stage devices (`parallel/pp_resnet.py`): the first N cards, or N stages on
the CPU with `--device cpu`; fewer visible cards raise.  The generator
runs on the first stage's device, and each video's segments x crops clips
stream through the stages in N microbatches, the clip batch padded by
wrapping its indices when N does not divide it.  With `--plain 1` the
modality clips are the pipeline's input.  `--viz 1` writes a Middlebury
picture of each video's first generated cue into `--viz-dir`
(`{index:05d}_{name}_gen_flow.png`, `utils/viz.py`).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

from dmcnet_tpu_torch.cli.common import (
    device_for,
    first_devices,
    num_classes_for,
    save_scores_npz,
)
from dmcnet_tpu_torch.data.dmc_dataset import (
    BatchAssembler,
    CoviarDataset,
    augment_eval_batch,
)
from dmcnet_tpu_torch.models.tsn import DMCNet, PlainTSN, segment_consensus
from dmcnet_tpu_torch.train.checkpoints import load_reference_weights


def build_parser():
    parser = argparse.ArgumentParser(
        description="Standard video-level testing")
    parser.add_argument('--data-name', type=str,
                        choices=['ucf101', 'hmdb51', 'kinetics400'])
    parser.add_argument('--representation', type=str,
                        choices=['iframe', 'residual', 'mv', 'flow'])
    parser.add_argument('--no-accumulation', action='store_true')
    parser.add_argument('--new_length', type=int, default=1)
    parser.add_argument('--use_databn', type=int, default=1,
                        help='kept for flag parity (the reference never '
                             'applies data_bn)')
    parser.add_argument('--flow_ds_factor', type=int, default=0)
    parser.add_argument('--upsample_interp', type=bool, default=False)
    parser.add_argument('--data-root', type=str)
    parser.add_argument('--flow-root', type=str)
    parser.add_argument('--data-flow', type=str, default='tvl1')
    parser.add_argument('--test-list', type=str)
    parser.add_argument('--weights', type=str,
                        help='a torch file, a JAX msgpack checkpoint or a '
                             '--ckpt-backend orbax directory')
    parser.add_argument('--batch-size', default=1, type=int,
                        help='kept for flag parity: videos are scored one '
                             'at a time, as the reference does')
    parser.add_argument('--arch', type=str)
    parser.add_argument('--arch_estimator', type=str, default="ContextNetwork")
    parser.add_argument('--arch_d', type=str, default=None,
                        help='GAN discriminator architecture: score its '
                             'adversarial accuracy too')
    parser.add_argument('--save-scores', type=str, default=None)
    parser.add_argument('--test_segments', type=int, default=25)
    parser.add_argument('--test-crops', type=int, default=10)
    parser.add_argument('--input_size', type=int, default=224)
    parser.add_argument('-j', '--workers', default=1, type=int,
                        help='kept for flag parity: videos are assembled '
                             'in order on the calling thread')
    parser.add_argument('--gpus', nargs='+', type=int, default=None,
                        help='card ids; the first selects cuda:<id>, the '
                             'others are accepted and ignored, as the JAX '
                             'command parses and never reads them')
    parser.add_argument('--device', type=str, default='cuda',
                        help='torch device to score on (cuda, cuda:N, cpu)')
    parser.add_argument('--gop', type=int, default=12)
    parser.add_argument('--viz', type=int, default=0,
                        help='write a Middlebury colour picture of each '
                             'video\'s generated cue (its first clip) '
                             'into --viz-dir')
    parser.add_argument('--viz-dir', type=str, default='./viz')
    parser.add_argument('--gen_flow_or_delta', type=int, default=0)
    parser.add_argument('--gen_flow_ds_factor', type=int, default=0)
    parser.add_argument('--att', type=int, default=0)
    parser.add_argument('--mv_minmaxnorm', type=int, default=0)
    parser.add_argument('--pp', type=int, default=0,
                        help='pipeline-parallel stages of the ResNet-18 '
                             'backbone (2 or 4): the scoring forward runs '
                             'over the first N cards (N CPU stages with '
                             '--device cpu), parallel/pp_resnet.py')
    parser.add_argument('--packed-gen', type=int, default=0,
                        help='space-to-depth factor for the dense DMC '
                             'estimators (exact reparameterization; same '
                             'checkpoints as the unpacked layout)')
    parser.add_argument('--plain', type=int, default=0,
                        help='plain CoViAR scoring: the backbone '
                             'classifies the modality input directly (no '
                             'DMC generator), for CoViAR-trained TSN '
                             '.pth.tar checkpoints (3-channel iframe / '
                             '2-channel mv / 3-channel residual conv1)')
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.plain and (args.att or args.arch_d or args.viz):
        raise SystemExit("--plain scores the bare TSN backbone (no "
                         "generator, no --att, no --arch_d, no --viz)")
    pp = args.pp > 1
    if pp:
        if args.arch != "resnet18":
            raise SystemExit("--pp currently supports --arch resnet18")
        if args.viz or args.arch_d or args.att:
            raise SystemExit("--pp composes with the plain scoring path "
                             "only (no --viz / --arch_d / --att)")
    device = device_for(args)
    stage_devices = None
    if pp:
        stage_devices = first_devices(args.pp, device, "--pp")
        device = torch.device(stage_devices[0])
    num_class = num_classes_for(args.data_name)

    ds = CoviarDataset(
        data_root=args.data_root, flow_root=args.flow_root,
        video_list=args.test_list, representation=args.representation,
        num_segments=args.test_segments, is_train=False,
        accumulate=(not args.no_accumulation), gop=args.gop,
        flow_ds_factor=args.flow_ds_factor,
        upsample_interp=args.upsample_interp,
        mv_minmaxnorm=args.mv_minmaxnorm, flow_folder=args.data_flow,
        new_length=args.new_length)
    asm = BatchAssembler(ds, input_size=args.input_size,
                         scale_size=args.input_size * 256 // 224,
                         test_crops=args.test_crops)
    aug = dict(representation=args.representation,
               flow_ds_factor=args.flow_ds_factor,
               upsample_interp=args.upsample_interp,
               input_size=args.input_size, device=device)

    # the normalize_group slot carrying the modality: iframe rides in 'mv'
    # (the reference reuses the variable, dataset.py:204-211)
    plain_key = "residual" if args.representation == "residual" else "mv"
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        if args.plain:
            # iframe and residual carry 3 channels, mv and flow 2
            channels = 3 if args.representation in ("iframe", "residual") \
                else 2
            net = PlainTSN(num_class, arch=args.arch, in_channels=channels)
        else:
            net = DMCNet(num_class, num_segments=args.test_segments,
                         arch=args.arch, arch_estimator=args.arch_estimator,
                         gen_flow_or_delta=args.gen_flow_or_delta,
                         gen_flow_ds_factor=args.gen_flow_ds_factor,
                         att=args.att, arch_d=args.arch_d,
                         input_size=args.input_size,
                         packed_gen=args.packed_gen)
    if args.weights:
        skipped, missing = load_reference_weights(net, args.weights)
        print(f"loaded weights {args.weights} (skipped {len(skipped)}, "
              f"missing {len(missing)})")
    net.to(device).eval()

    total_seg = args.test_segments * args.test_crops
    if pp:
        from dmcnet_tpu_torch.parallel import (
            make_pp_resnet18,
            make_stage_mesh,
        )

        pp_classify = make_pp_resnet18(net.base_model,
                                       make_stage_mesh(stage_devices),
                                       n_microbatches=args.pp)
    if args.viz:
        from dmcnet_tpu_torch.utils.viz import viz_flow, write_png

        os.makedirs(args.viz_dir, exist_ok=True)

    def forward_video(batch):
        """-> (video scores (1, C), validity or None, first clip's cue or
        None)."""
        validity = gen0 = None
        if pp:
            if args.plain:   # the modality clips are the pipeline's input
                x = batch[plain_key]
                gen = x.reshape((-1,) + tuple(x.shape[-3:]))
            else:
                gen = net.generate(batch["mv"], batch["residual"])
            n = gen.shape[0]
            pad = (-n) % args.pp
            if pad:  # the microbatch count must divide the clip batch;
                # wrapping the indices pads fully even when n < pad
                gen = gen[torch.arange(n + pad, device=gen.device) % n]
            logits = pp_classify(gen)[:n]
        elif args.plain:
            logits = net(batch[plain_key])
        else:
            outs = net(batch["mv"], batch["residual"])
            logits = outs[0]
            if args.arch_d:
                validity = outs[2]
            if args.viz:
                gen0 = outs[1][0]
        return segment_consensus(logits, total_seg), validity, gen0

    output, video_labels = [], []
    g_adv_real, g_adv_rows = 0, 0
    proc_start_time = time.time()
    for i in range(len(ds)):
        batch = augment_eval_batch(asm.eval_batch([i]), **aug)
        with torch.no_grad():
            consensus, validity, gen0 = forward_video(batch)
            scores = consensus.cpu().numpy()
        if validity is not None:
            g_adv_real += int((validity.argmax(-1) == 1).sum())
            g_adv_rows += validity.shape[0]
        if gen0 is not None:
            # the reference renders flow pictures with --viz (test.py:117)
            g = gen0.float().cpu().numpy()    # (2, H, W)
            img = (viz_flow(g[0], g[1]) * 255).astype(np.uint8)
            name = os.path.splitext(os.path.basename(ds.items[i].path))[0]
            write_png(f"{args.viz_dir}/{i:05d}_{name}_gen_flow.png", img)
        label = int(batch["label"][0])
        output.append((scores, label))
        video_labels.append(label)
        if (i + 1) % 100 == 0:
            cnt_time = time.time() - proc_start_time
            print(f"video {i} done, total {i + 1}/{len(ds)}, "
                  f"average {cnt_time / (i + 1)} sec/video")

    video_pred = [np.argmax(x[0]) for x in output]
    acc = float(np.mean(np.asarray(video_pred) == np.asarray(video_labels)))
    print(f"Accuracy {acc * 100:.02f}% ({len(video_pred)})")
    if g_adv_rows:
        print(f"G adversarial accuracy "
              f"{100.0 * g_adv_real / g_adv_rows:.02f}%")

    if args.save_scores is not None:
        with open(args.test_list) as f:
            name_list = [x.strip().split()[0] for x in f]
        save_scores_npz(args.save_scores, output, video_labels, name_list)
    return acc


if __name__ == "__main__":
    main(sys.argv[1:])
