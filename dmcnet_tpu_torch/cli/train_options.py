"""Training options — the port's copy of `dmcnet_tpu/cli/train_options.py`,
flag-compatible with reference code/dmcnet/train_options.py:12-91 and,
with `gan`, the dmcnet_GAN additions (train_options.py:37-38,74-77,88),
plus `--device`.  `cli/train.py`'s docstring says what the parallel
flags (`--gpus`, `--dist-*`, `--fsdp`, `--tp`) and `--profile-dir` do.
"""

import argparse


def build_parser(gan=False):
    parser = argparse.ArgumentParser(description="CoViAR")

    # Data.
    parser.add_argument('--data-name', type=str,
                        choices=['ucf101', 'hmdb51', 'kinetics400'],
                        help='dataset name.')
    parser.add_argument('--data-root', type=str,
                        help='root of data directory.')
    parser.add_argument('--flow-root', type=str,
                        help='directory of pre-extracted optical flow images.')
    parser.add_argument('--data-flow', type=str, default='tvl1',
                        help='flow folder flavour (tvl1 | PWC*).')
    parser.add_argument('--train-list', type=str,
                        help='training example list.')
    parser.add_argument('--test-list', type=str,
                        help='testing example list.')
    parser.add_argument('--gop', type=int, default=12, help='size of GOP.')

    # Model.
    parser.add_argument('--representation', type=str,
                        choices=['iframe', 'mv', 'residual', 'flow'],
                        help='data representation.')
    parser.add_argument('--arch', type=str, default="resnet152",
                        help='base architecture.')
    parser.add_argument('--arch_estimator', type=str, default="ContextNetwork",
                        help='estimator architecture.')
    if gan:
        parser.add_argument('--arch_d', type=str, default="Discriminator",
                            help='discriminator architecture.')
    parser.add_argument('--num_segments', type=int, default=3,
                        help='number of TSN segments.')
    parser.add_argument('--no-accumulation', action='store_true',
                        help='disable accumulation of motion vectors.')
    parser.add_argument('--new_length', type=int, default=1,
                        help='number of MV/OF stacked together.')
    parser.add_argument('--flow_ds_factor', type=int, default=0,
                        help='flow downsample factor.')
    parser.add_argument('--gen_flow_ds_factor', type=int, default=0,
                        help='downsample factor for generated flow.')
    parser.add_argument('--upsample_interp', type=bool, default=False,
                        help='upsample via interpolation or not.')
    parser.add_argument('--use_databn', type=int, default=1,
                        help='add data batchnorm (kept for flag parity: the '
                             'reference builds data_bn but never applies it).')
    parser.add_argument('--gen_flow_or_delta', type=int, default=0,
                        help='0: generate flow; 1: generate flow delta.')
    parser.add_argument('--att', type=int, default=0,
                        help='0: no attention; 1: pixel-level attention.')
    parser.add_argument('--mv_minmaxnorm', type=int, default=1 if gan else 0,
                        help='min-max normalize mv values.')

    # Training.
    parser.add_argument('--weights', default=None, type=str)
    parser.add_argument('--resume', default=None, type=str,
                        help='a checkpoint to continue: the port\'s torch '
                             'file, a JAX package msgpack file, or a '
                             '--ckpt-backend orbax directory.')
    parser.add_argument('--epochs', default=500, type=int,
                        help='number of training epochs.')
    parser.add_argument('--epoch-thre', default=500, type=int,
                        help='freeze-phase threshold epoch.')
    parser.add_argument('--batch-size', default=40, type=int,
                        help='batch size.')
    parser.add_argument('--lr', default=0.001, type=float,
                        help='base learning rate.')
    parser.add_argument('--lr-cls', default=1, type=float,
                        help='cls loss weight.')
    parser.add_argument('--loss-mse', default='MSELoss', type=str)
    parser.add_argument('--lr-mse', default=0.1, type=float,
                        help='mse loss weight.')
    if gan:
        parser.add_argument('--lr-adv-g', default=1, type=float,
                            help='adversarial G loss weight.')
        parser.add_argument('--lr-adv-d', default=1, type=float,
                            help='adversarial D loss weight.')
        parser.add_argument('--lr_d_mult', default=0.01, type=float,
                            help='discriminator lr multiplier.')
    parser.add_argument('--lr_cls_mult', default=0.01, type=float,
                        help='cls learning multiplier.')
    parser.add_argument('--lr_mse_mult', default=0.01, type=float,
                        help='mse learning multiplier.')
    parser.add_argument('--lr-steps', default=[200, 300, 400], type=float,
                        nargs="+", help='epochs to decay learning rate.')
    parser.add_argument('--lr-decay', default=0.1, type=float,
                        help='lr decay factor.')
    parser.add_argument('--weight-decay', '--wd', default=1e-4, type=float,
                        help='weight decay.')

    # Log.
    parser.add_argument('--eval-freq', default=5, type=int,
                        help='evaluation frequency (epochs).')
    parser.add_argument('--workers', default=8, type=int,
                        help='number of batch-assembly threads.')
    parser.add_argument('--model-prefix', type=str, default="model",
                        help="prefix of model name.")
    parser.add_argument('--gpus', nargs='+', type=int, default=None,
                        help='card ids; one id selects cuda:<id>, several '
                             'start one data-parallel process per id on '
                             'this host (with --device cpu, gloo processes '
                             'on the CPU).')
    parser.add_argument('--device', type=str, default='cuda',
                        help='torch device to train on (cuda, cuda:N, cpu).')
    parser.add_argument('--dist-coordinator', type=str, default=None,
                        help='host:port of rank 0 for multi-process '
                             'training (torch.distributed, tcp://); needs '
                             '--dist-num-processes and --dist-process-id.')
    parser.add_argument('--dist-num-processes', type=int, default=None,
                        help='number of training processes (ranks).')
    parser.add_argument('--dist-process-id', type=int, default=None,
                        help='this process\'s rank.')
    parser.add_argument('--metrics-jsonl', type=str, default=None,
                        help='append one JSON object per train/eval log '
                             'event (machine-readable twin of the stdout '
                             'lines).')
    parser.add_argument('--auto-resume', type=int, default=0,
                        help='preemption-safe restart: resume from this '
                             "run's own checkpoint if it exists (no-op on "
                             'a fresh run; --resume takes precedence).')
    parser.add_argument('--ckpt-backend', type=str, default='msgpack',
                        choices=['msgpack', 'orbax', 'orbax-async'],
                        help='msgpack (the default) writes the torch '
                             '.pth.tar checkpoint with the reference naming; '
                             'orbax writes step directories <name>.orbax/'
                             '<epoch>/ through torch.distributed.checkpoint '
                             '(each rank its shards), orbax-async the same '
                             'in the background.')
    parser.add_argument('--bf16', type=int, default=0,
                        help='mixed-precision training: convolutions and '
                             'matmuls in bfloat16 (torch.autocast), params, '
                             'BN statistics and losses in float32 (the '
                             'reference is float32 only).')
    parser.add_argument('--packed-gen', type=int, default=0,
                        help='space-to-depth factor (e.g. 2) for the dense '
                             'DMC estimators: an exact packed '
                             'reparameterization of the same parameters; '
                             'checkpoints stay interchangeable with the '
                             'unpacked layout.  0 = faithful layout.')
    parser.add_argument('--fsdp', type=int, default=0,
                        help='shard parameters and optimizer moments over '
                             'the processes (FSDP2); across processes it '
                             'needs --ckpt-backend orbax.')
    parser.add_argument('--tp', type=int, default=0,
                        help='tensor parallelism degree: every large '
                             'convolution and linear layer sharded on its '
                             'output channels over this many adjacent '
                             'processes (it must divide their number; the '
                             'batch splits over the rest); across '
                             'processes it needs --ckpt-backend orbax.')
    parser.add_argument('--profile-dir', type=str, default=None,
                        help='write a torch.profiler Chrome trace of '
                             'training steps 2-7 of the first epoch '
                             'here.')
    parser.add_argument('--gop-cache-mb', type=int, default=128,
                        help='host GOP-decode LRU cache budget in MB '
                             '(per dataset).')
    parser.add_argument('--reader-cache', type=int, default=32,
                        help='max simultaneously open video readers '
                             '(LRU).')
    parser.add_argument('--save-reference-ckpt', type=int, default=0,
                        help='additionally write each saved checkpoint in '
                             'the reference layout alone ({epoch, arch, '
                             'state_dict, best_prec1}, reference '
                             'train.py:372-377) as <name>.ref.pth.tar.')
    return parser
