"""The bottleneck ResNets (ResNet-50/101/152) as TSN backbones of the port,
held on the CPU to the benchmark's plain reference of CoViAR's I-frame
scoring (`benchmark/reference/coviar.py`, plain torch, importing nothing of
the port), at published widths and depths on small inputs:

  * `PlainTSN` against the reference network, on the reference's seeded
    and calibrated weights;
  * parameter counts against torchvision's;
  * a CoViAR checkpoint, torchvision's key names under `module.base_model.`,
    loaded through `load_reference_weights` with nothing skipped;
  * `cli.test --plain 1 --representation iframe --arch resnet152` end to
    end on a two-video list against the reference's scores;
  * the dmcnet trainer's own constructors stepping a ResNet-152 classifier,
    and `cli.train` refusing the iframe representation, which has no
    generator input;
  * ResNet-18/34 as they were: outputs of the seeded initialisation in
    float64, recorded before the bottleneck block was added.
"""

import copy
import json
import os

import numpy as np
import pytest
import torch

from benchmark import weights
from benchmark.reference import coviar as ref
from dmcnet_tpu_torch.models.tsn import PlainTSN

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEPTHS = {"resnet50": (3, 4, 6, 3), "resnet101": (3, 4, 23, 3),
          "resnet152": (3, 8, 36, 3)}
SIZE, H, W = 64, 72, 96
# Port and reference run the same float32 convolutions and BatchNorms on
# the CPU, in the same order: what differs is summation order inside
# torch's kernels, which the 50 blocks (residual_gain 0.2) carry to a few
# 1e-6 of the largest logit.
NET_TOL = 1e-5
# End to end the port's one-pass crop resampler (triangle weights of
# `jax.image.scale_and_translate`) meets the reference's bilinear resize
# then crop, within 1e-6 a pixel: 1e-4 of the largest score.
SCORE_TOL = 1e-4


@pytest.fixture(autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def config(arch="resnet152"):
    with open(os.path.join(ROOT, "benchmark", "configs",
                           "coviar_iframe_r152.json")) as f:
        cfg = json.load(f)
    return dict(cfg, arch=arch, stage_sizes=list(DEPTHS[arch]),
                input_size=SIZE, scale_size=SIZE * 256 // 224,
                frame={"height": H, "width": W, "channels": 8})


def canvas(seed, segments=1):
    """A u8 iframe group canvas (S, H, W, 8)."""
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, 256, (segments, H, W, 8), generator=g,
                         dtype=torch.uint8)


def calibrated_state(cfg, seed=5):
    sd = weights.make_state(ref.shapes(cfg), seed, "cpu")
    ref.calibrate(sd, cfg, canvas(seed + 1))
    return sd


def rel_gap(got, want):
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("arch", sorted(DEPTHS))
def test_plain_tsn_matches_the_reference(arch):
    cfg = config(arch)
    sd = calibrated_state(cfg)
    net = PlainTSN(cfg["num_class"], arch=arch, in_channels=3)
    net.load_state_dict(sd)
    x = ref.oversample(canvas(9), cfg)[[0, 3]]    # 2 clips, one mirrored
    with torch.no_grad():
        got = net.eval()(x)
        want = ref.resnet(sd, cfg, x)
    assert got.shape == (2, cfg["num_class"])
    assert rel_gap(got, want) < NET_TOL
    assert rel_gap(got[1], got[0]) > 1e-2, "the two clips' logits differ"


@pytest.mark.parametrize("arch, classes, count", [
    ("resnet50", 1000, 25_557_032), ("resnet101", 1000, 44_549_160),
    ("resnet152", 1000, 60_192_808), ("resnet152", 51, 58_248_307)])
def test_parameter_counts_are_torchvisions(arch, classes, count):
    with torch.device("meta"):
        net = PlainTSN(classes, arch=arch, in_channels=3)
    assert sum(p.numel() for p in net.parameters()) == count


def test_a_coviar_checkpoint_loads_whole(tmp_path):
    """torchvision's key names under CoViAR's `module.base_model.` (its
    DataParallel `Model`), with a 51-class `fc`."""
    from dmcnet_tpu_torch.train.checkpoints import load_reference_weights

    cfg = config()
    sd = calibrated_state(cfg)
    path = str(tmp_path / "iframe_checkpoint.pth.tar")
    torch.save({"epoch": 1, "arch": "resnet152",
                "state_dict": {"module." + k: v for k, v in sd.items()}},
               path)
    net = PlainTSN(cfg["num_class"], arch="resnet152", in_channels=3)
    assert load_reference_weights(net, path) == ([], [])
    own = net.state_dict()
    assert own.keys() == sd.keys()
    assert all(torch.equal(own[k], sd[k]) for k in sd)


def _corpus(root, n=2, frames=14):
    from dmcnet_tpu_torch.codec.mpeg4 import encode_mpeg4

    os.makedirs(root / "videos" / "cls")
    rng = np.random.default_rng(21)
    lines = []
    for v in range(n):
        clip = (rng.integers(0, 256, size=(frames, H, W, 3)) // 4 * 4) \
            .astype(np.uint8)
        encode_mpeg4(str(root / "videos" / "cls" / f"v{v}.mp4"), clip,
                     gop_size=12, bit_rate=1_000_000)
        lines.append(f"cls/v{v}.avi 0 {v}")
    (root / "test.txt").write_text("\n".join(lines) + "\n")


def test_test_cli_scores_the_iframe_stream(tmp_path):
    """`cli.test --plain 1 --representation iframe --arch resnet152`, 2
    segments x 10 crops at 64x64, against the reference on the canvases
    the command's own dataset decodes; the mirrored crops keep their
    colours (only flow x is negated in an iframe group)."""
    from dmcnet_tpu_torch.cli import test as test_cli
    from dmcnet_tpu_torch.data.dmc_dataset import CoviarDataset

    _corpus(tmp_path)
    cfg = config()
    ds = CoviarDataset(data_root=str(tmp_path / "videos"), flow_root=None,
                       video_list=str(tmp_path / "test.txt"),
                       representation="iframe", num_segments=2,
                       is_train=False)
    canvases = [torch.as_tensor(ds[i][0]) for i in range(len(ds))]
    sd = weights.make_state(ref.shapes(cfg), 8, "cpu")
    ref.calibrate(sd, cfg, canvases[0])
    path = str(tmp_path / "iframe.pth.tar")
    torch.save({"epoch": 1, "arch": "resnet152", "state_dict": sd}, path)
    scores = str(tmp_path / "scores")
    test_cli.main(["--data-name", "hmdb51", "--representation", "iframe",
                   "--arch", "resnet152", "--plain", "1", "--data-root",
                   str(tmp_path / "videos"), "--test-list",
                   str(tmp_path / "test.txt"), "--weights", path,
                   "--test_segments", "2", "--test-crops", "10",
                   "--input_size", str(SIZE), "--device", "cpu",
                   "--save-scores", scores])
    with np.load(scores + ".npz", allow_pickle=True) as data:
        got = np.stack([s[0][0] for s in data["scores"]])
        assert list(data["names"]) == ["cls/v0.avi", "cls/v1.avi"]
    with torch.no_grad():
        want = torch.stack([ref.video_score(sd, cfg, c) for c in canvases])
    assert got.shape == (2, cfg["num_class"])
    assert rel_gap(torch.as_tensor(got, dtype=torch.float32), want) \
        < SCORE_TOL
    assert rel_gap(want[1], want[0]) > 1e-3, "the videos' scores differ"


def test_the_trainer_steps_a_resnet152_classifier():
    """`cli.train`'s own model and optimizer constructors with `--arch
    resnet152`: one step of the training phase moves the classifier."""
    import types

    from dmcnet_tpu_torch.cli.train import build_model
    from dmcnet_tpu_torch.train.engine import make_train_step
    from dmcnet_tpu_torch.train.optimizers import (
        adjust_learning_rate,
        make_optimizers,
    )

    args = types.SimpleNamespace(
        num_segments=1, arch="resnet152", arch_estimator="DenseNetTiny",
        gen_flow_or_delta=1, gen_flow_ds_factor=0, att=0, packed_gen=0)
    model = build_model(args, 51, input_size=SIZE)
    opts = make_optimizers(model, 1.0, 1.0)
    adjust_learning_rate(opts, 1e-3, 0.0)
    step = make_train_step(model, *opts, num_segments=1, lr_cls_w=1.0,
                           lr_mse_w=1.0)
    g = torch.Generator().manual_seed(3)
    batch = {k: torch.randn(2, 1, c, SIZE, SIZE, generator=g)
             for k, c in (("mv", 2), ("residual", 3), ("flow", 2))}
    batch["label"] = torch.tensor([1, 7])
    before = copy.deepcopy(model.base_model.layer4[2].conv3.weight.detach())
    m = step(batch, True)
    assert torch.isfinite(m["loss"])
    assert not torch.equal(model.base_model.layer4[2].conv3.weight, before)


def test_the_trainer_refuses_the_iframe_representation():
    from dmcnet_tpu_torch.cli import train

    with pytest.raises(SystemExit, match="no generator input"):
        train.main(["--representation", "iframe", "--arch", "resnet152",
                    "--device", "cpu"])


# float64 logits of `resnetNN(51, in_channels=2)` initialised under
# torch.manual_seed(0), in eval mode, on randn (2, 2, 64, 64) of a
# generator seeded 1: (the first 4 logits of each row, sum of |logits|),
# recorded from the BasicBlock-only module.
UNCHANGED = {
    "resnet18": ([-0.108713087334, 0.392745019121, 2.100328876429,
                  0.179618109377, -0.094192785637, 0.285442876044,
                  2.029864762863, 0.24204478067], 71.74825083601814, 122),
    "resnet34": ([-0.194000787496, 7.080979763123, 14.422902641398,
                  -1.140073824911, 0.209150284, 7.17729014427,
                  14.715602617495, -1.879175874063], 875.2332191648898, 218),
}


@pytest.mark.parametrize("arch", sorted(UNCHANGED))
def test_basic_block_resnets_are_unchanged(arch):
    from dmcnet_tpu_torch.models import resnet

    torch.manual_seed(0)
    net = getattr(resnet, arch)(51, in_channels=2).double().eval()
    x = torch.randn(2, 2, 64, 64, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        y = net(x)
    first, total, n_keys = UNCHANGED[arch]
    assert len(net.state_dict()) == n_keys
    assert all(type(b) is resnet.BasicBlock for b in net.layer1)
    np.testing.assert_allclose(y[:, :4].flatten().numpy(), first,
                               rtol=1e-9, atol=1e-11)
    assert float(y.abs().sum()) == pytest.approx(total, rel=1e-10)
