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
    float64, recorded before the bottleneck block was added;
  * the inference route (eval mode, grad off, float32, no autocast):
    each convolution then one `ops.bn_epilogue` pass, against the modules
    run one by one, a block at each kind of shortcut and a whole
    ResNet-50; training, grad-enabled, bf16-autocast and float64 forwards
    take no epilogue and are bit-identical to the modules' forward;
    `epilogue_ms.test` on a hand-built trace;
  * on a card (`cuda`): the cell's ResNet-152 forward (250 clips at
    224x224) with its 151 launches recorded, the kernel against its plain
    version at each distinct shape and residual mode of them (the checks
    of `chip_smoke.py`'s epilogue phase); the route against the modules;
    a ResNet-50 under bf16 autocast, which runs the modules.
"""

import contextlib
import copy
import json
import os
import time

import numpy as np
import pytest
import torch

from benchmark import harness, weights
from benchmark.reference import coviar as ref
from benchmark.reference.precision import strict_fp32
from benchmark.tracing import Trace
from chip_smoke import epilogue_calls, epilogue_check
from dmcnet_tpu_torch.models import resnet
from dmcnet_tpu_torch.models.tsn import PlainTSN
from dmcnet_tpu_torch.ops import bn_epilogue as epi
from dmcnet_tpu_torch.utils.profiling import read_spans

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


def cell_config():
    with open(os.path.join(ROOT, "benchmark", "configs",
                           "coviar_iframe_r152.json")) as f:
        return json.load(f)


def config(arch="resnet152"):
    return dict(cell_config(), arch=arch, stage_sizes=list(DEPTHS[arch]),
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


# -- the inference epilogue route ---------------------------------------

def perturbed_bns(net, seed):
    """Every BatchNorm of `net` given weights, biases and running
    statistics away from their initial values."""
    g = torch.Generator().manual_seed(seed)
    for m in net.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            c = m.num_features
            m.weight.data = 0.5 + torch.rand(c, generator=g)
            m.bias.data = 0.1 * torch.randn(c, generator=g)
            m.running_mean.copy_(0.1 * torch.randn(c, generator=g))
            m.running_var.copy_(0.5 + 1.5 * torch.rand(c, generator=g))
    return net


def modes(calls):
    """The residual mode of each recorded epilogue call (0 none, 1 the
    identity, 2 BN'd)."""
    return [mode for _, _, mode, _, _ in calls]


def profiled(fn):
    """-> (fn's result, the `fused` count of each `resnet.layer*` span)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]):
        t0 = time.time_ns()
        out = fn()
        t1 = time.time_ns()
    return out, [e["counts"]["fused"] for e in read_spans(t0, t1)
                 if e["name"].startswith("resnet.layer")]


@pytest.mark.parametrize("c_in, features, stride", [
    (64, 16, 1), (32, 16, 1), (32, 16, 2)],
    ids=["identity", "downsample", "downsample-stride2"])
def test_a_bottleneck_takes_the_epilogue_in_inference(c_in, features,
                                                      stride):
    """One block at each kind of shortcut: its eval forward under no_grad
    (three epilogue passes, the downsample's BN in the last) against its
    modules run one by one, within 1e-5 of the largest output."""
    torch.manual_seed(3)
    block = perturbed_bns(resnet.Bottleneck(c_in, features, stride), 4)
    block.eval()
    assert (block.downsample is None) == (c_in == 4 * features)
    x = torch.relu(torch.randn(2, c_in, 12, 12,
                               generator=torch.Generator().manual_seed(5)))
    with torch.no_grad():
        got, calls = epilogue_calls(lambda: block(x))
    assert modes(calls) == [0, 0, 1 if block.downsample is None else 2]
    want, calls = epilogue_calls(lambda: block(x).detach())  # the modules
    assert calls == []
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert got.shape == want.shape == (2, 4 * features, 12 // stride,
                                       12 // stride)
    assert rel_gap(got, want) < 1e-5
    assert (got == 0).any() and (got > 0).any()


def test_a_resnet50_takes_the_epilogue_in_inference():
    """A whole ResNet-50 with calibrated weights and running statistics on
    a few 64x64 clips: the epilogue route (the stem and 3 passes a block,
    every stage's blocks `fused`) against the modules, within 1e-5 of the
    largest logit."""
    cfg = config("resnet50")
    net = PlainTSN(cfg["num_class"], arch="resnet50", in_channels=3)
    net.load_state_dict(calibrated_state(cfg))
    net.eval()
    x = ref.oversample(canvas(9), cfg)[[0, 3, 6]]
    with torch.no_grad():
        (got, fused), calls = epilogue_calls(lambda: profiled(lambda: net(x)))
    assert fused == [3, 4, 6, 3]
    assert len(calls) == 1 + 3 * 16 and modes(calls).count(2) == 4
    want, calls = epilogue_calls(lambda: net(x).detach())
    assert calls == []
    assert rel_gap(got, want) < 1e-5
    assert rel_gap(got[1], got[0]) > 1e-2, "the clips' logits differ"


def modules_forward(net, x):
    """The bottleneck ResNet's forward with every module called by name,
    as it ran before the epilogue route."""
    def block(b, x):
        identity = x if b.downsample is None else b.downsample(x)
        y = b.relu(b.bn1(b.conv1(x)))
        y = b.relu(b.bn2(b.conv2(y)))
        return b.relu(b.bn3(b.conv3(y)) + identity)

    x = net.maxpool(net.relu(net.bn1(net.conv1(x))))
    for stage in range(net.n_stages):
        for b in getattr(net, f"layer{stage + 1}"):
            x = block(b, x)
    return net.fc(net.avgpool(x).flatten(1))


@pytest.mark.parametrize("mode", ["train", "eval-with-grad",
                                  "eval-bf16-autocast", "eval-float64"])
def test_forwards_outside_the_epilogue_run_the_modules(mode):
    """In training mode, with grad on, under bf16 autocast (`cli.train
    --bf16 1`'s evaluation) or in float64, no block is `fused` and no
    epilogue runs: logits, and in training the running statistics, are
    bit-identical to the modules called one by one."""
    torch.manual_seed(0)
    net = perturbed_bns(resnet.resnet50(51, in_channels=3), 6)
    net.train(mode == "train")
    x = torch.randn(3, 3, 64, 64, generator=torch.Generator().manual_seed(7))
    if mode == "eval-float64":
        net, x = net.double(), x.double()
    twin = copy.deepcopy(net)
    grad = mode in ("train", "eval-with-grad")
    autocast = torch.autocast("cpu", dtype=torch.bfloat16) \
        if mode == "eval-bf16-autocast" else contextlib.nullcontext()
    with torch.set_grad_enabled(grad), autocast:
        (got, fused), calls = epilogue_calls(lambda: profiled(lambda: net(x)))
        want = modules_forward(twin, x)
    assert fused == [0, 0, 0, 0] and calls == []
    assert got.requires_grad == grad
    assert got.dtype == {"eval-bf16-autocast": torch.bfloat16,
                         "eval-float64": torch.float64}.get(mode,
                                                            torch.float32)
    assert torch.equal(got, want)
    for a, b in zip(net.state_dict().values(), twin.state_dict().values()):
        assert torch.equal(a, b)


@pytest.mark.parametrize("mode, relu", [(m, r) for m in range(3)
                                        for r in (True, False)])
def test_the_plain_epilogue_is_the_batchnorm_add_and_relu(mode, relu):
    """`bn_epilogue` on CPU tensors (its plain version) against the
    BatchNorm modules, the add and ReLU, within 1e-6 of the largest value;
    in place, with `launches` not counted (no kernel ran); refused with
    grad on."""
    import torch.nn.functional as F

    g = torch.Generator().manual_seed(mode)
    bns = [perturbed_bns(torch.nn.BatchNorm2d(8), 11 + i).eval()
           for i in range(2)]
    y = torch.randn(2, 8, 5, 6, generator=g) \
        .contiguous(memory_format=torch.channels_last)
    r = torch.randn(2, 8, 5, 6, generator=g)
    with torch.no_grad():
        want = bns[0](y)
        if mode:
            want = want + (r if mode == 1 else bns[1](r))
        if relu:
            want = F.relu(want)
        before = epi.bn_epilogue.launches
        got = epi.bn_epilogue(y, bns[0], r if mode else None,
                              bns[1] if mode == 2 else None, relu)
    assert got is y and epi.bn_epilogue.launches == before
    assert rel_gap(got, want) < 1e-6
    with pytest.raises(RuntimeError, match="grad off"):
        epi.bn_epilogue(y, bns[0])


def test_epilogue_ms_reads_the_kernel_per_video():
    """`epilogue_ms.test` on a hand-built trace: the device time of the
    `bn_epilogue_kernel` launches per video, and None without them (the
    parent's program) or without a trace."""
    read = harness.load_reader("epilogue_ms.test")
    k = "void (anonymous namespace)::bn_epilogue_kernel<2, true>(float4*)"
    device = [(k, "kernel", 100, 400), (k, "kernel", 500, 600),
              ("sm90_xmma_fprop_implicit_gemm", "kernel", 400, 500),
              (k, "kernel", 2_000, 3_000)]         # outside the window
    run = harness.Run(Trace(device, [], (0, 1_000)), 1e-6, {"videos": 2})
    assert read(run) == pytest.approx(400 * 1e-6 / 2)
    run.trace = Trace(device[2:3], [], (0, 1_000))
    assert read(run) is None
    run.trace = None
    assert read(run) is None


# -- on a card ------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_the_epilogue_kernel_matches_its_plain_version():
    """The cell's ResNet-152 forward on the card (its configuration, 25
    segments x 10 crops at 224x224, seeded weights calibrated as its set-up
    does): 1 stem + 3 a block x 50 launches, counted from 0, at every
    width of the network and in each residual mode; the kernel within 1e-6
    of the largest value of its plain version at each distinct shape and
    residual mode of them, with and without ReLU, on the forward's own
    BatchNorms."""
    dev = _card()
    cfg = cell_config()
    g = cfg["frame"]
    frames = torch.randint(0, 256, (25, g["height"], g["width"],
                                    g["channels"]), dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(9))
    frames = frames.to(dev)
    sd = weights.make_state(ref.shapes(cfg), 5, dev)
    with strict_fp32():
        ref.calibrate(sd, cfg, frames)
    net = PlainTSN(cfg["num_class"], arch="resnet152", in_channels=3)
    net.load_state_dict(sd)
    net = net.to(dev).eval()
    with torch.no_grad():
        logits, calls = epilogue_calls(
            lambda: net(ref.oversample(frames, cfg)))
    torch.cuda.synchronize()
    assert epi.bn_epilogue.launches == len(calls) == 151
    assert logits.shape == (250, cfg["num_class"])
    assert bool(torch.isfinite(logits).all())
    assert {shape[1] for shape, *_ in calls} == {64, 128, 256, 512, 1024,
                                                 2048}
    assert sorted(set(modes(calls))) == [0, 1, 2]
    assert all(shape[0] == 250 for shape, *_ in calls)
    worst, _, cases = epilogue_check(torch, calls)
    assert cases >= 2 * 6
    assert worst <= 1e-6


@pytest.mark.cuda
def test_the_resnet152_route_matches_its_modules_on_a_card():
    """One ResNet-152 forward on the card, logits within 1e-4 of the
    largest against the modules run one by one (grad on), TF32 off on both
    sides: cuDNN picks other algorithms for the two layouts, which sum in
    other orders."""
    dev = _card()
    cfg = config()
    sd = weights.make_state(ref.shapes(cfg), 5, dev)
    with strict_fp32():
        ref.calibrate(sd, cfg, canvas(6).to(dev))
        net = PlainTSN(cfg["num_class"], arch="resnet152", in_channels=3)
        net.load_state_dict(sd)
        net = net.to(dev).eval()
        x = ref.oversample(canvas(9).to(dev), cfg)
        with torch.no_grad():
            got, calls = epilogue_calls(lambda: net(x))
        assert epi.bn_epilogue.launches == len(calls) == 151
        want, calls = epilogue_calls(lambda: net(x).detach())
        assert epi.bn_epilogue.launches == 0 and calls == []
    assert rel_gap(got, want) < 1e-4


@pytest.mark.cuda
def test_a_resnet50_under_bf16_autocast_runs_the_modules_on_a_card():
    """`cli.train --bf16 1`'s evaluation on the card: a ResNet-50 in eval
    mode under no_grad and bf16 autocast launches no epilogue, its bf16
    convolutions' outputs going through the modules, and its logits equal
    the modules' forward."""
    dev = _card()
    torch.manual_seed(0)
    net = perturbed_bns(resnet.resnet50(51, in_channels=3), 6)
    net = net.to(dev).eval()
    x = torch.randn(3, 3, 64, 64,
                    generator=torch.Generator().manual_seed(7)).to(dev)
    with torch.no_grad(), torch.autocast("cuda", dtype=torch.bfloat16):
        got, calls = epilogue_calls(lambda: net(x))
        want = modules_forward(net, x)
    assert calls == [] and epi.bn_epilogue.launches == 0
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want)
