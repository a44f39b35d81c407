"""The port's pipeline parallelism (`parallel/pipeline.py`,
`parallel/pp_resnet.py`, `cli/test.py --pp`) against the JAX package, and
against its own serial model in float64.

JAX runs on the 8 host CPU devices of tests/conftest.py; the port's stages
all lie on the CPU (a device may repeat in its grid).  Four JAX pipeline
programs are compiled, once each: the homogeneous schedule on the conv
stage of tests/test_pipeline_parallel.py (outputs and gradients in one
program, `remat=True`), the pipelined ResNet-18 on 4 stages and on 4 x 2
(stage, data), and the gradient of the 2-stage split through the
heterogeneous schedule.  ResNet-18 variables are drawn with numpy at
flax's shapes (kernels He-scaled, so that the logits depend on the input;
BN statistics away from 0 and 1) and bridged with `state_dict_from_flax`.

Tolerances, float32: the conv-stage outputs (|y| up to about 5) within
rtol 1e-5, atol 1e-5 and its gradients within rtol 1e-4, atol 1e-5, the
atol of tests/test_pipeline_parallel.py's gradients (XLA and torch sum
the 3x3 convolutions in their own orders); pipelined ResNet-18 logits
within rtol 1e-4, atol 2e-4 (tests/test_torch_models.py's); the 2-stage
split's gradients within rtol 1e-3, atol 1e-5 of each tensor's largest
|value| (20 convolutions deep, float32 gradients of eval-mode BN).
Float64, port against port: rtol 1e-10, atol 1e-13 of each tensor's
largest |value| (the microbatches sum a gradient's terms in another
order, and an element that cancels to 1e-5 of its tensor's largest keeps
the others' rounding).

The test command: the port's `--pp 2` and `--pp 4` and the JAX command
without `--pp` on one checkpoint written by the port, 3 segments x 1 crop
(the clip batch of 3 is padded to 4 at both pp) at input 64, within
rtol 1e-4, atol 2e-4 with equal labels and accuracy; `--plain 1` with mv
likewise.  The JAX run for mv also takes `--viz 1`, whose pictures the
port's `--viz` must meet within one level of 255.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image
from test_pipeline_parallel import _conv_stage, _make_params
from test_torch_cli import zero_flax_init
from test_torch_i3d_data import panning_canvas
from test_torch_train import _two_torch_threads  # noqa: F401 (autouse)
from torch import nn

from dmcnet_tpu_torch.codec.mpeg4 import encode_mpeg4
from dmcnet_tpu_torch.models.resnet import resnet18
from dmcnet_tpu_torch.models.weights import state_dict_from_flax
from dmcnet_tpu_torch.parallel import (
    make_pipeline_apply,
    make_pp_resnet18,
    make_stage_mesh,
    resnet18_stage_split,
)

CONV_RTOL, CONV_ATOL = 1e-5, 1e-5
CONV_GRAD_RTOL, CONV_GRAD_ATOL = 1e-4, 1e-5
LOGIT_RTOL, LOGIT_ATOL = 1e-4, 2e-4
GRAD_RTOL, GRAD_ATOL_SCALE = 1e-3, 1e-5
F64_RTOL, F64_ATOL_SCALE = 1e-10, 1e-13
NUM_CLASS, HW = 5, 64


class ConvStage(nn.Module):
    """`_conv_stage` of tests/test_pipeline_parallel.py in NCHW: x +
    tanh(conv3x3(x) + b)."""

    def __init__(self, p):
        super().__init__()
        c = p["w"].shape[-1]
        self.conv = nn.Conv2d(c, c, 3, padding=1)
        with torch.no_grad():
            self.conv.weight.copy_(torch.from_numpy(
                np.transpose(np.array(p["w"]), (3, 2, 0, 1))))
            self.conv.bias.copy_(torch.from_numpy(np.array(p["b"])))

    def forward(self, x):
        return x + torch.tanh(self.conv(x))


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(
        np.transpose(np.asarray(a), (0, 3, 1, 2))))


@pytest.fixture(scope="module")
def jax_conv_pipeline():
    """4 conv stages over 4 devices, batch 8 in 4 microbatches, remat: the
    outputs, and the gradient of their mean squared error to a target."""
    from dmcnet_tpu.parallel import (
        shard_stage_params,
        stack_stage_params,
        unstack_stage_params,
    )
    from dmcnet_tpu.parallel import make_pipeline_apply as jax_pipeline
    from dmcnet_tpu.parallel import make_stage_mesh as jax_mesh

    rng = np.random.default_rng(21)
    params = _make_params(rng, 4)
    x = rng.normal(size=(8, 5, 5, 8)).astype(np.float32)
    tgt = rng.normal(size=(8, 5, 5, 8)).astype(np.float32)
    mesh = jax_mesh(jax.devices()[:4])
    stacked = shard_stage_params(stack_stage_params(params), mesh)
    pipe = jax_pipeline(_conv_stage, mesh, jit=False, remat=True)

    def loss(p):
        y = pipe(p, jnp.asarray(x))
        return jnp.mean((y - tgt) ** 2), y

    (_, y), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(stacked)
    return params, x, tgt, np.asarray(y), unstack_stage_params(g, 4)


@pytest.mark.parametrize("remat", [False, True])
def test_conv_pipeline_matches_jax(jax_conv_pipeline, remat):
    """The homogeneous schedule of the JAX package on its conv stage:
    outputs and every stage's gradients, with and without remat."""
    params, x, tgt, y_jax, g_jax = jax_conv_pipeline
    stages = [ConvStage(p) for p in params]
    pipe = make_pipeline_apply(stages, make_stage_mesh(["cpu"] * 4),
                               remat=remat)
    y = pipe(_nchw(x))
    np.testing.assert_allclose(y.detach().permute(0, 2, 3, 1).numpy(), y_jax,
                               rtol=CONV_RTOL, atol=CONV_ATOL)
    ((y - _nchw(tgt)) ** 2).mean().backward()
    for stage, g in zip(stages, g_jax):
        np.testing.assert_allclose(
            stage.conv.weight.grad.permute(2, 3, 1, 0).numpy(), g["w"],
            rtol=CONV_GRAD_RTOL, atol=CONV_GRAD_ATOL)
        np.testing.assert_allclose(stage.conv.bias.grad.numpy(), g["b"],
                                   rtol=CONV_GRAD_RTOL, atol=CONV_GRAD_ATOL)


def _draw(path, shape, rng):
    """Kernels N(0, 2/fan_in), BN scale and running variance in
    [0.5, 1.5), biases and running means N(0, 0.1)."""
    name = path[-1].key
    if name == "kernel":
        return rng.normal(0, (2 / np.prod(shape[:-1])) ** 0.5, shape)
    if name in ("scale", "var"):
        return rng.uniform(0.5, 1.5, shape)
    return rng.normal(0, 0.1, shape)


@functools.lru_cache(maxsize=None)
def _flax_resnet():
    """Variables of the JAX package's ResNet-18 at the shapes its `init`
    gives (traced, not compiled), drawn with numpy."""
    from dmcnet_tpu.models.resnet import resnet18 as flax_resnet18

    shapes = jax.eval_shape(
        functools.partial(flax_resnet18(num_classes=NUM_CLASS).init,
                          train=False),
        jax.random.key(0), jnp.zeros((1, HW, HW, 2)))
    rng = np.random.default_rng(5)
    return jax.tree_util.tree_map_with_path(
        lambda p, s: _draw(p, s.shape, rng).astype(np.float32), shapes)


def _port_resnet(variables, dtype=torch.float32):
    sd = state_dict_from_flax({"base_model": variables["params"]},
                              {"base_model": variables["batch_stats"]})
    net = resnet18(NUM_CLASS)
    net.load_state_dict({k[len("base_model."):]: v for k, v in sd.items()})
    return net.to(dtype).eval()


@pytest.mark.parametrize("data", [1, 2], ids=["4x1", "4x2"])
def test_pp_resnet18_matches_jax(data):
    """`make_pp_resnet18` on a 4-stage grid (x 2 data replicas) against
    `make_pp_resnet18_apply` on 4 (x 2) JAX devices."""
    from dmcnet_tpu.parallel import make_pp_resnet18_apply
    from dmcnet_tpu.parallel import make_stage_mesh as jax_mesh

    variables = _flax_resnet()
    x = np.random.default_rng(data).normal(
        size=(8 * data, HW, HW, 2)).astype(np.float32)
    want = np.asarray(make_pp_resnet18_apply(
        variables, NUM_CLASS, jax_mesh(jax.devices()[:4 * data],
                                       data=data))(jnp.asarray(x)))
    pipe = make_pp_resnet18(_port_resnet(variables),
                            make_stage_mesh(["cpu"] * (4 * data), data=data))
    with torch.no_grad():
        got = pipe(_nchw(x)).numpy()
    assert np.ptp(want, axis=0).max() > 0.1   # the logits see the input
    np.testing.assert_allclose(got, want, rtol=LOGIT_RTOL, atol=LOGIT_ATOL)


def test_two_stage_grads_match_jax():
    """Gradients through the 2-stage split ([stem + layer1 + layer2]
    [layer3 + layer4 + head]) against `jax.grad` through the JAX
    package's heterogeneous schedule, every parameter."""
    from dmcnet_tpu.parallel import make_stage_mesh as jax_mesh
    from dmcnet_tpu.parallel.pipeline import (
        flatten_tree,
        make_hetero_pipeline_apply,
    )
    from dmcnet_tpu.parallel.pp_resnet import (
        resnet18_stage_split as jax_split,
    )

    variables = _flax_resnet()
    rng = np.random.default_rng(8)
    x = rng.normal(size=(8, HW, HW, 2)).astype(np.float32)
    tgt = rng.normal(size=(8, NUM_CLASS)).astype(np.float32)
    fns, svars = jax_split(variables, NUM_CLASS, n_stages=2)
    run, stacked = make_hetero_pipeline_apply(
        fns, svars, jax_mesh(jax.devices()[:2]), jit=False)
    g_vec = np.asarray(jax.jit(jax.grad(
        lambda v: jnp.mean((run(v, jnp.asarray(x)) - tgt) ** 2)))(stacked))
    g_params = {}
    for i, sv in enumerate(svars):
        vec, unflat = flatten_tree(sv)
        g_params.update(jax.tree.map(np.asarray, unflat(
            jnp.asarray(g_vec[i, :vec.shape[0]])))["params"])
    want = {k[len("base_model."):]: v for k, v in state_dict_from_flax(
        {"base_model": g_params}, {}).items()}

    net = _port_resnet(variables)
    pipe = make_pp_resnet18(net, make_stage_mesh(["cpu"] * 2))
    ((pipe(_nchw(x)) - torch.from_numpy(tgt)) ** 2).mean().backward()
    named = dict(net.named_parameters())
    assert set(named) == set(want)
    for k, p in named.items():
        w = want[k].numpy()
        np.testing.assert_allclose(
            p.grad.numpy(), w, rtol=GRAD_RTOL,
            atol=GRAD_ATOL_SCALE * np.abs(w).max(), err_msg=k)


@pytest.mark.parametrize("n_stages,remat,data", [
    (n, r, d) for n in (2, 4) for r in (False, True) for d in (1, 2)])
def test_pipeline_equals_serial_f64(n_stages, remat, data):
    """Float64, port against port: the pipelined ResNet-18's logits and
    every parameter's gradient equal the serial model's."""
    variables = _flax_resnet()
    net = _port_resnet(variables, torch.float64)
    x = torch.from_numpy(np.random.default_rng(n_stages + data).normal(
        size=(8, 2, 32, 32)))
    want = net(x)
    want_g = torch.autograd.grad((want ** 2).sum(), list(net.parameters()))
    pipe = make_pipeline_apply(
        resnet18_stage_split(net, n_stages),
        make_stage_mesh(["cpu"] * (n_stages * data), data=data),
        remat=remat)
    got = pipe(x)
    got_g = torch.autograd.grad((got ** 2).sum(), list(net.parameters()))
    pairs = [("logits", got.detach(), want.detach())] + [
        (k, g, w) for (k, _), g, w in zip(net.named_parameters(), got_g,
                                          want_g)]
    for k, g, w in pairs:
        w = w.numpy()
        np.testing.assert_allclose(g.numpy(), w, rtol=F64_RTOL,
                                   atol=F64_ATOL_SCALE * np.abs(w).max(),
                                   err_msg=k)


def test_pipeline_rejects_indivisible_batches():
    """The JAX package's errors: microbatches that do not divide the batch,
    data replicas that do not divide a microbatch, a grid of another
    stage count."""
    stages = [nn.Identity(), nn.Identity()]
    pipe = make_pipeline_apply(stages, make_stage_mesh(["cpu"] * 2),
                               n_microbatches=4)
    with pytest.raises(ValueError, match="batch 6 not divisible by 4"):
        pipe(torch.zeros(6, 1))
    pipe = make_pipeline_apply(stages, make_stage_mesh(["cpu"] * 4, data=2))
    with pytest.raises(ValueError, match="microbatch 3 not divisible by "
                                         "data=2"):
        pipe(torch.zeros(6, 1))
    with pytest.raises(ValueError, match="3 devices not divisible"):
        make_stage_mesh(["cpu"] * 3, data=2)
    with pytest.raises(ValueError, match="unsupported ResNet-18 split"):
        resnet18_stage_split(resnet18(NUM_CLASS), 3)


# ---------------------------------------------------------------------------
# cli.test --pp and --viz

NVID, VH, VW, VT, SIZE = 3, 96, 112, 26, 64
SCORE_RTOL, SCORE_ATOL = 1e-4, 2e-4


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Three panning MPEG-4 clips (motion, so the MV input is not zero), a
    list, and the port's DMCNet and 2-channel PlainTSN checkpoints."""
    from dmcnet_tpu_torch.models.tsn import DMCNet, PlainTSN
    from dmcnet_tpu_torch.train.checkpoints import save_checkpoint

    root = tmp_path_factory.mktemp("torch_pipeline_cli")
    os.makedirs(root / "videos" / "cls")
    rng = np.random.default_rng(17)
    lines = []
    for v in range(NVID):
        canvas = panning_canvas(rng, VH + VT, VW + 2 * NVID * VT)
        frames = np.stack([canvas[i:i + VH, (v + 1) * i:(v + 1) * i + VW]
                           for i in range(VT)])
        encode_mpeg4(str(root / "videos" / "cls" / f"v{v}.mp4"), frames,
                     gop_size=12, bit_rate=1_000_000)
        lines.append(f"cls/v{v}.avi 0 {v % 2}")
    (root / "test.txt").write_text("\n".join(lines) + "\n")
    torch.manual_seed(4)
    meta = {"epoch": 1, "arch": "resnet18", "best_prec1": 0.0}
    save_checkpoint(DMCNet(51, num_segments=3, arch_estimator="DenseNetTiny",
                           gen_flow_or_delta=1), meta, str(root / "dmc.pth"))
    save_checkpoint(PlainTSN(51, in_channels=2), meta,
                    str(root / "plain.pth"))
    return root


def _test_args(root, plain, scores):
    args = ["--data-name", "hmdb51", "--representation", "mv",
            "--arch", "resnet18", "--no-accumulation", "--mv_minmaxnorm", "1",
            "--data-root", str(root / "videos"),
            "--test-list", str(root / "test.txt"), "--test_segments", "3",
            "--test-crops", "1", "--input_size", str(SIZE),
            "--save-scores", scores]
    if plain:
        return args + ["--plain", "1", "--weights", str(root / "plain.pth")]
    return args + ["--arch_estimator", "DenseNetTiny", "--gen_flow_or_delta",
                   "1", "--weights", str(root / "dmc.pth")]


def _scores(path):
    with np.load(path, allow_pickle=True) as data:
        return (np.stack([s[0] for s in data["scores"]]),
                list(data["labels"]), list(data["names"]))


@pytest.fixture(scope="module")
def jax_scores(corpus):
    """The JAX test command without --pp, for mv (with --viz 1) and for
    --plain 1 mv: {plain: (accuracy, scores file)}.  The command's eager
    flax `init` (about 25 s on this CPU) is swapped for zeros of its
    shapes (tests/test_torch_cli.py `zero_flax_init`): the checkpoint
    overwrites every variable."""
    from dmcnet_tpu.cli import test as jax_test_cli
    from dmcnet_tpu.models import DMCNet as FlaxDMCNet
    from dmcnet_tpu.models import PlainTSN as FlaxPlainTSN

    out = {}
    with pytest.MonkeyPatch.context() as mp:
        zero_flax_init(mp, FlaxDMCNet, FlaxPlainTSN)
        for plain in (False, True):
            path = str(corpus / f"jax_{int(plain)}")
            viz = [] if plain else ["--viz", "1", "--viz-dir",
                                    str(corpus / "jax_viz")]
            out[plain] = (jax_test_cli.main(_test_args(corpus, plain, path)
                                            + viz), path + ".npz")
    return out


@pytest.mark.parametrize("plain", [False, True], ids=["mv", "plain_mv"])
@pytest.mark.parametrize("pp", [2, 4])
def test_test_cli_pp_matches_jax(corpus, jax_scores, tmp_path, pp, plain):
    """`cli.test --pp` on the CPU stages against the JAX command's plain
    forward on the same checkpoint: 3 clips a video, padded to 4."""
    from dmcnet_tpu_torch.cli import test as test_cli

    path = str(tmp_path / "port")
    acc = test_cli.main(_test_args(corpus, plain, path)
                        + ["--pp", str(pp), "--device", "cpu"])
    want_acc, want_path = jax_scores[plain]
    s_jax, l_jax, n_jax = _scores(want_path)
    s_port, l_port, n_port = _scores(path + ".npz")
    assert (l_port, n_port) == (l_jax, n_jax) and acc == want_acc
    assert np.ptp(s_jax[:, 0], axis=0).max() > 1e-3   # the videos differ
    np.testing.assert_allclose(s_port, s_jax, rtol=SCORE_RTOL,
                               atol=SCORE_ATOL)


def test_test_cli_viz_matches_jax(corpus, jax_scores, tmp_path):
    """`--viz 1`: one picture per video under the JAX command's name, its
    pixels within one level of the JAX command's."""
    from dmcnet_tpu_torch.cli import test as test_cli

    viz_dir = tmp_path / "viz"
    test_cli.main(_test_args(corpus, False, str(tmp_path / "s"))
                  + ["--viz", "1", "--viz-dir", str(viz_dir),
                     "--device", "cpu"])
    names = sorted(os.listdir(viz_dir))
    assert names == sorted(os.listdir(corpus / "jax_viz"))
    assert names == [f"{i:05d}_v{i}_gen_flow.png" for i in range(NVID)]
    for name in names:
        got = np.asarray(Image.open(viz_dir / name), np.int16)
        want = np.asarray(Image.open(corpus / "jax_viz" / name), np.int16)
        assert got.shape == want.shape == (SIZE, SIZE, 3)
        assert want.std() > 1.0                     # not a flat picture
        assert np.abs(got - want).max() <= 1, name
