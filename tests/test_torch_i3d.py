"""The port's I3D (dmcnet_tpu_torch/models/{layers,discriminators,i3d}.py,
the I3D part of models/weights.py, train/engine_i3d.py) against the JAX
package on the CPU.

Variables have the shapes the JAX package's flax `init` gives (traced by
`jax.eval_shape`, not run) and values drawn with numpy from a seed
(`draw_variables`: kernels N(0, 2 / fan_in), BN scales and running
variances in [0.5, 1.5), biases and running means N(0, 0.1)), bridged by
`state_dict_from_flax`.  Each JAX I3D forward is compiled once for the
module, at T = 8, 64x64, batch 2.  Tolerance: rtol 1e-4, atol 2e-4 on
float32 outputs (the forward-parity tolerance of tests/test_torch_models.py);
measured worst |diff| on this CPU: logits 5.6e-5 (of up to 40), the
generated cue 5.7e-6.

The JAX package is imported inside the helpers: the `cuda`-marked twins at
the end hold the card against the CPU and need no flax, which the H100
machine lacks.
"""

import functools

import numpy as np
import pytest
import torch
from test_torch_train import _draw, _two_torch_threads  # noqa: F401

from dmcnet_tpu_torch.models import discriminators as tdisc
from dmcnet_tpu_torch.models import i3d as ti3d
from dmcnet_tpu_torch.models.weights import (
    load_reference_i3d,
    state_dict_from_flax,
)
from dmcnet_tpu_torch.train.engine_i3d import make_i3d_eval_step

B, T, HW, NUM_CLASS = 2, 8, 64, 51
RTOL, ATOL = 1e-4, 2e-4
DISCRIMINATORS = ["Discriminator", "Discriminator2", "Discriminator3",
                  "Discriminator4", "Discriminator5"]


def draw_variables(shapes, seed=0):
    """numpy values for a flax variable tree: tests/test_torch_train.py
    `_draw`, with kernels at He scale N(0, 2 / fan_in).  At 1 / fan_in the
    ~20 ReLU layers of I3D shrink the clip's signal until the logits of two
    clips differ by 7e-4 of their size (measured), and no comparison of
    clips or frames could fail."""
    import jax

    rng = np.random.default_rng(seed)

    def draw(path, x):
        v = _draw(path, x.shape, rng)
        return (v * 2 ** 0.5 if path[-1].key == "kernel" else v) \
            .astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


@functools.lru_cache(maxsize=None)
def _flax_i3d(modality="flow+mp4", arch_estimator="DenseNetTiny",
              arch_d="Discriminator"):
    """(flax I3D, params, batch_stats) at T x HW x HW, numpy-drawn."""
    import jax
    import jax.numpy as jnp

    from dmcnet_tpu.models.i3d import get_symbol, init_i3d_variables

    net, _ = get_symbol("I3D", modality=modality, num_classes=NUM_CLASS,
                        arch_estimator=arch_estimator, arch_d=arch_d)
    c = 5 if arch_estimator else (2 if modality == "flow" else 3)
    shapes = jax.eval_shape(lambda: init_i3d_variables(
        net, jax.random.key(0), jnp.zeros((1, T, HW, HW, c))))
    v = draw_variables(shapes)
    return net, v["params"], v["batch_stats"]


def _port_i3d(modality="flow+mp4", arch_estimator="DenseNetTiny",
              arch_d="Discriminator", num_classes=NUM_CLASS):
    net, conf = ti3d.get_symbol("I3D", modality=modality,
                                num_classes=num_classes,
                                arch_estimator=arch_estimator, arch_d=arch_d,
                                input_size=HW)
    assert conf == {"mean": [0.5] * 3, "std": [0.5] * 3}
    return net


def _loaded_port_i3d(**kw):
    _, params, bstats = _flax_i3d(**kw)
    net = _port_i3d(**kw)
    net.load_state_dict(state_dict_from_flax(params, bstats), strict=True)
    return net.eval()


@functools.lru_cache(maxsize=None)
def _jax_node(node):
    """The JAX I3D's `node` forward, jitted once for the module."""
    import jax

    net, params, bstats = _flax_i3d()
    fn = jax.jit(lambda x: net.apply({"params": params,
                                      "batch_stats": bstats}, x, node,
                                     False, False))
    return fn


def _inputs(seed=1):
    rng = np.random.default_rng(seed)
    clip = rng.normal(size=(B, T, HW, HW, 5)).astype(np.float32)
    frames = rng.normal(size=(B * T, HW, HW, 2)).astype(np.float32)
    return clip, frames


def _ncthw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 4, 1, 2, 3)


def _ndhwc(x):
    return x.permute(0, 2, 3, 4, 1).numpy()


def _close(got, want, what):
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL,
                               err_msg=what)


# --- TF-SAME layers ---------------------------------------------------------

@pytest.mark.parametrize("sizes", [(5, 9, 7), (4, 8, 6)],
                         ids=["odd", "even"])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("kernel", [7, 3, 1])
def test_unit3d_and_max_pool_same(sizes, stride, kernel):
    """Unit3D (conv3d + BN + ReLU) and the SAME max pool against flax's
    `padding="SAME"`: the extra pixel of an odd total goes at the end, so
    a symmetric padding shifts every stride-2 output on even sizes."""
    import jax
    import jax.numpy as jnp

    from dmcnet_tpu.models.i3d import Unit3D, max_pool_same

    k, s = (kernel,) * 3, (stride,) * 3
    rng = np.random.default_rng(kernel * 10 + stride)
    x = rng.normal(size=(2,) + sizes + (3,)).astype(np.float32)
    flax_unit = Unit3D(4, k, s)
    shapes = jax.eval_shape(lambda: flax_unit.init(
        jax.random.key(0), jnp.zeros(x.shape), False))
    v = draw_variables(shapes)
    want = flax_unit.apply(v, jnp.asarray(x), False)
    unit = ti3d.Unit3D(3, 4, k, s).eval()
    sd = state_dict_from_flax({"conv3d_u": v["params"]},
                              {"conv3d_u": v["batch_stats"]})
    unit.load_state_dict({key.split(".", 1)[1]: val
                          for key, val in sd.items()}, strict=True)
    with torch.no_grad():
        got = unit(_ncthw(x))
    assert _ndhwc(got).shape == want.shape
    _close(_ndhwc(got), want, "Unit3D")

    pooled = ti3d.MaxPool3dSame(k, s)(_ncthw(x))
    want = max_pool_same(jnp.asarray(x), k, s)
    assert _ndhwc(pooled).shape == want.shape
    np.testing.assert_array_equal(_ndhwc(pooled), np.asarray(want))


def test_mixed_block():
    import jax
    import jax.numpy as jnp

    from dmcnet_tpu.models.i3d import _MIXED_PLAN, Mixed

    plan = _MIXED_PLAN["mixed_4b"]
    x = np.random.default_rng(3).normal(size=(1, 4, 7, 7, 480)) \
        .astype(np.float32)
    flax_mixed = Mixed(plan)
    shapes = jax.eval_shape(lambda: flax_mixed.init(
        jax.random.key(0), jnp.zeros(x.shape), False))
    v = draw_variables(shapes)
    want = flax_mixed.apply(v, jnp.asarray(x), False)
    mixed = ti3d.Mixed(480, plan).eval()
    sd = state_dict_from_flax({"mixed_m": v["params"]},
                              {"mixed_m": v["batch_stats"]})
    mixed.load_state_dict({key.split(".", 1)[1]: val
                           for key, val in sd.items()}, strict=True)
    with torch.no_grad():
        got = mixed(_ncthw(x))
    assert got.shape[1] == ti3d.mixed_width(plan) == 512
    _close(_ndhwc(got), want, "Mixed")


# --- the whole model ---------------------------------------------------------

@pytest.mark.parametrize("node", ["flow+logit", "logit", "gen_flow", "D"])
def test_i3d_nodes_match_jax(node):
    """All four nodes with DenseNetTiny and Discriminator, eval mode."""
    clip, frames = _inputs()
    net = _loaded_port_i3d()
    with torch.no_grad():
        if node == "D":
            got = net(torch.from_numpy(frames).permute(0, 3, 1, 2), "D")
            want = _jax_node("D")(frames)
            assert tuple(got.shape) == (B * T, 2)
            _close(got.numpy(), want, "D logits")
            return
        got = net(_ncthw(clip), node)
    want = _jax_node(node)(clip)
    if node == "flow+logit":
        assert tuple(got[0].shape) == (B, NUM_CLASS)
        # the two clips' logits differ: the comparison sees the input
        assert float((got[0][0] - got[0][1]).abs().max()) > 0.1
        _close(got[0].numpy(), want[0], "logits")
        _close(_ndhwc(got[1]), want[1], "generated cue")
    elif node == "logit":
        _close(got.numpy(), want, "logits")
    else:
        assert tuple(got.shape) == (B, 2, T, HW, HW)
        _close(_ndhwc(got), want, "generated cue")


@pytest.mark.parametrize("arch_d", DISCRIMINATORS)
def test_discriminators_match_jax(arch_d):
    """Each discriminator in eval mode (dropout off, running statistics
    drawn away from 0/1, BN eps 0.8), with the NHWC-flattened flax head
    reordered to torch's NCHW flattening."""
    import jax
    import jax.numpy as jnp

    from dmcnet_tpu.models.discriminators import make_discriminator

    x = np.random.default_rng(4).normal(size=(3, 32, 32, 2)) \
        .astype(np.float32)
    flax_d = make_discriminator(arch_d)
    shapes = jax.eval_shape(lambda: flax_d.init(
        jax.random.key(0), jnp.zeros(x.shape), train=False))
    v = draw_variables(shapes)
    want = flax_d.apply(v, jnp.asarray(x), train=False)
    d = tdisc.make_discriminator(arch_d, input_size=32).eval()
    sd = state_dict_from_flax({"discriminator": v["params"]},
                              {"discriminator": v["batch_stats"]})
    d.load_state_dict({k.split(".", 1)[1]: val for k, val in sd.items()},
                      strict=True)
    with torch.no_grad():
        got = d(torch.from_numpy(x).permute(0, 3, 1, 2))
    _close(got.numpy(), want, arch_d)


@pytest.mark.parametrize("modality,arch_estimator,arch_d", [
    ("flow", None, None), ("rgb", None, None),
    ("flow+mp4", "DenseNetTiny", None),
    ("flow+mp4", "DenseNetTiny", "Discriminator4")])
def test_state_dict_from_flax_loads_strictly(modality, arch_estimator,
                                             arch_d):
    _, params, bstats = _flax_i3d(modality, arch_estimator, arch_d)
    net = _port_i3d(modality, arch_estimator, arch_d)
    sd = state_dict_from_flax(params, bstats)
    assert set(sd) == set(net.state_dict())
    net.load_state_dict(sd, strict=True)


def test_port_keys_are_reference_keys():
    """The port's state_dict through the JAX package's reference-I3D
    importer gives the flax variables back, leaf for leaf: the port's keys
    and layouts are the reference's."""
    import jax

    from dmcnet_tpu.models.import_torch_i3d import import_i3d_state_dict

    _, params, bstats = _flax_i3d()
    net = _loaded_port_i3d()
    imported, skipped = import_i3d_state_dict(net.state_dict(), in_channels=2)
    assert skipped == []
    want = {"params": params, "batch_stats": bstats}
    assert jax.tree.structure(imported) == jax.tree.structure(want)
    for (path, got), w in zip(jax.tree_util.tree_leaves_with_path(imported),
                              jax.tree.leaves(want)):
        np.testing.assert_array_equal(got, w, err_msg=str(path))


def test_load_reference_i3d_matches_load_i3d_pth(tmp_path):
    """A reference-layout .pth of an RGB model (3-channel stem, 101
    classes, `module.` prefix, a key of no I3D module) loaded into a
    flow+mp4 model: the port's `load_reference_i3d` against the JAX
    package's `load_i3d_pth` — the same weights, the stem channel-meaned,
    the classifier left out, the same report."""
    from dmcnet_tpu.models.import_torch_i3d import load_i3d_pth

    torch.manual_seed(1)
    rgb = _port_i3d("rgb", "DenseNetTiny", "Discriminator", num_classes=101)
    sd = {"module." + k: v for k, v in rgb.state_dict().items()}
    sd["module.data_bn.weight"] = torch.ones(5)
    path = tmp_path / "i3d_rgb.pth"
    torch.save({"state_dict": sd}, path)

    _, params, bstats = _flax_i3d()
    net = _loaded_port_i3d()
    report, unfilled = load_reference_i3d(str(path), net, "flow+mp4")
    j_params, j_bstats, j_report = load_i3d_pth(str(path), params, bstats,
                                                 modality="flow+mp4")
    assert report == j_report
    assert report.endswith("skipped=1 shape-missed=2")
    assert unfilled == ["classifier.bias", "classifier.weight"]
    want = state_dict_from_flax(j_params, j_bstats)
    got = net.state_dict()
    stem = got["conv3d_1a_7x7.conv3d.weight"]
    assert tuple(stem.shape) == (64, 2, 7, 7, 7)
    ref_stem = rgb.state_dict()["conv3d_1a_7x7.conv3d.weight"]
    torch.testing.assert_close(stem[:, 1], ref_stem.mean(dim=1))
    for k, v in want.items():
        if not k.endswith("num_batches_tracked"):
            np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=1e-6,
                                       atol=1e-7, err_msg=k)
    # the classifier kept its own 51-class weights
    np.testing.assert_array_equal(got["classifier.bias"].numpy(),
                                  params["classifier"]["bias"])


def test_eval_step_matches_jax():
    import jax.numpy as jnp

    from dmcnet_tpu.train.engine import TrainState
    from dmcnet_tpu.train.engine_i3d import make_i3d_eval_step as jax_step

    clip, _ = _inputs(seed=5)
    label = np.asarray([3, 17], np.int32)
    jnet, params, bstats = _flax_i3d()
    want = jax_step(jnet)(
        TrainState(params=params, batch_stats=bstats, opt_cls=None,
                   opt_gf=None),
        {"mv": jnp.asarray(clip[..., :2]),
         "residual": jnp.asarray(clip[..., 2:]),
         "label": jnp.asarray(label)})
    net = _loaded_port_i3d()
    got = make_i3d_eval_step(net)({
        "mv": _ncthw(clip[..., :2]), "residual": _ncthw(clip[..., 2:]),
        "label": torch.as_tensor(label, dtype=torch.long)})
    _close(got["logits"].numpy(), want["logits"], "eval-step logits")
    for k in ("top1", "top5"):
        assert float(got[k]) == float(want[k]), k
    np.testing.assert_array_equal(got["label"].numpy(), label)


# --- on the card: the same model, card against CPU (no flax needed) --------

def _card_vs_cpu_tolerance(got, want):
    # float32 with TF32 off; cuDNN sums the 3D convolutions in other orders
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("node", ["flow+logit", "D"])
def test_cuda_i3d_matches_cpu(node):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        torch.manual_seed(0)
        cpu = _port_i3d().eval()
        gpu = _port_i3d()
        gpu.load_state_dict(cpu.state_dict())
        gpu.cuda().eval()
        clip, frames = _inputs()
        x = (torch.from_numpy(frames).permute(0, 3, 1, 2) if node == "D"
             else _ncthw(clip))
        with torch.no_grad():
            want = cpu(x, node)
            got = gpu(x.cuda(), node)
        if node == "D":
            want, got = (want,), (got,)
        for g, w in zip(got, want):
            _card_vs_cpu_tolerance(g.cpu().numpy(), w.numpy())
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
