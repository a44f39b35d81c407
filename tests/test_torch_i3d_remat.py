"""The port's I3D rematerialization (`I3D(remat=True | "dots")`,
`make_estimator(remat=True)`, `models/layers.remat_call` and the BatchNorms
that a recompute leaves alone) and its `unroll_time` lowering
(`layers.TimeUnrolledConv3d`) on the CPU, against the JAX package and
against the port's own plain paths.

  * Unit3D and a Mixed block with `unroll_time=True` against the JAX
    package's `unroll_time=True` on numpy-drawn, He-scaled weights
    (tests/test_torch_i3d.py `draw_variables`): the Unit3D in float32 at
    atol 1e-5 (tests/test_i3d.py's tolerance for the JAX lowering against
    its conv3d), odd and even sizes, spatial stride 1 and 2; the Mixed
    block in float64 on both sides (the float64 bridge of
    tests/test_torch_gan.py) within the same atol.  The whole I3D is held
    by the port's unrolled path against its `Conv3d` path below, whose
    forward tests/test_torch_i3d.py holds against the JAX I3D: compiling
    the JAX I3D once more would cost ~10 s (eagerly, ~24 s).
  * The unrolled I3D against the port's `Conv3d` path in float64:
    forward and every parameter gradient within rtol 1e-10 (an element
    near 0 of a gradient carries its tensor's round-off, so atol is 1e-10
    x the tensor's largest |value|).
  * remat against no remat, float64, train mode, two forward/backward
    passes: loss and every gradient within rtol 1e-12, every running
    statistic and `num_batches_tracked` equal, with the port's BatchNorm
    and with `parallel.mesh.GlobalBatchNorm` (a world-size-1 gloo group).
    Without the recompute guard the running statistics move twice and this
    test fails (shown by removing it in a copy of the tree).  With
    `unroll_time` as well, against the unrolled model without remat; the
    backward of `dots` then runs no convolution forward (the unrolled
    taps' outputs are kept, not recomputed), that of `remat=True` does.

The I3D cases run at B = 2, T = 4, 32x32: the comparisons are within one
framework or in float64, so the last blocks' BatchNorms over 2 values do
not matter here.
"""

import collections
import contextlib
import functools

import numpy as np
import pytest
import torch
from test_torch_gan import _bridge64
from test_torch_i3d import _ncthw, _ndhwc, draw_variables
from test_torch_train import _two_torch_threads  # noqa: F401

from dmcnet_tpu_torch.models import i3d as ti3d
from dmcnet_tpu_torch.models.layers import TimeUnrolledConv3d
from dmcnet_tpu_torch.models.weights import state_dict_from_flax
from torch.utils._python_dispatch import TorchDispatchMode

B, T, HW, NUM_CLASS = 2, 4, 32, 5
JAX_ATOL = 1e-5
F64_RTOL = 1e-10
REMAT_RTOL = 1e-12


def _port(remat=False, unroll_time=False, dtype=torch.float64):
    torch.manual_seed(0)
    return ti3d.I3D(NUM_CLASS, "flow+mp4", arch_estimator="DenseNetTiny",
                    input_size=HW, remat=remat,
                    unroll_time=unroll_time).to(dtype)


@functools.lru_cache(maxsize=None)
def _state():
    """One state dict for every port model of this module."""
    return {k: v.clone() for k, v in _port().state_dict().items()}


def _clip(seed=0):
    return torch.from_numpy(np.random.default_rng(seed).normal(
        size=(B, 5, T, HW, HW)))


def _loss(net, x):
    logits, gen = net(x, "flow+logit")
    return (torch.nn.functional.cross_entropy(logits, torch.tensor([1, 3]))
            + gen.square().mean())


class _CountOps(TorchDispatchMode):
    """Counts the ops that really run under it (an op a selective
    checkpoint replays from its cache never reaches it)."""

    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[func] += 1
        return func(*args, **(kwargs or {}))


def _train_passes(net, n=2, backward_ops=None):
    """n train-mode forward/backward passes on seeded clips: the losses,
    the summed gradients, and the state dict after them; the ops each
    backward runs are counted into `backward_ops` if given."""
    net.load_state_dict(_state())
    net.train()
    losses = []
    for i in range(n):
        loss = _loss(net, _clip(i))
        with _CountOps() if backward_ops is not None else \
                contextlib.nullcontext() as counter:
            loss.backward()
        if counter is not None:
            backward_ops.update(counter.ops)
        losses.append(loss.detach())
    grads = {k: p.grad.clone() for k, p in net.named_parameters()}
    return losses, grads, {k: v.clone() for k, v in net.state_dict().items()}


def _close_scaled(got, want, rtol, what):
    w = want.detach().numpy()
    np.testing.assert_allclose(got.detach().numpy(), w, rtol=rtol,
                               atol=rtol * float(np.abs(w).max()),
                               err_msg=what)


# --- unroll_time against the JAX package -----------------------------------

@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("sizes", [(5, 9, 7), (4, 8, 6)],
                         ids=["odd", "even"])
def test_unit3d_unrolled_matches_jax(sizes, stride):
    """A 3x3x3 Unit3D, temporal stride 1, spatial `stride`: the port's
    unrolled conv against the JAX package's `Unit3D(unroll_time=True)`."""
    import jax
    import jax.numpy as jnp

    from dmcnet_tpu.models.i3d import Unit3D

    k, s = (3, 3, 3), (1, stride, stride)
    x = np.random.default_rng(stride).normal(
        size=(2,) + sizes + (3,)).astype(np.float32)
    flax_unit = Unit3D(4, k, s, unroll_time=True)
    shapes = jax.eval_shape(lambda: flax_unit.init(
        jax.random.key(0), jnp.zeros(x.shape), False))
    v = draw_variables(shapes)
    want = flax_unit.apply(v, jnp.asarray(x), False)
    unit = ti3d.Unit3D(3, 4, k, s, unroll_time=True).eval()
    assert isinstance(unit.conv3d, TimeUnrolledConv3d)
    sd = state_dict_from_flax({"conv3d_u": v["params"]},
                              {"conv3d_u": v["batch_stats"]})
    unit.load_state_dict({key.split(".", 1)[1]: val
                          for key, val in sd.items()}, strict=True)
    with torch.no_grad():
        got = _ndhwc(unit(_ncthw(x)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, np.asarray(want), rtol=0,
                               atol=JAX_ATOL)


def test_mixed_unrolled_matches_jax():
    """An Inception block with `unroll_time=True` (its two 3x3x3 convs
    unrolled) in float64 against the JAX package's, eval mode."""
    import jax
    import jax.numpy as jnp

    from dmcnet_tpu.models.i3d import Mixed

    plan = ti3d._MIXED_PLAN["mixed_3c"]
    x = np.random.default_rng(5).normal(size=(1, 5, 7, 6, 256))
    flax_mixed = Mixed(plan, unroll_time=True)
    shapes = jax.eval_shape(lambda: flax_mixed.init(
        jax.random.key(0), jnp.zeros(x.shape), False))
    v = draw_variables(shapes)
    with jax.enable_x64(True):
        v64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), v)
        want = np.asarray(flax_mixed.apply(v64, jnp.asarray(x), False))
    mixed = ti3d.Mixed(256, plan, unroll_time=True).double().eval()
    assert sum(isinstance(m, TimeUnrolledConv3d)
               for m in mixed.modules()) == 2
    sd = _bridge64({"mixed_m": v["params"]}, {"mixed_m": v["batch_stats"]})
    mixed.load_state_dict({key.split(".", 1)[1]: val
                           for key, val in sd.items()}, strict=True)
    with torch.no_grad():
        got = _ndhwc(mixed(_ncthw(x)))
    assert got.shape == want.shape and np.abs(want).max() > 1.0
    np.testing.assert_allclose(got, want, rtol=0, atol=JAX_ATOL)


def test_i3d_unrolls_every_temporal_conv():
    """`I3D(unroll_time=True)` unrolls exactly the JAX package's set:
    `conv3d_2c_3x3` and each Mixed block's two 3x3x3 convs; the 7x7x7
    stem (temporal stride 2) and the 1x1x1 convs stay `nn.Conv3d`."""
    net = _port(unroll_time=True)
    unrolled = {n.rsplit(".", 1)[0] for n, m in net.named_modules()
                if isinstance(m, TimeUnrolledConv3d)}
    want = {"conv3d_2c_3x3"} | {f"{b}.branch_{i}.1" for b in ti3d._MIXED_PLAN
                                for i in (1, 2)}
    assert unrolled == want
    assert not any(isinstance(m, TimeUnrolledConv3d)
                   for m in _port().modules())


# --- unroll_time against the port's Conv3d path -----------------------------

def test_unrolled_matches_conv3d_f64():
    """Forward logits and cue, and every parameter gradient of a train-mode
    pass, unrolled against `nn.Conv3d`, float64."""
    plain = _port()
    unrolled = _port(unroll_time=True)
    x = _clip(7)
    out = []
    for net in (plain, unrolled):
        net.load_state_dict(_state())
        net.train()
        logits, gen = net(x, "flow+logit")
        logits.square().sum().add(gen.square().mean()).backward()
        out.append((logits, gen, {k: p.grad for k, p in
                                  net.named_parameters()}))
    (l0, g0, grads0), (l1, g1, grads1) = out
    _close_scaled(l1, l0, F64_RTOL, "logits")
    _close_scaled(g1, g0, F64_RTOL, "gen_flow")
    assert grads1.keys() == grads0.keys()
    for k, g in grads0.items():
        _close_scaled(grads1[k], g, F64_RTOL, f"the gradient of {k}")


def test_state_dict_keys_unchanged():
    """Neither `remat` nor `unroll_time` adds, drops or reshapes a state
    entry, so checkpoints move between them; the CLI's `get_symbol`
    passes `remat` as the JAX package's does."""
    want = {k: tuple(v.shape) for k, v in _state().items()}
    for kw in ({"unroll_time": True}, {"remat": True}, {"remat": "dots"},
               {"remat": "dots", "unroll_time": True}):
        net = _port(**kw)
        assert {k: tuple(v.shape) for k, v in
                net.state_dict().items()} == want, kw
        net.load_state_dict(_state(), strict=True)
    net, _ = ti3d.get_symbol("I3D", modality="flow+mp4",
                             arch_estimator="DenseNetTiny", remat="dots")
    assert all(getattr(net, n).remat == "dots" for n in ti3d._MIXED_PLAN)
    with pytest.raises(ValueError, match="remat must be"):
        ti3d.I3D(NUM_CLASS, remat="all")


@pytest.mark.parametrize("remat,blocks,generator", [
    (False, False, False), (True, True, True), ("dots", "dots", False)])
def test_remat_covers_generator(remat, blocks, generator):
    """remat=True rematerializes the Mixed blocks and the generator,
    "dots" the blocks only (the JAX package's `remat is True` for the
    estimator); the stem convs never."""
    net = _port(remat=remat)
    assert all(getattr(net, n).remat == blocks for n in ti3d._MIXED_PLAN)
    assert net.gen_flow_model.remat is generator
    assert not any(hasattr(getattr(net, n), "remat") for n in
                   ("conv3d_1a_7x7", "conv3d_2b_1x1", "conv3d_2c_3x3"))


# --- remat against no remat: the recompute leaves BN alone ------------------

@functools.lru_cache(maxsize=None)
def _plain_passes(unroll_time=False):
    return _train_passes(_port(unroll_time=unroll_time))


@functools.lru_cache(maxsize=None)
def _global_plain_passes():
    """`_train_passes` of the plain model with `GlobalBatchNorm` (inside a
    world-size-1 group; its numbers do not depend on which)."""
    from dmcnet_tpu_torch.parallel.mesh import use_global_batchnorm

    return _train_passes(use_global_batchnorm(_port()))


def _global_bn_group(tmp_path):
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    return dist


@pytest.mark.parametrize("remat,bn,unroll_time", [
    *(pytest.param(remat, bn, False, id=f"{remat}-{bn}")
      for bn in ("local", "global") for remat in (True, "dots")),
    *(pytest.param(remat, "local", True, id=f"{remat}-local-unroll_time")
      for remat in (True, "dots"))])
def test_remat_matches_plain_f64(remat, bn, unroll_time, tmp_path):
    """Two train-mode passes with remat against the same model's without:
    losses and summed gradients within rtol 1e-12; running statistics and
    batch counts equal, since the recompute's BatchNorm leaves them alone
    (with `GlobalBatchNorm` it all-reduces again).  Under `unroll_time`,
    `dots` keeps the unrolled convs' outputs: its backward runs neither
    `conv3d_unrolled` nor a convolution forward, where `remat=True`
    recomputes both."""
    from dmcnet_tpu_torch.parallel.mesh import (
        GlobalBatchNorm,
        use_global_batchnorm,
    )

    w_losses, w_grads, w_state = _plain_passes(unroll_time)
    net = _port(remat=remat, unroll_time=unroll_time)
    ops = collections.Counter()
    dist = None
    try:
        if bn == "global":
            dist = _global_bn_group(tmp_path)
            use_global_batchnorm(net)
            assert any(isinstance(m, GlobalBatchNorm)
                       for m in net.modules())
            w_losses, w_grads, w_state = _global_plain_passes()
        losses, grads, state = _train_passes(net, backward_ops=ops)
    finally:
        if dist is not None:
            dist.destroy_process_group()
    for got, want in zip(losses, w_losses):
        np.testing.assert_allclose(float(got), float(want), rtol=REMAT_RTOL)
    for k, g in w_grads.items():
        _close_scaled(grads[k], g, REMAT_RTOL, f"the gradient of {k}")
    stats = [k for k in w_state if k.split(".")[-1] in
             ("running_mean", "running_var", "num_batches_tracked")]
    assert len(stats) == 3 * sum(
        isinstance(m, torch.nn.modules.batchnorm._BatchNorm)
        for m in net.modules())
    for k in stats:
        assert torch.equal(state[k], w_state[k]), k
    assert int(state["mixed_5c.branch_0.batch3d.num_batches_tracked"]) == 2
    recomputed = (ops[torch.ops.dmcnet_torch.conv3d_unrolled.default],
                  ops[torch.ops.aten.convolution.default])
    assert ops[torch.ops.aten.convolution_backward.default] > 0
    if remat == "dots":
        assert recomputed == (0, 0), recomputed
    elif unroll_time:
        assert min(recomputed) > 0, recomputed
