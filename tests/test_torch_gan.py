"""The port's dmcnet_GAN variant (DMCNet with a discriminator, the
discriminators in train mode, three optimizers, train/engine_gan.py,
checkpoints with `optimizer_d`) against the JAX package on the CPU.

Variables have the shapes the JAX package's flax `init` gives and values
drawn with numpy from a seed (tests/test_torch_train.py `_draw`), bridged
by `state_dict_from_flax`; batches are tests/test_torch_train.py's
(B=2, S=2, 32x32, 5 classes), so each discriminator sees 32x32 cues.

Dropout: the discriminators' `Dropout2d(0.25)` draws its masks from each
framework's own generator, so no two masks agree.  Every comparison of a
train-mode forward or step zeroes the rate on both sides: `dropout_off` sets
`p = 0` on the port's `Dropout2d` modules, and `jax_dropout_off`
monkeypatches `flax.linen.Dropout` to rate 0 while the JAX program is
traced (nothing in `dmcnet_tpu/` is edited).  `test_dropout2d_statistics`
checks the dropout itself.

Tolerances:
  * forward outputs, float32: rtol 1e-4, atol 2e-4
    (tests/test_torch_models.py);
  * the D, G and D steps run in float64 on both sides (see
    tests/test_torch_train.py for why not float32), compared through a
    float64 weight bridge (`_bridge64`): losses and accuracies at rtol 1e-9
    (measured worst on a CPU 4.7e-13), parameters, BN running
    statistics and Adam moments at rtol 1e-7, atol 1e-11 (measured worst
    7.3e-13 absolute, a generator weight; moments 4.7e-14).

The JAX package is imported inside the helpers: the `cuda`-marked twins at
the end hold the card against the CPU and need no flax.
"""

import contextlib
import functools

import numpy as np
import pytest
import torch
from test_torch_train import (  # noqa: F401 (autouse fixture)
    B,
    FWD_ATOL,
    FWD_RTOL,
    H,
    LR,
    LR_CLS_MULT,
    LR_MSE_MULT,
    NUM_CLASS,
    S,
    W,
    WD,
    _batch_np,
    _draw,
    _torch_batch,
    _two_torch_threads,
)

from dmcnet_tpu_torch.models import discriminators as tdisc
from dmcnet_tpu_torch.models.tsn import DMCNet
from dmcnet_tpu_torch.models.weights import state_dict_from_flax
from dmcnet_tpu_torch.train import checkpoints as tckpt
from dmcnet_tpu_torch.train import engine as tengine
from dmcnet_tpu_torch.train import engine_gan
from dmcnet_tpu_torch.train import optimizers as topt

DISCRIMINATORS = ["Discriminator", "Discriminator2", "Discriminator3",
                  "Discriminator4", "Discriminator5"]
LR_D_MULT = 0.25                      # distinct from the other two
LOSS_W = dict(lr_cls_w=1.0, lr_adv_g=0.5, lr_adv_d=0.75, lr_mse_w=1.0)
STEP_RTOL = 1e-9
STATE_RTOL, STATE_ATOL = 1e-7, 1e-11
# the steps of test_gan_steps_match_jax: (kind, classifier lr)
STEPS = (("d", LR), ("g", LR), ("d", LR))
_D_METRICS = ("loss", "loss_cls", "loss_adv", "top1", "top5", "acc_D_adv")
_G_METRICS = ("loss", "loss_cls", "loss_adv", "loss_mse", "top1", "top5",
              "acc_G_adv")


def dropout_off(model):
    """Rate 0 on every `Dropout2d` of the port's `model`."""
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout2d):
            m.p = 0.0
    return model


@contextlib.contextmanager
def jax_dropout_off():
    """`flax.linen.Dropout` at rate 0 while JAX programs are traced."""
    import flax.linen as fnn

    real = fnn.Dropout

    def no_dropout(*args, **kw):
        kw["rate"] = 0.0
        return real(*args[1:], **kw)  # a positional rate replaced too

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fnn, "Dropout", no_dropout)
        yield


@functools.lru_cache(maxsize=None)
def _flax_gan(arch_d, arch_estimator="DenseNetTiny", att=0):
    """(flax DMCNet with `arch_d`, params, batch_stats) as numpy trees at
    the shapes `init` gives (traced, not run), drawn from a seed."""
    import jax
    import jax.numpy as jnp

    from dmcnet_tpu.models import DMCNet as FlaxDMCNet

    model = FlaxDMCNet(num_class=NUM_CLASS, num_segments=S,
                       arch_estimator=arch_estimator, gen_flow_or_delta=1,
                       att=att, arch_d=arch_d, detach_classifier=False)
    args = (jnp.zeros((1, 1, H, W, 2)), jnp.zeros((1, 1, H, W, 3)),
            jnp.zeros((1, 1, H, W, 2)))
    shapes = jax.eval_shape(functools.partial(model.init, train=False),
                            jax.random.key(0), *args)
    rng = np.random.default_rng(0)
    draw = functools.partial(jax.tree_util.tree_map_with_path, lambda p, x: (
        _draw(p, x.shape, rng).astype(np.float32)))
    return model, draw(shapes["params"]), draw(shapes["batch_stats"])


def _port_gan(arch_d, arch_estimator="DenseNetTiny", att=0):
    """The port's DMCNet with `arch_d` and the flax weights of
    `_flax_gan`, loaded strictly."""
    _, params, stats = _flax_gan(arch_d, arch_estimator, att)
    model = DMCNet(NUM_CLASS, num_segments=S, arch_estimator=arch_estimator,
                   gen_flow_or_delta=1, att=att, arch_d=arch_d, input_size=H)
    model.load_state_dict(state_dict_from_flax(params, stats))
    return model


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _bridge64(params, stats):
    """`state_dict_from_flax` in float64: the bridge rounds to float32,
    which would hide the float64 steps' agreement behind float32's."""
    from dmcnet_tpu_torch.models import weights

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(weights, "_t", lambda a: torch.from_numpy(
            np.array(a, dtype=np.float64, copy=True)))
        return state_dict_from_flax(params, stats)


def _assert_close_to(got_sd, params, stats, rtol, atol, what, prefix=""):
    """`got_sd` (the port's state dict, or a part of it under `prefix`)
    against the flax trees bridged in float64."""
    want = _bridge64(params, stats)
    want = {k: v for k, v in want.items() if k.startswith(prefix)}
    assert set(want) == set(got_sd), what
    for k, v in want.items():
        if k.endswith("num_batches_tracked"):
            continue
        np.testing.assert_allclose(got_sd[k].detach().cpu().double().numpy(),
                                   v.numpy(), rtol=rtol, atol=atol,
                                   err_msg=f"{what}: {k}")


@functools.lru_cache(maxsize=None)
def _jax_forward(arch_d):
    """The JAX DMCNet+D in eval mode on the test batch, with and without
    the real flow: {with_flow: (logits, gen_flow, validity)} as numpy."""
    import jax

    fmodel, params, stats = _flax_gan(arch_d)
    batch = _batch_np()
    apply = jax.jit(fmodel.apply, static_argnames="train")
    variables = {"params": params, "batch_stats": stats}
    out = {}
    for with_flow in (True, False):
        flow = batch["flow"] if with_flow else None
        out[with_flow] = jax.tree.map(np.asarray, apply(
            variables, batch["mv"], batch["residual"], flow, train=False))
    return out


@pytest.mark.parametrize("with_flow", [True, False])
@pytest.mark.parametrize("arch_d", DISCRIMINATORS)
def test_gan_forward_matches_jax(arch_d, with_flow):
    """DMCNet+D in eval mode: logits, the cue and the validity of fake‖real
    (with flow) or of the fakes alone (without)."""
    want = _jax_forward(arch_d)[with_flow]
    model = _port_gan(arch_d).eval()
    tb = _torch_batch(_batch_np())
    with torch.no_grad():
        got = model(tb["mv"], tb["residual"], tb["flow"] if with_flow
                    else None)
    assert len(got) == 3
    rows = B * S * (2 if with_flow else 1)
    assert tuple(got[2].shape) == (rows, 2)
    for g, w in zip((got[0], _nhwc(got[1]), got[2]), want):
        np.testing.assert_allclose(np.asarray(g), w, rtol=FWD_RTOL,
                                   atol=FWD_ATOL)


@pytest.mark.parametrize("arch_d", [None, "Discriminator"])
def test_cue_detached_exactly_without_discriminator(arch_d):
    """The classifier's gradient reaches the generator only when the model
    has a discriminator (dmcnet: model.py:352; dmcnet_GAN: model.py:560)."""
    torch.manual_seed(0)
    model = DMCNet(NUM_CLASS, num_segments=S, arch_estimator="DenseNetTiny",
                   gen_flow_or_delta=1, arch_d=arch_d, input_size=H)
    tb = _torch_batch(_batch_np())
    model(tb["mv"], tb["residual"])[0].sum().backward()
    grads = [p.grad for p in model.gen_flow_model.parameters()]
    if arch_d is None:
        assert all(g is None for g in grads)
    else:
        assert all(g is not None and bool(g.abs().sum() > 0) for g in grads)
    assert all(p.grad is not None for p in model.base_model.parameters())


@pytest.mark.parametrize("arch_d", DISCRIMINATORS)
def test_discriminator_train_mode_matches_jax(arch_d):
    """Each discriminator in train mode, dropout off on both sides: the
    output, the BN running statistics it leaves (batch statistics, eps
    0.8) and the gradients of a weighted sum with respect to every
    parameter and to the input."""
    import jax
    import jax.numpy as jnp

    from dmcnet_tpu.models.discriminators import make_discriminator

    rng = np.random.default_rng(3)
    x = rng.normal(size=(8, H, W, 2)).astype(np.float32)
    wout = rng.normal(size=(8, 2)).astype(np.float32)
    flax_d = make_discriminator(arch_d)
    shapes = jax.eval_shape(functools.partial(flax_d.init, train=False),
                            jax.random.key(0), jnp.asarray(x))
    draw_rng = np.random.default_rng(1)
    params, stats = (jax.tree_util.tree_map_with_path(
        lambda p, s: _draw(p, s.shape, draw_rng).astype(np.float32),
        shapes[c]) for c in ("params", "batch_stats"))

    def loss(p, xx):
        out, mutated = flax_d.apply(
            {"params": p, "batch_stats": stats}, xx, train=True,
            mutable=["batch_stats"], rngs={"dropout": jax.random.key(0)})
        return jnp.sum(out * wout), (out, mutated["batch_stats"])

    with jax_dropout_off():
        (_, (want_out, want_stats)), (want_gp, want_gx) = jax.jit(
            jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(
            params, jnp.asarray(x))
    wrap = lambda t: {"discriminator": jax.tree.map(np.asarray, t)}  # noqa

    d = dropout_off(tdisc.make_discriminator(arch_d, input_size=H)).train()
    sd = state_dict_from_flax(wrap(params), wrap(stats))
    d.load_state_dict({k[len("discriminator."):]: v for k, v in sd.items()})
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()
    out = d(xt)
    (out * torch.from_numpy(wout)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out),
                               rtol=FWD_RTOL, atol=FWD_ATOL)
    np.testing.assert_allclose(_nhwc(xt.grad), np.asarray(want_gx),
                               rtol=1e-3, atol=1e-5)
    got_sd = {"discriminator." + k: v for k, v in d.state_dict().items()}
    _assert_close_to(got_sd, wrap(params), wrap(want_stats), 1e-4, 1e-6,
                     "running statistics")
    got_grads = {"discriminator." + n: p.grad for n, p in
                 d.named_parameters()}
    want_grads = state_dict_from_flax(wrap(want_gp), wrap(stats))
    for k, g in got_grads.items():
        np.testing.assert_allclose(g.numpy(), want_grads[k].numpy(),
                                   rtol=1e-3, atol=1e-5, err_msg=k)


def test_dropout2d_statistics():
    """Train-mode dropout in both packages: whole channels dropped at rate
    0.25 and the kept ones scaled by 4/3, over 200,000 channel draws."""
    import jax
    import flax.linen as fnn

    d = tdisc.make_discriminator("Discriminator", input_size=H)
    drops = [m for m in d.modules() if isinstance(m, torch.nn.Dropout2d)]
    assert len(drops) == 4 and all(m.p == 0.25 for m in drops)
    n, c = 1000, 200
    torch.manual_seed(0)
    got = drops[0].train()(torch.ones(n, c, 3, 3)).numpy()
    want = np.asarray(fnn.Dropout(rate=0.25, broadcast_dims=(1, 2)).apply(
        {}, np.ones((n, 3, 3, c), np.float32), deterministic=False,
        rngs={"dropout": jax.random.key(0)})).transpose(0, 3, 1, 2)
    for side, y in (("port", got), ("jax", want)):
        per_channel = y.reshape(n * c, 9)
        assert (per_channel == per_channel[:, :1]).all(), side
        np.testing.assert_allclose(np.unique(y), [0.0, 4 / 3], rtol=1e-6,
                                   err_msg=side)
        share = float((per_channel[:, 0] == 0).mean())
        # 4 standard deviations of a binomial share over n * c draws
        assert abs(share - 0.25) < 4 * (0.25 * 0.75 / (n * c)) ** 0.5, \
            (side, share)


def _bridge(tree, stats):
    """A flax tree shaped like the params (gradients, moments) -> port
    keys, through the weight bridge."""
    return state_dict_from_flax(tree, stats)


def test_optimizer_groups_match_jax():
    """Three optimizers against the JAX package's lr_mult_tree and
    decay_mult_tree, then two epochs of synthetic gradients through all
    three, the first frozen the GAN's way (the classifier at lr 0), against
    GroupAdam."""
    import jax
    import jax.numpy as jnp

    from dmcnet_tpu.train.engine import make_optimizers
    from dmcnet_tpu.train.optimizers import decay_mult_tree

    fmodel, params, stats = _flax_gan("Discriminator")
    opts = make_optimizers(fmodel, params, LR_CLS_MULT, LR_MSE_MULT,
                           LR_D_MULT)
    model = _port_gan("Discriminator")
    t_opts = topt.make_optimizers(model, LR_CLS_MULT, LR_MSE_MULT, LR_D_MULT)
    assert len(t_opts) == 3
    names = {id(p): n for n, p in model.named_parameters()}
    full = lambda tree: jax.tree.map(  # noqa: E731
        lambda m, p: np.full(p.shape, m, np.float32), tree, params)
    decay = _bridge(full(decay_mult_tree(params)), stats)
    for key, t_opt in zip(("cls", "gf", "d"), t_opts):
        lr_mults = _bridge(full(opts[key].lr_mults), stats)
        owned = {k for k, v in lr_mults.items()
                 if not k.endswith(("running_mean", "running_var",
                                    "num_batches_tracked"))
                 and bool((v != 0).all())}
        got = {}
        for group in t_opt.param_groups:
            for p in group["params"]:
                got[names[id(p)]] = (group["lr_mult"], group["decay_mult"])
        assert set(got) == owned, key
        for k, (lm, dm) in got.items():
            assert float(lr_mults[k].flatten()[0]) == lm, k
            assert float(decay[k].flatten()[0]) == dm, k

    updates = {k: jax.jit(o.update) for k, o in opts.items()}
    states = {k: o.init(params) for k, o in opts.items()}
    p = params
    for epoch, freeze in enumerate((True, False)):
        lr = LR
        topt.adjust_learning_rate(t_opts[:1], 0.0 if freeze else lr, WD)
        topt.adjust_learning_rate(t_opts[1:], lr, WD)
        for it in range(2):
            rng = np.random.default_rng(100 * epoch + it)
            grads = jax.tree.map(lambda x: 0.01 * rng.standard_normal(
                x.shape, dtype=np.float32), p)
            for k in ("cls", "gf", "d"):
                k_lr = 0.0 if (k == "cls" and freeze) else lr
                p, states[k] = updates[k](grads, states[k], p,
                                          jnp.float32(k_lr), jnp.float32(WD))
            tgrads = _bridge(grads, stats)
            for name, param in model.named_parameters():
                param.grad = tgrads[name].clone()
            for t_opt in t_opts:
                t_opt.step()
                t_opt.zero_grad()
        _assert_close_to(model.state_dict(), jax.tree.map(np.asarray, p),
                         stats, 5e-4, 5e-6, f"epoch {epoch}")
        if freeze:
            for k, v in model.base_model.state_dict().items():
                want = _bridge(params, stats)["base_model." + k]
                assert torch.equal(v, want), f"frozen base_model.{k} moved"


@functools.lru_cache(maxsize=None)
def _jax_gan_steps():
    """The JAX package's D, G and D steps (float64, dropout off) from the
    `_flax_gan("Discriminator")` initialisation, and a frozen D step from
    the same initialisation: {"steps": [(metrics, params, batch_stats)],
    "frozen": (metrics, params, batch_stats, opt_cls)} as numpy."""
    import jax
    import jax.numpy as jnp

    from dmcnet_tpu.train.engine import TrainState, make_optimizers
    from dmcnet_tpu.train.engine_gan import make_gan_train_steps

    fmodel, params, stats = _flax_gan("Discriminator")
    to_np = functools.partial(jax.tree.map, np.asarray)
    with jax.enable_x64(True), jax_dropout_off():
        to64 = functools.partial(jax.tree.map, lambda a: jnp.asarray(
            a, jnp.float64))
        params64, stats64 = to64(params), to64(stats)
        opts = make_optimizers(fmodel, params64, LR_CLS_MULT, LR_MSE_MULT,
                               LR_D_MULT)
        state0 = TrainState(params=params64, batch_stats=stats64,
                            opt_cls=opts["cls"].init(params64),
                            opt_gf=opts["gf"].init(params64),
                            opt_d=opts["d"].init(params64))
        d_step, g_step = (jax.jit(f) for f in make_gan_train_steps(
            fmodel, opts, num_segments=S, jit=False, **LOSS_W))
        batch = {k: jnp.asarray(v) for k, v in _batch_np(np.float64).items()}
        rng = jax.random.key(1)
        f64 = jnp.float64
        steps, state = [], state0
        for kind, lr_cls in STEPS:
            fn = d_step if kind == "d" else g_step
            state, m = fn(state, batch, rng, f64(LR), f64(lr_cls), f64(LR),
                          f64(WD))
            steps.append((to_np(m), to_np(state.params),
                          to_np(state.batch_stats)))
        frozen, m = d_step(state0, batch, rng, f64(LR), f64(0.0), f64(LR),
                           f64(WD))
        return {"steps": steps,
                "frozen": (to_np(m), to_np(frozen.params),
                           to_np(frozen.batch_stats), to_np(frozen.opt_cls))}


def _port_gan_steps(model, bf16=False):
    """(optimizers, d_step, g_step) of the port on `model`, lr as in the
    JAX steps."""
    opts = topt.make_optimizers(model, LR_CLS_MULT, LR_MSE_MULT, LR_D_MULT)
    topt.adjust_learning_rate(opts, LR, WD)
    return (opts,) + engine_gan.make_gan_train_steps(
        model, *opts, num_segments=S, bf16=bf16, **LOSS_W)


def _assert_metrics(got, want, keys, what):
    assert set(got) == set(keys), what
    for k in keys:
        np.testing.assert_allclose(float(got[k]), float(want[k]),
                                   rtol=STEP_RTOL, atol=1e-12,
                                   err_msg=f"{what}: {k}")


def test_gan_steps_match_jax():
    """D, G and D steps in float64 against the JAX package's: losses, top-1
    / top-5 and the adversarial accuracy of each step, then every
    parameter and BN running statistic after each step.  The D step leaves
    the generator, the G step the classifier and the discriminator
    bit-unchanged."""
    want = _jax_gan_steps()["steps"]
    _, params, stats = _flax_gan("Discriminator")
    model = dropout_off(_port_gan("Discriminator")).double()
    _, d_step, g_step = _port_gan_steps(model)
    tbatch = _torch_batch(_batch_np(np.float64))
    for i, ((kind, _), (w_metrics, w_params, w_stats)) in enumerate(
            zip(STEPS, want)):
        before = {k: v.clone() for k, v in model.named_parameters()}
        if kind == "d":
            got = d_step(tbatch)
            _assert_metrics(got, w_metrics, _D_METRICS, f"D step {i}")
            still = ("gen_flow_model.",)
        else:
            got = g_step(tbatch)
            _assert_metrics(got, w_metrics, _G_METRICS, f"G step {i}")
            still = ("base_model.", "discriminator.")
        for k, v in model.named_parameters():
            moved = not torch.equal(v, before[k])
            assert moved != k.startswith(still), f"step {i} ({kind}): {k}"
        _assert_close_to(model.state_dict(), w_params, w_stats, STATE_RTOL,
                         STATE_ATOL, f"after step {i} ({kind})")


def test_frozen_d_step_matches_jax():
    """A D step in the freeze phase (the classifier at lr 0) on both sides:
    the classifier's parameters bit-unchanged, its Adam moments and step
    count moved as the JAX package's; the discriminator trained."""
    import jax

    w_metrics, w_params, w_stats, w_opt = _jax_gan_steps()["frozen"]
    _, params, stats = _flax_gan("Discriminator")
    model = dropout_off(_port_gan("Discriminator")).double()
    (opt_cls, _, _), d_step, _ = _port_gan_steps(model)
    topt.adjust_learning_rate((opt_cls,), 0.0, WD)
    cls_before = {k: v.clone() for k, v in model.base_model.state_dict()
                  .items() if not k.endswith(("running_mean", "running_var",
                                              "num_batches_tracked"))}
    d_before = {k: v.clone() for k, v in
                model.discriminator.named_parameters()}
    _assert_metrics(d_step(_torch_batch(_batch_np(np.float64))), w_metrics,
                    _D_METRICS, "frozen D step")
    for k, v in cls_before.items():
        assert torch.equal(model.base_model.state_dict()[k], v), k
    for got, init in zip(jax.tree.leaves(w_params["base_model"]),
                         jax.tree.leaves(params["base_model"])):
        np.testing.assert_array_equal(got, init)
    assert all(not torch.equal(v, d_before[k])
               for k, v in model.discriminator.named_parameters())
    _assert_close_to(model.state_dict(), w_params, w_stats, STATE_RTOL,
                     STATE_ATOL, "after the frozen D step")
    assert int(w_opt["count"]) == 1
    names = {id(p): n for n, p in model.named_parameters()}
    for slot, jax_slot in (("exp_avg", "mu"), ("exp_avg_sq", "nu")):
        want = _bridge64({"base_model": w_opt[jax_slot]["base_model"]},
                         {"base_model": stats["base_model"]})
        for p, st in opt_cls.state.items():
            assert float(st["step"]) == 1.0
            assert bool(st[slot].abs().sum() > 0), (names[id(p)], slot)
            np.testing.assert_allclose(
                st[slot].numpy(), want[names[id(p)]].numpy(),
                rtol=STATE_RTOL, atol=STATE_ATOL,
                err_msg=f"{names[id(p)]} {slot}")
        assert len(opt_cls.state) == len(list(model.base_model.parameters()))


def test_gan_steps_bf16_losses_are_float32():
    """Under `bf16` the outputs are cast to float32 before the losses: the
    losses come back float32 and near the float32 step's."""
    torch.manual_seed(0)
    ref = dropout_off(DMCNet(NUM_CLASS, num_segments=S,
                             arch_estimator="DenseNetTiny",
                             gen_flow_or_delta=1, arch_d="Discriminator",
                             input_size=H))
    tbatch = _torch_batch(_batch_np())
    for bf16 in (False, True):
        model = DMCNet(NUM_CLASS, num_segments=S,
                       arch_estimator="DenseNetTiny", gen_flow_or_delta=1,
                       arch_d="Discriminator", input_size=H)
        model.load_state_dict(ref.state_dict())
        _, d_step, g_step = _port_gan_steps(dropout_off(model), bf16=bf16)
        m = {**d_step(tbatch), **g_step(tbatch)}
        assert all(v.dtype == torch.float32 for v in m.values())
        if not bf16:
            want = m
    for k in ("loss_cls", "loss_adv", "loss_mse"):
        np.testing.assert_allclose(float(m[k]), float(want[k]), rtol=0.05,
                                   err_msg=k)


def test_gan_steps_need_a_discriminator_and_no_attention():
    torch.manual_seed(0)
    for kw in ({}, {"arch_d": "Discriminator", "att": 1,
                    "arch_estimator": "ContextNetwork"}):
        model = DMCNet(NUM_CLASS, num_segments=S, input_size=H, **kw)
        opts = topt.make_optimizers(model, 1.0, 1.0, 1.0) if "arch_d" in kw \
            else topt.make_optimizers(model, 1.0, 1.0) + (None,)
        with pytest.raises(ValueError):
            engine_gan.make_gan_train_steps(
                model, *opts, num_segments=S, **LOSS_W)


@pytest.mark.parametrize("arch_estimator,att", [("DenseNetTiny", 0),
                                                ("ContextNetwork", 1)])
def test_eval_step_with_discriminator_matches_jax(arch_estimator, att):
    """`make_eval_step` on a model with a discriminator reads the logits
    and the cue at outs[0] and outs[1] and the attention at outs[-1], as
    the JAX eval step does; a padded row of weight 0 is masked."""
    import jax.numpy as jnp

    from dmcnet_tpu.train.engine import TrainState, make_eval_step

    fmodel, params, stats = _flax_gan("Discriminator4", arch_estimator, att)
    batch = _batch_np()
    padded = {k: np.concatenate([v, v[-1:]]) for k, v in batch.items()}
    padded["weight"] = np.asarray([1, 1, 0], np.float32)
    want = make_eval_step(fmodel, num_segments=S, lr_cls_w=1.0,
                          lr_mse_w=0.5)(
        TrainState(params=params, batch_stats=stats, opt_cls=None,
                   opt_gf=None),
        {k: jnp.asarray(v) for k, v in padded.items()})
    model = _port_gan("Discriminator4", arch_estimator, att)
    got = tengine.make_eval_step(model, num_segments=S, lr_cls_w=1.0,
                                 lr_mse_w=0.5)(_torch_batch(padded))
    for k in ("loss", "loss_cls", "loss_mse", "top1", "top5"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-4,
                                   err_msg=k)
    np.testing.assert_allclose(got["logits"].numpy(),
                               np.asarray(want["logits"]), rtol=FWD_RTOL,
                               atol=FWD_ATOL)


@pytest.mark.parametrize("arch_d", DISCRIMINATORS)
def test_state_dict_from_flax_round_trips_gan_model(arch_d):
    """flax variables of a DMCNet with `arch_d` -> the port's state dict
    (loaded strictly) -> the JAX package's torch importer -> the same flax
    variables, leaf for leaf."""
    import jax

    from dmcnet_tpu.models.import_torch import import_state_dict

    _, params, stats = _flax_gan(arch_d)
    model = _port_gan(arch_d)
    assert any(k.startswith("discriminator.adv_layer")
               for k in model.state_dict())
    back, skipped = import_state_dict(model.state_dict())
    assert skipped == []
    for coll, want in (("params", params), ("batch_stats", stats)):
        got = back[coll]
        assert jax.tree.structure(got) == jax.tree.structure(want), coll
        for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            np.testing.assert_array_equal(np.asarray(g), w)


def test_dmcnet_weights_into_gan_model(tmp_path):
    """`--weights` from a dmcnet (no-GAN) checkpoint into a GAN model, as
    examples/hmdb51_gan/run.sh does: everything but `discriminator.*`
    loads, and those keys are reported missing and keep their
    initialisation."""
    torch.manual_seed(0)
    src = DMCNet(NUM_CLASS, num_segments=S, arch_estimator="DenseNetTiny",
                 gen_flow_or_delta=1)
    path = str(tmp_path / "dmcnet.pth.tar")
    tckpt.save_checkpoint(src, {"epoch": 1, "arch": "resnet18",
                                "best_prec1": 0.0}, path)
    torch.manual_seed(1)
    dst = DMCNet(NUM_CLASS, num_segments=S, arch_estimator="DenseNetTiny",
                 gen_flow_or_delta=1, arch_d="Discriminator", input_size=H)
    before = {k: v.clone() for k, v in dst.state_dict().items()}
    skipped, missing = tckpt.load_reference_weights(dst, path)
    assert skipped == []
    assert missing == sorted(k for k in before
                             if k.startswith("discriminator."))
    assert len(missing) == 4 * 2 + 3 * 5 + 2  # convs, BNs, adv_layer
    for k, v in dst.state_dict().items():
        want = before[k] if k in missing else src.state_dict()[k]
        assert torch.equal(v, want), k


def test_checkpoint_with_optimizer_d_and_exact_resume(tmp_path):
    """save_checkpoint -> load_checkpoint carries `optimizer_d` with the
    other two; a D+G pair after the reload runs bit-equal to the
    uninterrupted run; the file serves through DMCPredictor, which drops
    the discriminator."""
    from dmcnet_tpu_torch.serving import DMCPredictor

    def build(seed):
        torch.manual_seed(seed)
        return DMCNet(NUM_CLASS, num_segments=S,
                      arch_estimator="DenseNetTiny", gen_flow_or_delta=1,
                      arch_d="Discriminator4", input_size=H)

    # dropout masks come from torch's generator: reseed before each pair
    model = build(0)
    batch = _torch_batch(_batch_np())
    opts, d_step, g_step = _port_gan_steps(model)
    d_step(batch)
    g_step(batch)
    name = tckpt.checkpoint_name(str(tmp_path / "gan"), "mv")
    meta = {"epoch": 1, "arch": "resnet18", "best_prec1": 20.0}
    tckpt.save_checkpoint(model, meta, name, opts)
    payload = torch.load(name, map_location="cpu", weights_only=True)
    assert set(payload) == {"epoch", "arch", "best_prec1", "state_dict",
                            "optimizer_cls", "optimizer_gf", "optimizer_d"}
    assert payload["optimizer_d"]["state"]

    model2 = build(1)
    opts2, d_step2, g_step2 = _port_gan_steps(model2)
    assert tckpt.load_checkpoint(name, model2, opts2) == meta
    for o, o2 in zip(opts, opts2):
        s, s2 = o.state_dict(), o2.state_dict()
        assert s["param_groups"] == s2["param_groups"]
        for i, st in s["state"].items():
            assert all(torch.equal(v, s2["state"][i][k])
                       for k, v in st.items()), i
    results = []
    for m_d, m_g in ((d_step, g_step), (d_step2, g_step2)):
        torch.manual_seed(7)
        results.append({**m_d(batch), **m_g(batch)})
    assert all(torch.equal(results[0][k], results[1][k]) for k in results[0])
    for k, v in model.state_dict().items():
        assert torch.equal(v, model2.state_dict()[k]), f"resume: {k}"
    for o, o2 in zip(opts, opts2):
        assert float(o.state_dict()["state"][0]["step"]) == \
            float(o2.state_dict()["state"][0]["step"])

    pred = DMCPredictor.from_checkpoint(name, num_class=NUM_CLASS,
                                        device="cpu")
    mv = torch.randint(0, 256, (2, H, W, 2), dtype=torch.uint8)
    res = torch.randint(0, 256, (2, H, W, 3), dtype=torch.uint8)
    assert pred._forward_u8(mv, res).shape == (2, NUM_CLASS)


# --- on the card: the same steps, card against CPU (no flax needed) -------

@pytest.mark.cuda
def test_cuda_gan_steps_match_cpu():
    """D, G and D steps on the card against the CPU, dropout off: in
    float64 every parameter and BN statistic after the three steps within
    rtol 5e-4, atol 5e-6 (tests/test_torch_train.py's card-vs-CPU
    tolerance), and in float32 with TF32 off the first D step's losses
    and accuracies at rtol 1e-4."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        for dtype, kinds in ((torch.float32, ("d",)),
                             (torch.float64, ("d", "g", "d"))):
            torch.manual_seed(0)
            cpu = dropout_off(DMCNet(
                NUM_CLASS, num_segments=S, arch_estimator="DenseNetTiny",
                gen_flow_or_delta=1, arch_d="Discriminator",
                input_size=H)).to(dtype=dtype)
            gpu = dropout_off(DMCNet(
                NUM_CLASS, num_segments=S, arch_estimator="DenseNetTiny",
                gen_flow_or_delta=1, arch_d="Discriminator",
                input_size=H)).to(dtype=dtype)
            gpu.load_state_dict(cpu.state_dict())
            gpu.cuda()
            np_batch = _batch_np(np.float32 if dtype == torch.float32
                                 else np.float64)
            sides = []
            for model, device in ((cpu, "cpu"), (gpu, "cuda")):
                _, d_step, g_step = _port_gan_steps(model)
                batch = _torch_batch(np_batch, device)
                sides.append([(d_step if k == "d" else g_step)(batch)
                              for k in kinds])
            for i, (w, g) in enumerate(zip(*sides)):
                for k, v in w.items():
                    np.testing.assert_allclose(
                        float(g[k]), float(v), rtol=1e-4,
                        err_msg=f"{dtype} step {i}: {k}")
        ref = cpu.state_dict()
        for k, v in gpu.state_dict().items():
            if not k.endswith("num_batches_tracked"):
                np.testing.assert_allclose(v.cpu().numpy(), ref[k].numpy(),
                                           rtol=5e-4, atol=5e-6, err_msg=k)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32


@pytest.mark.cuda
@pytest.mark.parametrize("arch_d", DISCRIMINATORS)
def test_cuda_gan_forward_matches_cpu(arch_d):
    """DMCNet+D in eval mode with the real flow, card against CPU (float32,
    TF32 off): logits, cue and validity at rtol 1e-4, atol 2e-4."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        torch.manual_seed(0)
        cpu = DMCNet(NUM_CLASS, num_segments=S, arch_estimator="DenseNetTiny",
                     gen_flow_or_delta=1, arch_d=arch_d,
                     input_size=H).eval()
        gpu = DMCNet(NUM_CLASS, num_segments=S, arch_estimator="DenseNetTiny",
                     gen_flow_or_delta=1, arch_d=arch_d, input_size=H)
        gpu.load_state_dict(cpu.state_dict())
        gpu.cuda().eval()
        np_batch = _batch_np()
        with torch.no_grad():
            want = cpu(*(_torch_batch(np_batch)[k]
                         for k in ("mv", "residual", "flow")))
            got = gpu(*(_torch_batch(np_batch, "cuda")[k]
                        for k in ("mv", "residual", "flow")))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.cpu().numpy(), w.numpy(),
                                       rtol=FWD_RTOL, atol=FWD_ATOL)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
