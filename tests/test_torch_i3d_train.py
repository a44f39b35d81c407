"""The port's I3D training pieces (the classifier's dropout,
`train/optimizers.make_i3d_optimizers`, `train/engine_i3d.make_i3d_steps`,
`train/lr_scheduler.py`, `train/callback.py`, the metric lists, the I3D
checkpoints, `models/initializer.py`, `models/import_tf_i3d.py`,
`models/weights.load_reference_i3d_2d`, `data/image_iterator.py` and the
stage-2 swap of `cli/train_i3d.train`) against the JAX package on the CPU.

Variables have the shapes the JAX package's flax `init` gives (traced, not
run) and values drawn with numpy from a seed (tests/test_torch_i3d.py
`draw_variables`, He-scaled), bridged by `state_dict_from_flax`.  Clips are
B = 2, T = 4, 48x48, 5 classes: torch's train-mode BatchNorm needs more
than one value per channel, and at 32x32 the last Inception blocks
normalize the 2 values of a 1x1x1 map, which makes the gradients of the two
frameworks drift apart (measured).

Dropout: each framework draws its own masks, so every comparison of a
train-mode step builds the I3D with dropout 0 and zeroes the
discriminator's `Dropout2d` on both sides (tests/test_torch_gan.py
`dropout_off`, `jax_dropout_off`); `test_dropout_statistics` checks the
dropout itself.

The macro steps (iter-size 2) run in float64 on both sides, compared
through the float64 weight bridge of tests/test_torch_gan.py: losses and
accuracies, every parameter and BN running statistic within rtol 1e-6,
atol 1e-9 (STEP_RTOL, STEP_ATOL), each carried gradient within atol 1e-9 +
1e-6 x its tensor's largest |value| (gradients reach ~4e3 here, and an
element near 0 of such a tensor carries the tensor's rounding).  Measured
worst on a CPU: parameters 1.0e-11, losses 3.2e-12 (Adam, with a GAN);
losses 6.5e-10, state 4.0e-11 (SGD, no GAN); carried gradients 1.2e-7, 1.5e-4
of their tolerance.  Adam's eps is 1e-8 here: an update depends on a
gradient element near 1e-7 as 1/eps, so the steps run at lr 2e-5, where
the frameworks' ~1e-10 relative gradient noise stays far below atol, and a
float32 comparison would read float32's noise.

The JAX package is imported inside the helpers: the `cuda`-marked twins at
the end hold the card against the CPU and need no flax.
"""

import contextlib
import functools
import io
import logging
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
from test_torch_gan import _bridge64, dropout_off, jax_dropout_off
from test_torch_i3d import draw_variables
from test_torch_train import _two_torch_threads  # noqa: F401

from dmcnet_tpu_torch.models import i3d as ti3d
from dmcnet_tpu_torch.models import initializer as tinit
from dmcnet_tpu_torch.models import import_tf_i3d as ttf
from dmcnet_tpu_torch.models.weights import (
    load_reference_i3d_2d,
    state_dict_from_flax,
)
from dmcnet_tpu_torch.train import callback as tcallback
from dmcnet_tpu_torch.train import checkpoints as tckpt
from dmcnet_tpu_torch.train import engine_i3d
from dmcnet_tpu_torch.train import lr_scheduler as tsched
from dmcnet_tpu_torch.train import metrics as tmetrics
from dmcnet_tpu_torch.train.optimizers import make_i3d_optimizers

B, T, HW, NUM_CLASS, ITER = 2, 4, 48, 5, 2
STEP_RTOL, STEP_ATOL = 1e-6, 1e-9
LR, LR1, LR_D, WD, ADV = 2e-5, 1e-5, 4e-5, 1e-4, 0.7
LR_MUL = 0.5                    # base layers at half the classifier's lr
# case: (optimizer, GAN, lr scale, steps); each step is (kind, drop_cls).
# The GAN case runs the D -> G -> D -> G carry with the classification term
# dropped in the first G step only.  SGD's steps are not normalized, and at
# Adam's lr the generator's (gradients up to ~4e3 here) would move by 0.1.
STEP_CASES = {
    "adam-gan": ("adam", True, 1.0, (("d", False), ("g", True),
                                     ("d", False), ("g", False))),
    "sgd-no-gan": ("sgd", False, 0.1, (("g", True), ("g", False))),
}
_D_METRICS = ("loss", "loss_cls", "loss_adv", "top1", "top5", "acc_D_adv")
_G_METRICS = ("loss", "loss_cls", "loss_mse", "top1", "top5")


def _device_zeros(x):
    """`jnp.zeros_like(x)` without compiling a program for each shape:
    numpy zeros put on the device."""
    import jax.numpy as jnp

    return jnp.asarray(np.zeros(x.shape, x.dtype))


@functools.lru_cache(maxsize=None)
def _flax_i3d():
    """(flax I3D with generator and discriminator, params, batch_stats) at
    B x T x HW x HW, numpy-drawn; the I3D's dropout rate is 0."""
    import jax
    import jax.numpy as jnp

    from dmcnet_tpu.models.i3d import get_symbol, init_i3d_variables

    net, _ = get_symbol("I3D", modality="flow+mp4", num_classes=NUM_CLASS,
                        arch_estimator="DenseNetTiny",
                        arch_d="Discriminator")
    shapes = jax.eval_shape(lambda: init_i3d_variables(
        net, jax.random.key(0), jnp.zeros((1, T, HW, HW, 5))))
    v = draw_variables(shapes)
    return net, v["params"], v["batch_stats"]


def _port_i3d(dtype=torch.float64, dropout_prob=0.0, remat=False):
    """The port's I3D with `_flax_i3d`'s weights, discriminator dropout
    off, in `dtype`."""
    _, params, stats = _flax_i3d()
    net, _ = ti3d.get_symbol("I3D", modality="flow+mp4",
                             num_classes=NUM_CLASS,
                             arch_estimator="DenseNetTiny",
                             arch_d="Discriminator", input_size=HW,
                             dropout_prob=dropout_prob, remat=remat)
    net.load_state_dict(_bridge64(params, stats))
    return dropout_off(net).to(dtype)


def _micro_np(seed, dtype=np.float64):
    """ITER microbatches of B clips, NDHWC numpy, stacked on axis 0."""
    rng = np.random.default_rng(seed)
    shape = (ITER, B, T, HW, HW)
    return {"mv": rng.normal(size=shape + (2,)).astype(dtype),
            "residual": rng.normal(size=shape + (3,)).astype(dtype),
            "flow": rng.normal(size=shape + (2,)).astype(dtype),
            "label": rng.integers(0, NUM_CLASS, size=(ITER, B))
            .astype(np.int32)}


def _micro_torch(batch, device="cpu"):
    """The stacked numpy microbatches -> a list of NCTHW batch dicts."""
    out = []
    for i in range(batch["label"].shape[0]):
        mb = {k: torch.from_numpy(np.ascontiguousarray(v[i]))
              .permute(0, 4, 1, 2, 3).contiguous().to(device)
              for k, v in batch.items() if k != "label"}
        mb["label"] = torch.as_tensor(batch["label"][i], dtype=torch.long,
                                      device=device)
        out.append(mb)
    return out


# --- the classifier's dropout -----------------------------------------------

def test_dropout_statistics():
    """Rate 0.85 on (B, 400) in both packages: the share of zeros within 4
    standard deviations of 0.85, every kept value x 1 / 0.15; the port's
    forward runs it between the time mean and the classifier, and its eval
    forward is that of an I3D without dropout."""
    import flax.linen as fnn
    import jax

    n, rate = 64, 0.85
    x = np.ones((n, 400), np.float32)
    jax_out = np.asarray(fnn.Dropout(rate).apply(
        {}, x, deterministic=False, rngs={"dropout": jax.random.key(0)}))
    torch.manual_seed(0)
    net = ti3d.I3D(NUM_CLASS, modality="flow+mp4",
                   arch_estimator="DenseNetTiny", input_size=HW,
                   dropout_prob=rate)
    port_out = net.dropout.train()(torch.from_numpy(x)).numpy()
    for side, out in (("jax", jax_out), ("port", port_out)):
        share = float((out == 0).mean())
        assert abs(share - rate) < 4 * (rate * (1 - rate) / out.size) ** 0.5, \
            (side, share)
        np.testing.assert_allclose(out[out != 0], 1 / (1 - rate), rtol=1e-6,
                                   err_msg=side)

    seen = []
    net.dropout.register_forward_hook(lambda m, i, o: seen.append(
        (tuple(i[0].shape), m.training)))
    clip = torch.randn(B, 5, T, HW, HW)
    with torch.no_grad():
        net.train()(clip, "flow+logit")
    plain = ti3d.I3D(NUM_CLASS, modality="flow+mp4",
                     arch_estimator="DenseNetTiny", input_size=HW)
    plain.load_state_dict(net.state_dict())
    with torch.no_grad():
        want, got = plain.eval()(clip), net.eval()(clip)
    assert seen[0] == ((B, 400), True)
    assert torch.equal(got, want)


# --- optimizers -------------------------------------------------------------

OPT_CASES = {"stage1-frozen": dict(freeze_base=True),
             "stage1": dict(lr_mul=0.2),
             "stage2-0.5": dict(stage2=True, lr_mul=0.5),
             "stage2-0.2": dict(stage2=True, lr_mul=0.2)}


@pytest.mark.parametrize("optim", ["adam", "sgd"])
@pytest.mark.parametrize("case", list(OPT_CASES))
def test_i3d_optimizer_groups_match_jax(case, optim):
    """Each optimizer's parameters, lr multipliers, decay multipliers and
    eps against the JAX package's mult trees: the classifier's optimizer
    owns every top-level module but the generator and the discriminator,
    the new layers at lr_mult 1, the base at 0 while frozen and 0.5 ->
    1.0 in stage 2; decay on every parameter, biases included."""
    import jax

    from dmcnet_tpu.train.engine_i3d import make_i3d_optimizers as jax_opts

    _, params, stats = _flax_i3d()
    kw = OPT_CASES[case]
    want = jax_opts(params, optim=optim, has_gan=True, **kw)
    model = _port_i3d(torch.float32)
    got = make_i3d_optimizers(model, optim=optim, has_gan=True, **kw)
    assert sorted(got) == sorted(want) == ["cls", "d", "gf"]
    names = {id(p): n for n, p in model.named_parameters()}
    full = lambda tree: state_dict_from_flax(jax.tree.map(  # noqa: E731
        lambda m, p: np.full(p.shape, m, np.float32), tree, params), stats)
    for key, opt in got.items():
        lr_mults, decay = full(want[key].lr_mults), full(want[key].decay_mults)
        owned = {k for k, v in lr_mults.items()
                 if not k.endswith(("running_mean", "running_var",
                                    "num_batches_tracked"))
                 and (k.split(".")[0] not in ("gen_flow_model",
                                              "discriminator")
                      if key == "cls" else bool((v != 0).all()))}
        seen = {}
        for group in opt.param_groups:
            for p in group["params"]:
                seen[names[id(p)]] = group
        assert set(seen) == owned, key
        for k, group in seen.items():
            assert np.float32(group["lr_mult"]) == lr_mults[k].flatten()[0], k
            assert group["decay_mult"] == float(decay[k].flatten()[0]) == 1.0
            if optim == "adam" or key == "d":
                assert isinstance(opt, torch.optim.Adam)
                assert group["eps"] == want[key].eps, (key, k)
            else:
                assert isinstance(opt, torch.optim.SGD)
                assert group["momentum"] == 0.9 and group["nesterov"]


def test_sgd_matches_group_sgd():
    """The classifier's nesterov SGD against `GroupSGD` on identical
    gradients, three steps with weight decay and the lr multipliers, in
    float64."""
    import jax
    import jax.numpy as jnp

    from dmcnet_tpu.train.engine_i3d import make_i3d_optimizers as jax_opts

    _, params, stats = _flax_i3d()
    with jax.enable_x64(True):
        p = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), params)
        opt = jax_opts(p, optim="sgd", lr_mul=LR_MUL)["cls"]
        state = opt.init(p)
        update = jax.jit(opt.update)
        model = _port_i3d()
        t_opt = make_i3d_optimizers(model, optim="sgd", lr_mul=LR_MUL)["cls"]
        for group in t_opt.param_groups:
            group["lr"], group["weight_decay"] = LR * group["lr_mult"], WD
        for it in range(3):
            rng = np.random.default_rng(it)
            grads = jax.tree.map(lambda x: 0.01 * rng.standard_normal(
                x.shape), p)
            p, state = update(grads, state, p, jnp.float64(LR),
                              jnp.float64(WD))
            tgrads = _bridge64(grads, stats)
            for name, param in model.named_parameters():
                param.grad = tgrads[name].clone()
            t_opt.step()
        want = _bridge64(jax.tree.map(np.asarray, p), stats)
    moved = 0
    for name, param in model.named_parameters():
        np.testing.assert_allclose(param.detach().numpy(),
                                   want[name].numpy(), rtol=1e-12,
                                   atol=1e-15, err_msg=name)
        moved += name.split(".")[0] not in ("gen_flow_model",
                                            "discriminator")
    assert moved == sum(len(g["params"]) for g in t_opt.param_groups)


# --- the LR driver ----------------------------------------------------------

@pytest.mark.parametrize("has_gan,detach", [(True, True), (True, False),
                                            (False, False)])
def test_lr_driver_matches_jax(has_gan, detach):
    """Both packages' `I3DLRDriver` through 3 stage-1 and 3 stage-2 epochs
    of 5 macro steps at iter-size 3, D and G alternating when a GAN is on:
    identical (lr, lr1, lr_d) sequences, warm-up halving and decays
    included; and a driver that starts in stage 2 seeds lr_d from sched3."""
    from dmcnet_tpu.train import lr_scheduler as jsched

    def drive(mod, start=0):
        steps = [2, 7, 30]
        scheds = [mod.MultiFactorScheduler(steps, base, 0.2)
                  for base in (4e-4, 3e-4, 2e-3)]
        drv = mod.I3DLRDriver(*scheds, epoch_thre=3, detach=detach,
                              has_gan=has_gan)
        return [drv.macro_step(epoch, has_gan and i % 2 == 0, 3)
                for epoch in range(start, 6) for i in range(5)]

    want, got = drive(jsched), drive(tsched)
    assert got == want
    assert len(set(got)) >= 3
    assert drive(tsched, start=3) == drive(jsched, start=3)
    if has_gan:
        assert drive(tsched, start=3)[0][2] is not None


# --- the steps against the JAX package's, float64 ---------------------------

@functools.lru_cache(maxsize=None)
def _jax_steps(case):
    """The JAX package's macro steps of STEP_CASES[case] from the
    `_flax_i3d` initialisation, float64, dropout off: [(metrics, params,
    batch_stats, grad_acc or None)] as numpy, one per step."""
    import jax
    import jax.numpy as jnp

    from dmcnet_tpu.train.engine import TrainState
    from dmcnet_tpu.train.engine_i3d import make_i3d_optimizers as jax_opts
    from dmcnet_tpu.train.engine_i3d import make_i3d_steps

    optim, gan, scale, steps = STEP_CASES[case]
    net, params, stats = _flax_i3d()
    to_np = functools.partial(jax.tree.map, np.asarray)
    with jax.enable_x64(True), jax_dropout_off():
        to64 = functools.partial(jax.tree.map, lambda a: jnp.asarray(
            a, jnp.float64))
        p64 = to64(params)
        opts = jax_opts(p64, optim=optim, lr_mul=LR_MUL, has_gan=gan)
        state = TrainState(
            params=p64, batch_stats=to64(stats),
            opt_cls=opts["cls"].init(p64), opt_gf=opts["gf"].init(p64),
            opt_d=opts["d"].init(p64) if gan else None,
            grad_acc=jax.tree.map(_device_zeros, p64) if gan else None)
        f64 = jnp.float64
        batches = [{k: jnp.asarray(v) for k, v in _micro_np(i).items()}
                   for i in range(len(steps))]

        def args(i, drop):
            return (batches[i], jax.random.key(i), f64(LR * scale),
                    f64(LR1 * scale), f64(LR_D * scale), f64(WD),
                    jnp.asarray(drop))

        # the case's D and G programs compile in two threads
        # (tests/test_torch_i3d_parallel.py): XLA's compiles overlap
        jitted = dict(zip("dg", (jax.jit(f) for f in make_i3d_steps(
            net, opts, adv=ADV, jit=False))))

        def compile_step(kind):
            with jax.enable_x64(True):   # a thread-local setting
                return jitted[kind].lower(state, *args(0, False)).compile()

        kinds = sorted({kind for kind, _ in steps})
        with ThreadPoolExecutor(len(kinds)) as pool:
            compiled = dict(zip(kinds, pool.map(compile_step, kinds)))
        out = []
        for i, (kind, drop) in enumerate(steps):
            state, m = compiled[kind](state, *args(i, drop))
            out.append((to_np(m), to_np(state.params),
                        to_np(state.batch_stats),
                        None if state.grad_acc is None
                        else to_np(state.grad_acc)))
        return out


def _port_steps(model, optim, gan, **kw):
    opts = make_i3d_optimizers(model, optim=optim, lr_mul=LR_MUL,
                               has_gan=gan)
    return opts, engine_i3d.make_i3d_steps(model, opts, adv=ADV, **kw)


def _assert_state(model, params, stats, grad_acc, what):
    """Every parameter and BN statistic of `model`, and its carried
    gradients when `grad_acc` is given, against the JAX trees."""
    want = _bridge64(params, stats)
    got = model.state_dict()
    assert set(got) == set(want), what
    for k, v in want.items():
        if not k.endswith("num_batches_tracked"):
            np.testing.assert_allclose(got[k].numpy(), v.numpy(),
                                       rtol=STEP_RTOL, atol=STEP_ATOL,
                                       err_msg=f"{what}: {k}")
    if grad_acc is None:
        return
    want = _bridge64(grad_acc, stats)
    for k, p in model.named_parameters():
        g = torch.zeros_like(p) if p.grad is None else p.grad
        w = want[k]
        np.testing.assert_allclose(
            g.numpy(), w.numpy(), rtol=0,
            atol=STEP_ATOL + STEP_RTOL * float(w.abs().max()),
            err_msg=f"{what}: the gradient of {k}")


@pytest.mark.parametrize("case,remat", [
    *(pytest.param(case, False, id=case) for case in STEP_CASES),
    pytest.param("adam-gan", True, id="adam-gan-remat-1"),
    pytest.param("adam-gan", "dots", id="adam-gan-remat-dots")])
def test_i3d_steps_match_jax(case, remat):
    """Macro steps of two microbatches in float64 against
    `make_i3d_steps`: each step's metrics, then every parameter, BN running
    statistic and, with a GAN, the carried gradient (the JAX state's
    grad_acc, the port's `.grad`).  The GAN case runs D -> G -> D -> G: the
    generator's D-phase gradient carried into the G step, the classifier's
    and the discriminator's G-phase gradients into the next D step, the
    classification term dropped in the first G step; the no-GAN case runs
    two G steps with SGD, which step the classifier too.  The GAN case,
    whose D/G `.grad` carry and discriminator cover most of the step, also
    runs the port with `remat` 1 and dots against the same JAX steps,
    without remat (the JAX package's remat equals its plain step,
    tests/test_i3d.py)."""
    optim, gan, scale, steps = STEP_CASES[case]
    want = _jax_steps(case)
    model = _port_i3d(remat=remat)
    _, (d_step, g_step) = _port_steps(model, optim, gan)
    before = {k: v.clone() for k, v in model.named_parameters()}
    for i, ((kind, drop), (w_m, w_params, w_stats, w_grad)) in enumerate(
            zip(steps, want)):
        got = (d_step if kind == "d" else g_step)(
            _micro_torch(_micro_np(i)), LR * scale, LR1 * scale,
            LR_D * scale, WD, drop)
        keys = _D_METRICS if kind == "d" else \
            _G_METRICS + (("loss_adv",) if gan else ())
        assert set(got) == set(keys) == set(w_m), (i, kind)
        for k in keys:
            np.testing.assert_allclose(float(got[k]), float(w_m[k]),
                                       rtol=STEP_RTOL, atol=STEP_ATOL,
                                       err_msg=f"step {i} ({kind}): {k}")
        _assert_state(model, w_params, w_stats, w_grad, f"after step {i}")
    moved = {k.split(".")[0] for k, v in model.named_parameters()
             if not torch.equal(v, before[k])}
    assert moved >= {"conv3d_1a_7x7", "classifier", "gen_flow_model"}
    assert ("discriminator" in moved) == gan


def test_stage2_swap_keeps_d_and_grad(tmp_path, monkeypatch):
    """`cli.train_i3d.train` across `--epoch-thre 1`, one D and one G macro
    step an epoch: at the first stage-2 step the discriminator's optimizer
    is the stage-1 one with its moments and step count, the classifier's
    and the generator's are new (stage-2 eps and lr multipliers, no
    state), and every carried `.grad` is the one stage 1 left."""
    from dmcnet_tpu_torch.cli import train_i3d

    calls = []  # per step: kind, optimizers, gradients before and after
    real = train_i3d.make_i3d_steps

    def recording(model, opts, **kw):
        def grads():
            return {k: None if p.grad is None else p.grad.clone()
                    for k, p in model.named_parameters()}

        def wrap(kind, fn):
            def step(micro, *a):
                call = {"kind": kind, "opts": dict(opts), "before": grads(),
                        "state": {k: _state_of(o) for k, o in opts.items()}}
                out = fn(micro, *a)
                calls.append(dict(call, after=grads()))
                return out
            return step
        d, g = real(model, opts, **kw)
        return wrap("d", d), wrap("g", g)

    monkeypatch.setattr(train_i3d, "make_i3d_steps", recording)
    monkeypatch.chdir(tmp_path)
    args = train_i3d.autofill(train_i3d.build_parser().parse_args(
        _tiny_flags(tmp_path) + ["--epoch-thre", "1", "--end-epoch", "2"]))
    with contextlib.redirect_stdout(io.StringIO()) as out:
        result = train_i3d.train(args, _TinyClips(4, 0), _TinyClips(2, 1),
                                 device="cpu", input_size=HW)
    assert out.getvalue().count("stage 2: fresh") == 1
    assert [c["kind"] for c in calls] == ["d", "g", "d", "g"]
    s1, s2 = calls[1], calls[2]   # the last stage-1 step, the first stage-2
    assert s2["opts"]["d"] is s1["opts"]["d"] is result.optimizers["d"]
    # its moments and step count as the stage-1 D step left them
    assert _same_state(s2["state"]["d"], s1["state"]["d"])
    assert all(float(st["step"]) == 1.0
               for st in s2["state"]["d"].values())
    assert s2["opts"]["cls"] is not s1["opts"]["cls"]
    assert s2["opts"]["gf"] is not s1["opts"]["gf"]
    assert s2["state"]["cls"] == {} and s2["state"]["gf"] == {}
    assert s1["state"]["cls"] != {} and s1["state"]["gf"] == {}
    assert s2["opts"]["gf"].param_groups[0]["eps"] == 1e-3
    assert {g["lr_mult"] for g in s2["opts"]["cls"].param_groups} == {1.0}
    assert {g["lr_mult"] for g in s1["opts"]["cls"].param_groups} == \
        {0.0, 1.0}
    # every gradient the stage-1 G step left reaches the stage-2 D step:
    # the generator's zeroed by its step, the discriminator's carried
    for k, g in s1["after"].items():
        assert torch.equal(s2["before"][k], g), k
        assert bool(g.any()) == k.startswith("discriminator."), k


class _TinyClips:
    """A `VideoClipDataset` stand-in of `n` random flow+mp4 clips (T x HW x
    HW x 7 uint8, label i % NUM_CLASS) for the CLI's loop."""

    modality = "flow+mp4"

    def __init__(self, n, seed):
        rng = np.random.default_rng(seed)
        self.clips = rng.integers(0, 256, size=(n, T, HW, HW, 7),
                                  dtype=np.uint8)

    def __len__(self):
        return len(self.clips)

    def __getitem__(self, i):
        return self.clips[i], i % NUM_CLASS


def _tiny_flags(tmp_path):
    return ["--modality", "flow+mp4", "--arch-estimator", "DenseNetTiny",
            "--arch-d", "Discriminator", "--adv", "1", "--optimizer", "adam",
            "--drop-out", "0", "--fine_tune", "0", "--batch-size", "2",
            "--iter-size", "1", "--clip-length", str(T), "--lr-base", "1e-3",
            "--lr-base2", "1e-3", "--lr-d", "2e-3", "--workers", "1",
            "--model-dir", str(tmp_path / "models"), "--task-name", "tiny",
            "--device", "cpu"]


def test_frozen_backbone_equals_lr1_zero():
    """`train_backbone=False` (stage 1 under --detach) against the full
    steps at lr1 = 0: after a D and a G macro step every parameter is
    bit-identical, and so are both steps' losses; the classifier's
    parameters never moved."""
    runs = []
    for tb in (True, False):
        model = _port_i3d(torch.float32)
        _, (d_step, g_step) = _port_steps(model, "adam", True,
                                          train_backbone=tb)
        batch = _micro_torch(_micro_np(0, np.float32))
        md = d_step(batch, LR, 0.0, LR_D, WD, True)
        mg = g_step(batch, LR, 0.0, LR_D, WD, True)
        runs.append((model, md["loss"], mg["loss"]))
        assert all(p.requires_grad for p in model.parameters())
    (full, d1, g1), (fast, d2, g2) = runs
    assert torch.equal(d1, d2) and torch.equal(g1, g2)
    init = _port_i3d(torch.float32).state_dict()
    for (k, v), w in zip(full.state_dict().items(),
                         fast.state_dict().values()):
        assert torch.equal(v, w), k
        if k.startswith(("conv3d_", "mixed_", "classifier")) \
                and not k.endswith(("running_mean", "running_var",
                                    "num_batches_tracked")):
            assert torch.equal(v, init[k]), k


@pytest.mark.parametrize("stop_gradient", [False, True])
def test_stop_gradient_gates_the_cls_gradient_to_the_generator(
        stop_gradient):
    """The cue reaches the stem undetached: a D step without the
    adversarial term leaves the classification gradient carried on the
    generator; `stop_gradient=True`, the non-reference fast mode, leaves
    none (tests/test_i3d.py's check of the JAX steps)."""
    model = _port_i3d(torch.float32)
    opts = make_i3d_optimizers(model, lr_mul=LR_MUL, has_gan=True)
    d_step, _ = engine_i3d.make_i3d_steps(model, opts, adv=0.0,
                                          stop_gradient=stop_gradient)
    d_step(_micro_torch(_micro_np(0, np.float32)), LR, LR1, LR_D, WD, False)
    gen = [p.grad for p in model.gen_flow_model.parameters()]
    assert all(g is not None for g in gen)
    assert any(bool(g.any()) for g in gen) != stop_gradient


# --- checkpoints ------------------------------------------------------------

def _trained(stage2=False):
    model = _port_i3d(torch.float32)
    opts, (d_step, g_step) = _port_steps(model, "adam", True)
    if stage2:
        opts.update({k: v for k, v in make_i3d_optimizers(
            model, lr_mul=LR_MUL, has_gan=True, stage2=True).items()
            if k != "d"})
        d_step, g_step = engine_i3d.make_i3d_steps(model, opts, adv=ADV)
    batch = _micro_torch(_micro_np(0, np.float32))
    d_step(batch, LR, LR1, LR_D, WD, True)
    g_step(batch, LR, LR1, LR_D, WD, True)
    return model, opts


def _state_of(opt):
    return {i: {k: v.clone() for k, v in st.items()}
            for i, st in opt.state_dict()["state"].items()}


def _same_state(a, b):
    return a.keys() == b.keys() and all(
        a[i].keys() == b[i].keys()
        and all(torch.equal(v, b[i][k]) for k, v in a[i].items()) for i in a)


@pytest.mark.parametrize("saved_stage2,resume_stage2",
                         [(False, False), (True, True), (False, True)],
                         ids=["stage1", "stage2", "across-epoch-thre"])
def test_i3d_checkpoint_round_trip(tmp_path, saved_stage2, resume_stage2):
    """A checkpoint with three optimizers and the carried gradients reloads
    bit-equal; a stage-1 file read into stage-2 optimizers (a resume at
    `--epoch-thre`) keeps the classifier's and the generator's optimizers
    fresh, as the swap would, and restores the discriminator's and the
    gradients.  `evaluate_video_i3d --load-weights` reads the file."""
    from dmcnet_tpu_torch.cli.evaluate_video_i3d import load_weights

    model, opts = _trained(saved_stage2)
    path = tckpt.save_i3d_checkpoint(
        model, opts, {"epoch": 3, "top1": 12.5, "stage2": saved_stage2},
        tckpt.i3d_checkpoint_name(str(tmp_path / "run"), 3))
    assert path.endswith("run_ep-0003.pth")
    model2 = _port_i3d(torch.float32)
    opts2 = make_i3d_optimizers(model2, lr_mul=LR_MUL, has_gan=True,
                                stage2=resume_stage2)
    meta = tckpt.load_i3d_checkpoint(path, model2, opts2, resume_stage2)
    assert meta == {"epoch": 3, "top1": 12.5, "stage2": saved_stage2}
    for (k, v), w in zip(model.state_dict().items(),
                         model2.state_dict().values()):
        assert torch.equal(v, w), k
    for (k, p), p2 in zip(model.named_parameters(), model2.parameters()):
        assert torch.equal(p.grad, p2.grad), k
    assert any(p.grad.any() for p in model2.parameters())
    swap = resume_stage2 and not saved_stage2
    for key in ("cls", "gf", "d"):
        want = {} if swap and key != "d" else _state_of(opts[key])
        assert _same_state(_state_of(opts2[key]), want), key
    assert opts2["gf"].param_groups[0]["eps"] == (1e-3 if resume_stage2
                                                  else 1e-8)
    net = ti3d.get_symbol("I3D", modality="flow+mp4", num_classes=NUM_CLASS,
                          arch_estimator="DenseNetTiny",
                          arch_d="Discriminator", input_size=HW)[0]
    load_weights(net, path, "flow+mp4")
    assert all(torch.equal(v, model.state_dict()[k])
               for k, v in net.state_dict().items()
               if not k.endswith("num_batches_tracked"))


# --- initialisers and importers ---------------------------------------------

@pytest.mark.parametrize("mode", ["inflation", "random"])
def test_inflation_matches_jax(mode):
    """`inflate_2d_kernel` against the JAX package's on one kernel, in the
    (C_out, C_in, t, kh, kw) layout; 'random' draws the same slice from
    the same seed."""
    from dmcnet_tpu.models import initializer as jinit

    rng = np.random.default_rng(0)
    w = rng.normal(size=(3, 3, 4, 8)).astype(np.float32)   # kh, kw, I, O
    for seed in (0, 1, 7):
        want = jinit.inflate_2d_kernel(w, 5, mode, seed)   # t, kh, kw, I, O
        got = tinit.inflate_2d_kernel(
            torch.from_numpy(w.transpose(3, 2, 0, 1)), 5, mode, seed)
        assert tuple(got.shape) == (8, 4, 5, 3, 3)
        np.testing.assert_allclose(got.numpy(),
                                   want.transpose(4, 3, 0, 1, 2), rtol=1e-7)
    with pytest.raises(ValueError, match="unknown inflation mode"):
        tinit.inflate_2d_kernel(torch.zeros(1, 1, 1, 1), 2, "other")


def test_xavier_init_shapes_and_bounds():
    """`xavier_init` against `xavier_init_tree`: the same keys and shapes,
    each weight within the JAX package's bound for its kernel, drawn over
    at least 0.9 of it, biases zero, BN parameters and statistics kept."""
    import jax

    from dmcnet_tpu.models.initializer import xavier_init_tree

    _, params, stats = _flax_i3d()
    want = _bridge64(xavier_init_tree(params, 0), stats)
    model = _port_i3d(torch.float32)
    sd = model.state_dict()
    got = tinit.xavier_init(sd, 0)
    assert got.keys() == sd.keys()
    for k, v in got.items():
        assert v.shape == sd[k].shape and v.dtype == sd[k].dtype, k
        if k.endswith(".bias"):
            assert not v.any() and not want[k].any(), k
        elif k.endswith(".weight") and v.ndim >= 2:
            bound = float(np.sqrt(6.0 / (v[0].numel() + v.shape[0])))
            w_max = float(want[k].abs().max())
            assert w_max <= bound * (1 + 1e-6), k
            assert 0.9 * bound <= float(v.abs().max()) <= bound * (1 + 1e-6), k
        else:
            assert torch.equal(v, sd[k]), k


def _tf_vars(prefix, in_stem):
    from test_import_tf_i3d import _synth_tf_vars

    return _synth_tf_vars(prefix, np.random.default_rng(5), in_stem=in_stem)


@pytest.mark.parametrize("modality,in_stem", [("rgb", 3), ("flow", 2),
                                              ("flow+mp4", 3)])
def test_import_tf_i3d_matches_jax(modality, in_stem):
    """`import_tf_i3d` / `load_tf_weights` on the synthetic TF variables of
    tests/test_import_tf_i3d.py against the JAX importer: every imported
    tensor equal after the weight bridge, the 3-channel stem channel-meaned
    onto a 2-channel model, the same report; a missing variable raises."""
    import jax
    import jax.numpy as jnp

    from dmcnet_tpu.models.i3d import I3D, init_i3d_variables
    from dmcnet_tpu.models.import_tf_i3d import load_tf_weights

    in_ch = 3 if modality == "rgb" else 2
    prefix = "RGB/inception_i3d" if modality == "rgb" else \
        "Flow/inception_i3d"
    tf_vars = _tf_vars(prefix, in_stem)
    net = I3D(num_classes=NUM_CLASS, modality=modality)
    shapes = jax.eval_shape(lambda: init_i3d_variables(
        net, jax.random.key(0), jnp.zeros((1, T, HW, HW, in_ch))))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    params, bstats, want_report = load_tf_weights(
        tf_vars, zeros["params"], zeros["batch_stats"], modality=modality,
        in_channels=in_ch)
    want = state_dict_from_flax(params, bstats)
    port = ti3d.I3D(NUM_CLASS, modality=modality)
    report, unfilled = ttf.load_tf_weights(
        tf_vars, port, modality=modality, in_channels=in_ch)
    assert report == want_report
    assert unfilled == ["classifier.bias", "classifier.weight"]
    got = port.state_dict()
    for k, v in want.items():
        if not k.startswith("classifier") and \
                not k.endswith("num_batches_tracked"):
            np.testing.assert_array_equal(got[k].numpy(), v.numpy(), k)
    stem = got["conv3d_1a_7x7.conv3d.weight"]
    assert stem.shape[1] == in_ch
    tf_vars.pop(f"{prefix}/Mixed_4c/Branch_3/Conv3d_0b_1x1/conv_3d/w")
    with pytest.raises(KeyError, match="Mixed_4c/Branch_3"):
        ttf.import_tf_i3d(tf_vars, modality=modality)


@pytest.mark.parametrize("mode", ["inflation", "random"])
def test_load_reference_i3d_2d_matches_jax(tmp_path, mode):
    """`load_reference_i3d_2d` against `load_i3d_pth_2d` on a 2D file of
    the I3D's module names (one temporal slice of every 3D kernel, an RGB
    stem, an unknown key): every tensor equal after the weight bridge and
    the same report."""
    from dmcnet_tpu.models.import_torch_i3d import load_i3d_pth_2d

    _, params, stats = _flax_i3d()
    src = state_dict_from_flax(params, stats)
    sd2 = {k: (v[:, :, v.shape[2] // 2] if v.ndim == 5 else v)
           for k, v in src.items()}
    stem = sd2["conv3d_1a_7x7.conv3d.weight"]
    sd2["conv3d_1a_7x7.conv3d.weight"] = torch.cat([stem, stem[:, :1]], 1)
    sd2["fc_extra.weight"] = torch.zeros(3, 3)
    path = str(tmp_path / "i3d_2d.pth")
    torch.save({"state_dict": {"module." + k: v for k, v in sd2.items()}},
               path)
    w_params, w_stats, want_report = load_i3d_pth_2d(
        path, params, stats, modality="flow+mp4", mode=mode, rng=3)
    want = state_dict_from_flax(w_params, w_stats)
    model = _port_i3d(torch.float32)
    report, unfilled = load_reference_i3d_2d(path, model, "flow+mp4",
                                             mode=mode, seed=3)
    assert report == want_report
    assert unfilled == []
    got = model.state_dict()
    for k, v in want.items():
        if not k.endswith("num_batches_tracked"):
            np.testing.assert_allclose(got[k].numpy(), v.numpy(),
                                       rtol=1e-6, atol=1e-7, err_msg=k)


# --- metrics, callbacks, image lists ----------------------------------------

def test_metric_list_matches_jax():
    from dmcnet_tpu.train import metrics as jmetrics

    rng = np.random.default_rng(0)
    lists = [mod.MetricList(mod.Loss("ce", 0), mod.Loss("mse", 1),
                            mod.Accuracy("top1", 1), mod.Accuracy("top5", 5))
             for mod in (jmetrics, tmetrics)]
    for _ in range(3):
        preds = rng.normal(size=(6, 10))
        labels = rng.integers(0, 10, size=6)
        losses = [rng.random(6), np.float64(rng.random())]
        for ml in lists:
            ml.update(preds, labels, losses)
    assert lists[1].get() == lists[0].get()
    assert lists[1].format() == lists[0].format()
    lists[1].reset()
    assert all(np.isnan(v) for _, v in lists[1].get())


def test_callbacks_match_jax(caplog):
    from dmcnet_tpu.train import callback as jcallback

    msgs = []
    for mod in (jcallback, tcallback):
        cbs = mod.CallbackList(mod.SpeedMonitor(), mod.MetricPrinter())
        with caplog.at_level(logging.INFO):
            msgs.append(cbs(epoch=2, batch=7, sample_elapse=0.5,
                            update_elapse=0.1, sample_inst=12,
                            namevals=[("loss", 0.25), ("top1", 0.5)]))
        msgs.append(cbs(silent=True))
        timer = mod.TimerDict()
        timer.tic("x")
        assert timer.toc("x") >= 0.0 and "x" in timer.t
    assert msgs[2:] == msgs[:2]
    assert msgs[0] == ("Epoch[2] Batch [7]\tSpeed: 24.00 samples/sec "
                       "(20.0% update)  loss = 0.25000  top1 = 0.50000")


def test_image_list_dataset_matches_jax(tmp_path):
    from PIL import Image

    from dmcnet_tpu.data.image_iterator import ImageListDataset as JaxImages
    from dmcnet_tpu_torch.data.image_iterator import ImageListDataset

    rng = np.random.default_rng(0)
    lines = []
    for i in range(3):
        img = rng.integers(0, 256, size=(8 + i, 10, 3), dtype=np.uint8)
        Image.fromarray(img if i != 1 else img[..., 0]).save(
            tmp_path / f"im{i}.png")
        lines.append(f"{i} {i * 2} im{i}.png")
    (tmp_path / "list.txt").write_text("\n".join(lines) + "\n\n")
    flip = lambda a: a[:, ::-1]  # noqa: E731
    for kw in ({}, {"transform": flip}, {"force_color": False}):
        want = JaxImages(str(tmp_path), str(tmp_path / "list.txt"), **kw)
        got = ImageListDataset(str(tmp_path), str(tmp_path / "list.txt"),
                               **kw)
        assert len(got) == len(want) == 3
        for i in range(3):
            (ga, gl), (wa, wl) = got[i], want[i]
            assert gl == wl == 2 * i
            np.testing.assert_array_equal(ga, wa)


# --- on the card: the same steps, card against CPU (no flax needed) ---------

@pytest.mark.cuda
def test_cuda_i3d_steps_match_cpu():
    """A D and a G macro step on the card against the CPU in float64, every
    parameter and BN statistic within rtol 5e-4, atol 5e-6
    (tests/test_torch_train.py's card-vs-CPU tolerance), and the losses
    at rtol 1e-6."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        torch.manual_seed(0)
        cpu = dropout_off(ti3d.get_symbol(
            "I3D", modality="flow+mp4", num_classes=NUM_CLASS,
            arch_estimator="DenseNetTiny", arch_d="Discriminator",
            input_size=HW)[0]).double()
        gpu = dropout_off(ti3d.get_symbol(
            "I3D", modality="flow+mp4", num_classes=NUM_CLASS,
            arch_estimator="DenseNetTiny", arch_d="Discriminator",
            input_size=HW)[0]).double()
        gpu.load_state_dict(cpu.state_dict())
        gpu.cuda()
        sides = []
        for model, device in ((cpu, "cpu"), (gpu, "cuda")):
            _, (d_step, g_step) = _port_steps(model, "adam", True)
            sides.append([
                d_step(_micro_torch(_micro_np(0), device), LR, LR1, LR_D, WD,
                       True),
                g_step(_micro_torch(_micro_np(1), device), LR, LR1, LR_D, WD,
                       True)])
        for w, g in zip(*sides):
            for k, v in w.items():
                np.testing.assert_allclose(float(g[k]), float(v), rtol=1e-6,
                                           err_msg=k)
        ref = cpu.state_dict()
        for k, v in gpu.state_dict().items():
            if not k.endswith("num_batches_tracked"):
                np.testing.assert_allclose(v.cpu().numpy(), ref[k].numpy(),
                                           rtol=5e-4, atol=5e-6, err_msg=k)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
