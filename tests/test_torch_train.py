"""The port's training path (dmcnet_tpu_torch/train, models completions)
against the JAX package on the CPU.

Variables have the shapes the JAX package's flax `init` gives and values
drawn with numpy from a seed, bridged by `state_dict_from_flax`; batches are
the numpy-seeded ones of tests/test_train_engine.py:20-40 (B=2, S=2,
32x32, 5 classes).  Tolerances:

  * losses, top-1 / top-5: rtol 1e-4;
  * parameters and BN running statistics after training: rtol 5e-4,
    atol 5e-6 (tests/test_optim_torch_parity.py:52-56);
  * forward outputs: rtol 1e-4, atol 2e-4 (tests/test_torch_models.py),
    float32.

The three train steps run in float64 on both sides.  In float32 they
measure float32 rather than the port: ResNet-18's last stage normalizes
each channel over B*S = 4 values at 32x32, which amplifies the frameworks'
summation-order differences to ~1e-4 of the classifier's gradient, and
Adam (eps 1e-3) turns a gradient error near eps into most of a step
(measured: conv1 weights 2e-4 to 7e-4 apart after one classifier step, at
64x64 too; on the H100 against the CPU, 8.8e-5 after one step of 1e-4 at
224x224).  The `cuda`-marked twins hold the card against the CPU in
float64 the same way, and the first step's losses in float32.

The JAX package is imported inside the helpers: the `cuda`-marked twins at
the end hold the card against the CPU and need no flax, which the H100
machine lacks.
"""

import functools

import numpy as np
import pytest
import torch

from dmcnet_tpu_torch.models.tsn import DMCNet, PlainTSN
from dmcnet_tpu_torch.models.weights import state_dict_from_flax
from dmcnet_tpu_torch.train import checkpoints as tckpt
from dmcnet_tpu_torch.train import engine as tengine
from dmcnet_tpu_torch.train import optimizers as topt

B, S, H, W, NUM_CLASS = 2, 2, 32, 32, 5
LOSS_RTOL = 1e-4
PARAM_RTOL, PARAM_ATOL = 5e-4, 5e-6
FWD_RTOL, FWD_ATOL = 1e-4, 2e-4
LR, WD = 1e-3, 0.05                # a weight decay large enough to show
LR_CLS_MULT, LR_MSE_MULT = 0.5, 1.0  # distinct, so swapped groups show
LOSSES = ["MSELoss", "SmoothL1Loss", "L1"]
ESTIMATORS = ["DenseNetTiny", "ContextNetwork"]
# every loss on one estimator, the other estimator with MSELoss: the loss is
# a separate term of the step, and each case compiles a float64 JAX step
STEP_CASES = [("DenseNetTiny", loss) for loss in LOSSES] \
    + [("ContextNetwork", "MSELoss")]
_METRICS = ("loss", "loss_cls", "loss_mse", "top1", "top5")



@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads for the torch work of this module and of
    tests/test_torch_cli.py, which imports this fixture: the suite runs
    several workers at once, and torch's spinning thread pools slow down
    severalfold when they outnumber the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)

def _batch_np(dtype=np.float32):
    """The batch of tests/test_train_engine.py:27-33, NHWC numpy."""
    rng = np.random.default_rng(0)
    return {
        "mv": rng.normal(size=(B, S, H, W, 2)).astype(dtype),
        "residual": rng.normal(size=(B, S, H, W, 3)).astype(dtype),
        "flow": rng.normal(size=(B, S, H, W, 2)).astype(dtype),
        "label": np.asarray([0, 3], np.int32),
    }


def _torch_batch(batch, device="cpu"):
    out = {k: torch.from_numpy(np.ascontiguousarray(v)).permute(0, 1, 4, 2, 3)
           .contiguous().to(device)
           for k, v in batch.items() if v.ndim == 5}
    out["label"] = torch.as_tensor(batch["label"], dtype=torch.long,
                                   device=device)
    if "weight" in batch:
        out["weight"] = torch.as_tensor(batch["weight"], device=device)
    return out


def flax_init(model, *args, **kwargs):
    """`model.init(*args, **kwargs)` jitted, its program compiled without
    LLVM's optimizations: init runs its program once, so the optimizing
    compile of a DMCNet's ~100 random draws costs more CPU time than it
    saves.  The draws are the same threefry bits; an unoptimized program
    fuses no multiply-add, so a float32 kernel may come out 1 ulp apart
    from the optimized init's, and both sides of a comparison share it."""
    import jax

    return jax.jit(model.init, static_argnames="train", compiler_options={
        "xla_backend_optimization_level": 0})(*args, **kwargs)


def _draw(path, shape, rng):
    """numpy values for one flax leaf: kernels N(0, 1/fan_in), BN scale and
    running variance in [0.5, 1.5), biases and running means N(0, 0.1), so
    that no swapped or dropped leaf hides behind flax's 1/0 defaults."""
    name = path[-1].key
    if name == "kernel":
        return rng.normal(0, np.prod(shape[:-1]) ** -0.5, shape)
    if name in ("scale", "var"):
        return rng.uniform(0.5, 1.5, shape)
    return rng.normal(0, 0.1, shape)


@functools.lru_cache(maxsize=None)
def _flax_variables(arch_estimator, att=0, gen_flow_ds_factor=0,
                    plain=False, method=None):
    """(flax model, params, batch_stats): the JAX package's model and its
    variables as numpy trees, at the shapes its `init` gives (traced, not
    compiled) and drawn with numpy from a seed; `method="generate"` covers
    the generator alone."""
    import jax
    import jax.numpy as jnp

    from dmcnet_tpu.models import DMCNet as FlaxDMCNet
    from dmcnet_tpu.models import PlainTSN as FlaxPlainTSN

    if plain:
        model = FlaxPlainTSN(num_class=NUM_CLASS)
        args = (jnp.zeros((1, 1, H, W, 3)),)
    else:
        model = FlaxDMCNet(num_class=NUM_CLASS, num_segments=S,
                           arch_estimator=arch_estimator, gen_flow_or_delta=1,
                           att=att, gen_flow_ds_factor=gen_flow_ds_factor)
        args = (jnp.zeros((1, 1, H, W, 2)), jnp.zeros((1, 1, H, W, 3)))
    shapes = jax.eval_shape(functools.partial(
        model.init, train=False, method=method), jax.random.key(0), *args)
    rng = np.random.default_rng(0)
    draw = functools.partial(jax.tree_util.tree_map_with_path, lambda p, x: (
        _draw(p, x.shape, rng).astype(np.float32)))
    return model, draw(shapes["params"]), draw(shapes.get("batch_stats", {}))


def _port_model(arch_estimator, params, stats, **kw):
    """The port's DMCNet with the flax weights; a generator-only tree
    leaves the classifier as initialised."""
    model = DMCNet(NUM_CLASS, num_segments=S, arch_estimator=arch_estimator,
                   gen_flow_or_delta=1, **kw)
    missing, unexpected = model.load_state_dict(
        state_dict_from_flax(params, stats), strict="base_model" in params)
    assert not unexpected
    assert all(k.startswith("base_model.") for k in missing)
    return model


def _assert_state_close(model, params, stats, what):
    want = state_dict_from_flax(params, stats)
    got = model.state_dict()
    assert set(want) == set(got), what
    for k, v in want.items():
        if k.endswith("num_batches_tracked"):
            continue
        np.testing.assert_allclose(got[k].detach().cpu().numpy(), v.numpy(),
                                   rtol=PARAM_RTOL, atol=PARAM_ATOL,
                                   err_msg=f"{what}: {k}")


def _assert_metrics_close(got, want, what):
    for k in _METRICS:
        np.testing.assert_allclose(float(got[k]), float(want[k]),
                                   rtol=LOSS_RTOL, err_msg=f"{what}: {k}")


def _port_steps(model, batch, loss_mse, train_cls_flags):
    """Port train steps on `model` (its device); returns the metrics."""
    opt_cls, opt_gf = topt.make_optimizers(model, LR_CLS_MULT, LR_MSE_MULT)
    topt.adjust_learning_rate((opt_cls, opt_gf), LR, WD)
    step = tengine.make_train_step(model, opt_cls, opt_gf, num_segments=S,
                                   lr_cls_w=1.0, lr_mse_w=1.0,
                                   loss_mse=loss_mse)
    return [step(batch, flag) for flag in train_cls_flags]


STEP_FLAGS = (False, True, True)  # train_cls per step: the first frozen


@functools.lru_cache(maxsize=None)
def _jax_steps(arch_estimator):
    """The JAX package's three train steps (float64) for every loss that
    STEP_CASES pairs with `arch_estimator`: loss -> (metrics per step,
    params, batch_stats) as numpy.  The programs compile and run in threads
    (XLA releases the GIL)."""
    import concurrent.futures

    import jax
    import jax.numpy as jnp

    from dmcnet_tpu.train.engine import (
        TrainState,
        make_optimizers,
        make_train_step,
    )

    fmodel, params, stats = _flax_variables(arch_estimator)
    losses = [loss for arch, loss in STEP_CASES if arch == arch_estimator]
    with jax.enable_x64(True):
        to64 = functools.partial(jax.tree.map, lambda a: jnp.asarray(
            a, jnp.float64))
        params64, stats64 = to64(params), to64(stats)
        opts = make_optimizers(fmodel, params64, LR_CLS_MULT, LR_MSE_MULT)
        state = TrainState(params=params64, batch_stats=stats64,
                           opt_cls=opts["cls"].init(params64),
                           opt_gf=opts["gf"].init(params64))
        rest = [{k: jnp.asarray(v) for k, v in _batch_np(np.float64).items()},
                jax.random.key(1), jnp.float64(LR), jnp.float64(WD)]
        flags = [jnp.asarray(f) for f in STEP_FLAGS]
        lowered = {loss: jax.jit(make_train_step(
            fmodel, opts, num_segments=S, lr_cls_w=1.0, lr_mse_w=1.0,
            loss_mse=loss, jit=False)).lower(state, *rest, flags[0])
            for loss in losses}

    def run(loss):
        step = lowered[loss].compile()
        st, metrics = state, []
        for flag in flags:
            st, m = step(st, *rest, flag)
            metrics.append(jax.tree.map(np.asarray, m))
        return (metrics, jax.tree.map(np.asarray, st.params),
                jax.tree.map(np.asarray, st.batch_stats))

    with concurrent.futures.ThreadPoolExecutor(len(losses)) as pool:
        return dict(zip(losses, pool.map(run, losses)))


@pytest.mark.parametrize("loss_mse", LOSSES)
def test_reconstruction_loss_matches_jax(loss_mse):
    """Each reconstruction loss and its gradient against the JAX package's,
    float64, on values spread across SmoothL1's |x| = 1 knee."""
    import jax
    import jax.numpy as jnp

    from dmcnet_tpu.train.engine import reconstruction_loss

    rng = np.random.default_rng(4)
    pred, tgt = rng.normal(0, 1.5, (2, B * S, 2, H, W))
    with jax.enable_x64(True):
        want, want_grad = jax.value_and_grad(reconstruction_loss(loss_mse))(
            jnp.asarray(pred), jnp.asarray(tgt))
    p = torch.from_numpy(pred).requires_grad_()
    got = tengine.reconstruction_loss(loss_mse)(p, torch.from_numpy(tgt))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-12)
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(want_grad),
                               rtol=1e-12, atol=1e-15)


@pytest.mark.parametrize("arch_estimator,loss_mse", STEP_CASES)
def test_train_steps_match_jax(arch_estimator, loss_mse):
    """Three steps, the first in the freeze phase, float64 on both sides:
    losses, accuracies, parameters and BN running statistics agree with the
    JAX step; the freeze step leaves the classifier bit-unchanged and its
    optimizer without state, while the generator moves."""
    _, params, stats = _flax_variables(arch_estimator)
    want, want_params, want_stats = _jax_steps(arch_estimator)[loss_mse]
    model = _port_model(arch_estimator, params, stats).double()
    cls_before = {k: v.clone() for k, v in
                  model.base_model.named_parameters()}
    gen_before = {k: v.clone() for k, v in
                  model.gen_flow_model.named_parameters()}
    opt_cls, opt_gf = topt.make_optimizers(model, LR_CLS_MULT, LR_MSE_MULT)
    topt.adjust_learning_rate((opt_cls, opt_gf), LR, WD)
    step = tengine.make_train_step(model, opt_cls, opt_gf, num_segments=S,
                                   lr_cls_w=1.0, lr_mse_w=1.0,
                                   loss_mse=loss_mse)
    tbatch = _torch_batch(_batch_np(np.float64))
    for i, flag in enumerate(STEP_FLAGS):
        _assert_metrics_close(step(tbatch, flag), want[i], f"step {i}")
        if i == 0:
            for k, v in model.base_model.named_parameters():
                assert torch.equal(v, cls_before[k]), f"frozen {k} moved"
            assert not opt_cls.state, "frozen optimizer took a step"
            assert all(not torch.equal(v, gen_before[k]) for k, v in
                       model.gen_flow_model.named_parameters())
    _assert_state_close(model, want_params, want_stats,
                        f"{arch_estimator}/{loss_mse} after 3 steps")


@pytest.mark.parametrize("arch_estimator,att", [("DenseNetTiny", 0),
                                                ("ContextNetwork", 1)])
def test_masked_eval_step_matches_jax(arch_estimator, att):
    """A batch padded with a repeated row and weight 0: the masked means
    equal the JAX eval step's and the port's on the unpadded batch; with
    attention the reconstruction is attention-weighted."""
    import jax.numpy as jnp

    from dmcnet_tpu.train.engine import TrainState, make_eval_step

    fmodel, params, stats = _flax_variables(arch_estimator, att=att)
    batch = _batch_np()
    padded = {k: np.concatenate([v, v[-1:]]) for k, v in batch.items()}
    padded["weight"] = np.asarray([1, 1, 0], np.float32)
    jeval = make_eval_step(fmodel, num_segments=S, lr_cls_w=1.0,
                           lr_mse_w=0.5)
    want = jeval(TrainState(params=params, batch_stats=stats, opt_cls=None,
                            opt_gf=None),
                 {k: jnp.asarray(v) for k, v in padded.items()})

    model = _port_model(arch_estimator, params, stats, att=att)
    step = tengine.make_eval_step(model, num_segments=S, lr_cls_w=1.0,
                                  lr_mse_w=0.5)
    got = step(_torch_batch(padded))
    unpadded = step(_torch_batch(batch))
    _assert_metrics_close(got, want, "padded vs JAX")
    _assert_metrics_close(got, unpadded, "padded vs unpadded")
    np.testing.assert_allclose(got["logits"].numpy(),
                               np.asarray(want["logits"]), rtol=FWD_RTOL,
                               atol=FWD_ATOL)


def test_optimizer_groups_match_jax():
    """make_optimizers + adjust_learning_rate against the JAX GroupAdam
    pair over synthetic gradients, across a freeze phase and an lr step
    (like tests/test_optim_torch_parity.py:59-141)."""
    import jax
    import jax.numpy as jnp

    from dmcnet_tpu.train.engine import make_optimizers
    from dmcnet_tpu.train.optimizers import step_decay_lr

    fmodel, params, stats = _flax_variables("DenseNetTiny")
    opts = make_optimizers(fmodel, params, LR_CLS_MULT, LR_MSE_MULT)
    gf_update = jax.jit(opts["gf"].update)
    cls_update = jax.jit(opts["cls"].masked_update)
    opt_gf, opt_cls = opts["gf"].init(params), opts["cls"].init(params)

    model = _port_model("DenseNetTiny", params, stats)
    t_cls, t_gf = topt.make_optimizers(model, LR_CLS_MULT, LR_MSE_MULT)
    for opt, mult in ((t_cls, LR_CLS_MULT), (t_gf, LR_MSE_MULT)):
        assert [(g["lr_mult"], g["decay_mult"]) for g in opt.param_groups] \
            == [(mult, 1.0), (mult, 0.0)]
    names = {id(p): n for n, p in model.named_parameters()}
    assert all(names[id(p)].endswith(".bias")
               for p in t_cls.param_groups[1]["params"])
    assert "base_model.bn1.weight" in {
        names[id(p)] for p in t_cls.param_groups[0]["params"]}

    lr_steps, lr_decay, epoch_thre = [3], 0.1, 2
    p = params
    step = 0
    for epoch in range(4):
        lr = step_decay_lr(LR, epoch, lr_steps, lr_decay)
        assert topt.step_decay_lr(LR, epoch, lr_steps, lr_decay) == lr
        freeze = epoch < epoch_thre
        topt.adjust_learning_rate((t_cls, t_gf), lr, WD)
        for _ in range(2):
            rng = np.random.default_rng(1000 + step)
            grads = jax.tree.map(lambda x: 0.01 * rng.standard_normal(
                x.shape, dtype=np.float32), p)
            p, opt_gf = gf_update(grads, opt_gf, p, jnp.float32(lr),
                                  jnp.float32(WD))
            p, opt_cls = cls_update(grads, opt_cls, p, jnp.float32(lr),
                                    jnp.float32(WD), jnp.asarray(not freeze))
            # the weight bridge maps a gradient tree like a parameter tree
            tgrads = state_dict_from_flax(grads, stats)
            for name, param in model.named_parameters():
                param.grad = tgrads[name].clone()
            t_gf.step()
            if not freeze:
                t_cls.step()
            t_cls.zero_grad()
            t_gf.zero_grad()
            step += 1
        _assert_state_close(model, jax.tree.map(np.asarray, p), stats,
                            f"epoch {epoch}")


def test_checkpoint_round_trip_and_exact_resume(tmp_path):
    """save_checkpoint -> load_checkpoint restores parameters, BN buffers
    and both optimizers bit for bit, and the restored run continues
    bit-equal to the uninterrupted one; the file serves through
    DMCPredictor.from_checkpoint."""
    from dmcnet_tpu_torch.serving import DMCPredictor

    torch.manual_seed(0)
    model = DMCNet(NUM_CLASS, num_segments=S, arch_estimator="DenseNetTiny",
                   gen_flow_or_delta=1)
    batch = _torch_batch(_batch_np())
    opts = topt.make_optimizers(model, LR_CLS_MULT, LR_MSE_MULT)
    topt.adjust_learning_rate(opts, LR, WD)
    step = tengine.make_train_step(model, *opts, num_segments=S,
                                   lr_cls_w=1.0, lr_mse_w=1.0)
    step(batch, False)
    step(batch, True)
    name = tckpt.checkpoint_name(str(tmp_path / "model"), "MV")
    assert name.endswith("model_mv_checkpoint.pth.tar")
    meta = {"epoch": 2, "arch": "resnet18", "best_prec1": 50.0}
    tckpt.save_checkpoint(model, meta, name, opts, is_best=True)
    best = str(tmp_path / "model_mv_model_best.pth.tar")
    assert tckpt.best_name(name) == best
    assert open(best, "rb").read() == open(name, "rb").read()
    payload = torch.load(name, map_location="cpu", weights_only=True)
    assert set(payload) == {"epoch", "arch", "best_prec1", "state_dict",
                            "optimizer_cls", "optimizer_gf"}

    torch.manual_seed(1)
    model2 = DMCNet(NUM_CLASS, num_segments=S, arch_estimator="DenseNetTiny",
                    gen_flow_or_delta=1)
    opts2 = topt.make_optimizers(model2, LR_CLS_MULT, LR_MSE_MULT)
    assert tckpt.load_checkpoint(name, model2, opts2) == meta
    for k, v in model.state_dict().items():
        assert torch.equal(v, model2.state_dict()[k]), k
    for o, o2 in zip(opts, opts2):
        s, s2 = o.state_dict(), o2.state_dict()
        assert s["param_groups"] == s2["param_groups"]
        for i, st in s["state"].items():
            for k, v in st.items():
                assert torch.equal(v, s2["state"][i][k]), (i, k)
    step2 = tengine.make_train_step(model2, *opts2, num_segments=S,
                                    lr_cls_w=1.0, lr_mse_w=1.0)
    for flag in (True, True):
        m, m2 = step(batch, flag), step2(batch, flag)
        assert all(torch.equal(m[k], m2[k]) for k in _METRICS)
    for k, v in model.state_dict().items():
        assert torch.equal(v, model2.state_dict()[k]), f"resume: {k}"

    pred = DMCPredictor.from_checkpoint(name, num_class=NUM_CLASS,
                                        device="cpu")
    mv = torch.randint(0, 256, (2, H, W, 2), dtype=torch.uint8)
    res = torch.randint(0, 256, (2, H, W, 3), dtype=torch.uint8)
    assert pred._forward_u8(mv, res).shape == (2, NUM_CLASS)


def test_load_reference_weights_partial(tmp_path):
    """--weights: `module.` stripped, non-strict, a shape mismatch and an
    unknown key skipped and counted, missing keys left as they were."""
    torch.manual_seed(0)
    src = DMCNet(NUM_CLASS, arch_estimator="DenseNetTiny")
    sd = {"module." + k: v for k, v in src.state_dict().items()
          if not k.startswith("gen_flow_model.predict_flow")}
    sd["module.base_model.fc.weight"] = torch.zeros(7, 512)
    sd["module.data_bn.weight"] = torch.ones(2)
    path = str(tmp_path / "ref.pth.tar")
    torch.save({"epoch": 1, "arch": "resnet18", "state_dict": sd,
                "best_prec1": 0.0}, path)
    torch.manual_seed(1)
    dst = DMCNet(NUM_CLASS, arch_estimator="DenseNetTiny")
    before = {k: v.clone() for k, v in dst.state_dict().items()}
    skipped, missing = tckpt.load_reference_weights(dst, path)
    assert skipped == ["base_model.fc.weight", "data_bn.weight"]
    assert missing == ["gen_flow_model.predict_flow.bias",
                       "gen_flow_model.predict_flow.weight"]
    for k, v in dst.state_dict().items():
        if k in missing or k == "base_model.fc.weight":
            assert torch.equal(v, before[k]), k
        else:
            assert torch.equal(v, src.state_dict()[k]), k


FORWARD_CASES = [
    ("ContextNetwork", 0, 0),
    ("ContextNetwork", 1, 0),
    ("ContextNetwork", 1, 4),
    ("DenseNetTinyEarlyFusionSum", 0, 0),
    ("DenseNetTinyEarlyFusionStack", 0, 0),
    ("DenseNetTiny", 0, 4),
]


@pytest.mark.parametrize("arch_estimator,att,ds", FORWARD_CASES)
def test_generator_forward_matches_jax(arch_estimator, att, ds):
    """`generate` in eval and train mode (cue, attention, and the BN
    running statistics train mode leaves), including the downsampled
    generation that average-pools and tiles."""
    import jax

    fmodel, params, stats = _flax_variables(arch_estimator, att=att,
                                            gen_flow_ds_factor=ds,
                                            method="generate")
    batch = _batch_np()
    model = _port_model(arch_estimator, params, stats, att=att,
                        gen_flow_ds_factor=ds)
    tb = _torch_batch(batch)
    apply = jax.jit(fmodel.apply, static_argnames=("train", "method",
                                                   "mutable"))
    for train in (False, True):
        variables = {"params": params, "batch_stats": stats}
        if train:
            want, mutated = apply(variables, batch["mv"], batch["residual"],
                                  train=True, method="generate",
                                  mutable=("batch_stats",))
        else:
            want = apply(variables, batch["mv"], batch["residual"],
                         train=False, method="generate")
        model.train(train)
        with torch.no_grad():
            got = model.generate(tb["mv"], tb["residual"])
        got, want = (got, want) if att else ((got,), (want,))
        assert got[0].shape[-2:] == (H, W)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(),
                                       np.asarray(w), rtol=FWD_RTOL,
                                       atol=FWD_ATOL)
        if train and arch_estimator == "ContextNetwork":
            new_stats = jax.tree.map(np.asarray, mutated["batch_stats"])
            got_sd = model.gen_flow_model.state_dict()
            for k, v in state_dict_from_flax(params, new_stats).items():
                if k.endswith("running_mean") or k.endswith("running_var"):
                    np.testing.assert_allclose(
                        got_sd[k[len("gen_flow_model."):]].numpy(),
                        v.numpy(), rtol=PARAM_RTOL, atol=PARAM_ATOL,
                        err_msg=f"train-mode running statistics: {k}")


def test_plain_tsn_matches_jax():
    """PlainTSN (3-channel stem, iframe) in eval and train mode."""
    import jax

    fmodel, params, stats = _flax_variables(None, plain=True)
    x = np.random.default_rng(2).normal(size=(B, S, H, W, 3)) \
        .astype(np.float32)
    model = PlainTSN(NUM_CLASS, in_channels=3)
    model.load_state_dict(state_dict_from_flax(params, stats))
    apply = jax.jit(fmodel.apply, static_argnames=("train", "mutable"))
    xt = torch.from_numpy(x).permute(0, 1, 4, 2, 3)
    for train in (False, True):
        model.train(train)
        with torch.no_grad():
            got = model(xt)
        variables = {"params": params, "batch_stats": stats}
        want = (apply(variables, x, train=True, mutable=("batch_stats",))[0]
                if train else apply(variables, x, train=False))
        assert got.shape == (B * S, NUM_CLASS)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=FWD_RTOL, atol=FWD_ATOL)


def test_topk_correct_breaks_ties_by_index():
    logits = torch.tensor([[1.0, 1.0, 0.0], [0.0, 2.0, 2.0]])
    top1, top2 = tengine.topk_correct(logits, torch.tensor([1, 1]), (1, 2))
    assert float(top1) == 50.0 and float(top2) == 100.0


# --- on the card: the same steps, card against CPU (no flax needed) -------

@pytest.mark.cuda
@pytest.mark.parametrize("arch_estimator", ESTIMATORS)
@pytest.mark.parametrize("loss_mse", LOSSES)
def test_cuda_train_steps_match_cpu(arch_estimator, loss_mse):
    """The three steps of test_train_steps_match_jax on the card against
    the CPU, float64 (see the module docstring); the first step's losses
    in float32 with TF32 off too."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        for dtype, flags in ((torch.float32, (True,)),
                             (torch.float64, STEP_FLAGS)):
            torch.manual_seed(0)
            cpu = DMCNet(NUM_CLASS, num_segments=S,
                         arch_estimator=arch_estimator,
                         gen_flow_or_delta=1).to(dtype=dtype)
            gpu = DMCNet(NUM_CLASS, num_segments=S,
                         arch_estimator=arch_estimator,
                         gen_flow_or_delta=1).to(dtype=dtype)
            gpu.load_state_dict(cpu.state_dict())
            gpu.cuda()
            batch = _batch_np(np.float32 if dtype == torch.float32
                              else np.float64)
            want = _port_steps(cpu, _torch_batch(batch), loss_mse, flags)
            got = _port_steps(gpu, _torch_batch(batch, "cuda"), loss_mse,
                              flags)
            for i, (g, w) in enumerate(zip(got, want)):
                _assert_metrics_close({k: v.cpu() for k, v in g.items()}, w,
                                      f"{dtype} step {i}")
        ref = cpu.state_dict()
        for k, v in gpu.state_dict().items():
            if not k.endswith("num_batches_tracked"):
                np.testing.assert_allclose(v.cpu().numpy(), ref[k].numpy(),
                                           rtol=PARAM_RTOL, atol=PARAM_ATOL,
                                           err_msg=k)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
