"""The JAX package's checkpoint files read by the port
(`train/jax_checkpoint.py`, `train/checkpoints.py`) with no jax, flax or
msgpack: the stdlib msgpack reader against `flax.serialization`, the
restricted unpickler, training resumed from JAX states (dmcnet, GAN),
the scorers, and JAX orbax directories refused.

Resumes: the JAX package trains, saves with its own `save_checkpoint`, and
takes one more step; the port loads the file into its model and optimizers
and takes the same step, in float64.  dmcnet: steps 1-2 (the first frozen,
so the classifier's Adam is at count 1 and the generator's at 2), then step
3.  GAN: a frozen D step (the classifier at lr 0, its count moving), a
G step, then a D step.  Both at tests/test_torch_gan.py's float64
tolerances: losses rtol 1e-9, parameters and BN statistics rtol 1e-7, atol
1e-11.  I3D files: tests/test_torch_jax_checkpoint_i3d.py.
"""

import functools
import os
import pickle
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
from test_torch_gan import (
    LOSS_W,
    LR_D_MULT,
    STATE_ATOL,
    STATE_RTOL,
    STEP_RTOL,
    _assert_close_to,
    _flax_gan,
    dropout_off,
    jax_dropout_off,
)
from test_torch_train import (  # noqa: F401 (autouse fixture)
    LR,
    LR_CLS_MULT,
    LR_MSE_MULT,
    NUM_CLASS,
    WD,
    H,
    S,
    _batch_np,
    _flax_variables,
    _torch_batch,
    _two_torch_threads,
)

from dmcnet_tpu_torch.models.tsn import DMCNet
from dmcnet_tpu_torch.train import checkpoints as tckpt
from dmcnet_tpu_torch.train import engine as tengine
from dmcnet_tpu_torch.train import engine_gan
from dmcnet_tpu_torch.train import jax_checkpoint as jck
from dmcnet_tpu_torch.train import optimizers as topt

# --- msgpack ---------------------------------------------------------------


def _random_tree(rng):
    """A tree of every leaf kind flax writes."""
    return {
        "f32": rng.normal(size=(3, 4)).astype(np.float32),
        "f64": rng.normal(size=(2, 1, 3)),
        "i32": rng.integers(-2**31, 2**31 - 1, size=(5,), dtype=np.int32),
        "u8": rng.integers(0, 256, size=(2, 7), dtype=np.uint8),
        "bool": rng.random(6) < 0.5,
        "scalar0d": np.asarray(rng.normal()),
        "empty": np.zeros((0, 3), np.float32),
        "none": None,
        "nested": {"a": {"b": {"c": rng.normal(size=(4,))}},
                   "0": np.arange(3, dtype=np.int32), "list": [1, 2.5]},
        "np_scalars": [np.float32(rng.normal()), np.int64(-7),
                       np.uint8(200), np.bool_(True)],
        "complex": complex(rng.normal(), rng.normal()),
        "big": rng.normal(size=(300,)).astype(np.float32),
        "ints": [0, 127, 128, -1, -32, -33, 255, 256, 65535, 65536,
                 2**32, -2**31 - 1, 2**63 - 1, -2**63],
        "strs": ["", "x" * 31, "y" * 32, "z" * 300, "ümlaut"],
        "floats": [0.1, -1e300, float("inf")],
        "bytes": b"\x00\x01" * 200,
    }


def _assert_same(got, want, path="/"):
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), path
        for k in want:
            _assert_same(got[k], want[k], f"{path}{k}/")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same(g, w, f"{path}{i}/")
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype, path
        np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        assert type(got) is type(want) and (got == want), path


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_msgpack_reader_matches_flax(seed):
    """`unpack_msgpack` of flax `msgpack_serialize` bytes equals flax's
    own `msgpack_restore`: every dtype, 0-d and empty arrays, None,
    nested keys, numpy scalars, complex, ints and strs of every width."""
    from flax import serialization

    tree = _random_tree(np.random.default_rng(seed))
    data = serialization.msgpack_serialize(tree)
    _assert_same(jck.unpack_msgpack(data),
                 serialization.msgpack_restore(data))


def test_msgpack_reader_joins_chunked_arrays(monkeypatch):
    """Arrays above flax's MAX_CHUNK_SIZE (made 64 bytes here) are written
    as `__msgpack_chunked_array__` leaves; the reader joins them back."""
    from flax import serialization

    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    rng = np.random.default_rng(3)
    tree = {"w": rng.normal(size=(7, 5)).astype(np.float32),
            "deep": {"v": rng.integers(0, 9, size=(41,), dtype=np.int32)},
            "small": np.arange(4, dtype=np.float32)}
    data = serialization.msgpack_serialize(tree)
    assert b"__msgpack_chunked_array__" in data
    got = jck.unpack_msgpack(data)
    _assert_same(got, serialization.msgpack_restore(data))
    _assert_same(got, tree)


class _Evil:
    def __reduce__(self):
        return (os.system, ("echo pwned > /dev/null",))


def test_restricted_unpickler_refuses_foreign_classes(tmp_path):
    """A meta value of a class the reader does not admit raises naming its
    key, and nothing of it runs; numpy scalars and arrays in the meta
    load."""
    from flax import serialization

    state = serialization.msgpack_serialize({"params": {"w": np.ones(2)}})
    good = str(tmp_path / "good.pth.tar")
    with open(good, "wb") as f:
        pickle.dump({"meta": {"epoch": np.int64(3), "top1": np.float64(1.5),
                              "arr": np.arange(3)}, "state": state}, f)
    meta, tree = jck.read_jax_checkpoint(good)
    assert meta["epoch"] == 3 and meta["top1"] == 1.5
    np.testing.assert_array_equal(tree["params"]["w"], np.ones(2))
    assert jck.is_jax_checkpoint(good)

    bad = str(tmp_path / "bad.pth.tar")
    with open(bad, "wb") as f:
        pickle.dump({"meta": {"epoch": 1, "hook": _Evil()}, "state": state},
                    f)
    with pytest.raises(ValueError, match=r"meta\['hook'\].*posix.system|"
                                         r"meta\['hook'\].*os.system"):
        jck.read_jax_checkpoint(bad)
    torch_file = str(tmp_path / "t.pth")
    torch.save({"state_dict": {}}, torch_file)
    assert not jck.is_jax_checkpoint(torch_file)
    assert tckpt.checkpoint_format(torch_file) == "torch"
    assert tckpt.checkpoint_format(good) == "jax"


def test_isolated_reader_imports_no_jax(tmp_path):
    """A JAX file loads into a port model in a fresh interpreter that
    never imports jax, flax or msgpack."""
    from dmcnet_tpu.train.checkpoints import save_checkpoint
    from dmcnet_tpu.train.engine import TrainState

    _, params, stats = _flax_variables("DenseNetTiny")
    path = str(tmp_path / "jax.pth.tar")
    save_checkpoint(TrainState(params=params, batch_stats=stats,
                               opt_cls=None, opt_gf=None),
                    {"epoch": 1, "arch": "resnet18", "best_prec1": 0.0},
                    path)
    probe = (
        "import sys\n"
        "from dmcnet_tpu_torch.models.tsn import DMCNet\n"
        "from dmcnet_tpu_torch.train.checkpoints import load_checkpoint\n"
        f"m = DMCNet({NUM_CLASS}, num_segments={S}, "
        "arch_estimator='DenseNetTiny', gen_flow_or_delta=1)\n"
        f"print(load_checkpoint({path!r}, m)['epoch'])\n"
        "bad = [n for n in sys.modules if n.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'msgpack', 'dmcnet_tpu')]\n"
        "print(','.join(bad))\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", probe], cwd=root,
                         env=dict(os.environ, PYTHONPATH=root),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.splitlines() == ["1", ""]


# --- resumes ---------------------------------------------------------------


def _to64(tree):
    import jax
    import jax.numpy as jnp

    return jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), tree)


def _save_jax(state, meta, path):
    import jax

    from dmcnet_tpu.train.checkpoints import save_checkpoint

    save_checkpoint(jax.tree.map(np.asarray, state), meta, path)


@functools.lru_cache(maxsize=None)
def _jax_dmcnet_resume(path):
    """JAX dmcnet steps 1-2 (frozen, then not) saved to `path`, then step
    3: its params and batch_stats as numpy."""
    import jax
    import jax.numpy as jnp

    from dmcnet_tpu.train.engine import (
        TrainState,
        make_optimizers,
        make_train_step,
    )

    fmodel, params, stats = _flax_variables("DenseNetTiny")
    with jax.enable_x64(True):
        p64, s64 = _to64(params), _to64(stats)
        opts = make_optimizers(fmodel, p64, LR_CLS_MULT, LR_MSE_MULT)
        state = TrainState(params=p64, batch_stats=s64,
                           opt_cls=opts["cls"].init(p64),
                           opt_gf=opts["gf"].init(p64))
        step = jax.jit(make_train_step(fmodel, opts, num_segments=S,
                                       lr_cls_w=1.0, lr_mse_w=1.0,
                                       jit=False))
        batch = {k: jnp.asarray(v) for k, v in _batch_np(np.float64).items()}
        rest = (batch, jax.random.key(1), jnp.float64(LR), jnp.float64(WD))
        for flag in (False, True):
            state, _ = step(state, *rest, jnp.asarray(flag))
        assert int(state.opt_cls["count"]) == 1
        _save_jax(state, {"epoch": 2, "arch": "resnet18",
                          "best_prec1": 40.0}, path)
        state, metrics = step(state, *rest, jnp.asarray(True))
        return (jax.tree.map(np.asarray, metrics),
                jax.tree.map(np.asarray, state.params),
                jax.tree.map(np.asarray, state.batch_stats))


def test_dmcnet_resume_from_jax_matches_jax(tmp_path):
    """`load_checkpoint` of a JAX file written after 2 JAX steps, then the
    port's 3rd step: losses and every parameter and BN statistic equal
    the JAX package's 3rd step in float64; the loaded Adams hold count 1
    (classifier: its frozen step did not count) and 2."""
    path = str(tmp_path / "jax_mv_checkpoint.pth.tar")
    metrics, want_params, want_stats = _jax_dmcnet_resume(path)
    model = DMCNet(NUM_CLASS, num_segments=S, arch_estimator="DenseNetTiny",
                   gen_flow_or_delta=1).double()
    opts = topt.make_optimizers(model, LR_CLS_MULT, LR_MSE_MULT)
    meta = tckpt.load_checkpoint(path, model, opts)
    assert meta == {"epoch": 2, "arch": "resnet18", "best_prec1": 40.0}
    assert {float(s["step"]) for s in opts[0].state.values()} == {1.0}
    assert {float(s["step"]) for s in opts[1].state.values()} == {2.0}
    assert len(opts[0].state) == sum(1 for _ in
                                     model.base_model.parameters())
    topt.adjust_learning_rate(opts, LR, WD)
    step = tengine.make_train_step(model, *opts, num_segments=S,
                                   lr_cls_w=1.0, lr_mse_w=1.0)
    got = step(_torch_batch(_batch_np(np.float64)), True)
    for k in ("loss", "loss_cls", "loss_mse"):
        np.testing.assert_allclose(float(got[k]), float(metrics[k]),
                                   rtol=STEP_RTOL, err_msg=k)
    _assert_close_to(model.state_dict(), want_params, want_stats,
                     STATE_RTOL, STATE_ATOL, "step 3 after the JAX file")


def test_gan_resume_from_jax_matches_jax(tmp_path):
    """A JAX GAN state after a frozen D step (classifier at lr 0: its
    count 1, its parameters unmoved) and a G step, with `opt_d`; the
    port's D step from the file equals the JAX package's."""
    import jax
    import jax.numpy as jnp

    from dmcnet_tpu.train.engine import TrainState, make_optimizers
    from dmcnet_tpu.train.engine_gan import make_gan_train_steps

    fmodel, params, stats = _flax_gan("Discriminator")
    path = str(tmp_path / "gan_mv_checkpoint.pth.tar")
    with jax.enable_x64(True), jax_dropout_off():
        p64, s64 = _to64(params), _to64(stats)
        opts = make_optimizers(fmodel, p64, LR_CLS_MULT, LR_MSE_MULT,
                               LR_D_MULT)
        state = TrainState(params=p64, batch_stats=s64,
                           opt_cls=opts["cls"].init(p64),
                           opt_gf=opts["gf"].init(p64),
                           opt_d=opts["d"].init(p64))
        batch = {k: jnp.asarray(v) for k, v in _batch_np(np.float64).items()}
        rng, f64 = jax.random.key(1), jnp.float64
        lrs = (f64(LR), f64(LR), f64(LR), f64(WD))
        jitted = [jax.jit(f) for f in make_gan_train_steps(
            fmodel, opts, num_segments=S, jit=False, **LOSS_W)]

        def compile_step(fn):  # the D and G programs compile in two threads
            with jax.enable_x64(True):   # a thread-local setting
                return fn.lower(state, batch, rng, *lrs).compile()

        with ThreadPoolExecutor(2) as pool:
            d_step, g_step = pool.map(compile_step, jitted)
        state, _ = d_step(state, batch, rng, f64(LR), f64(0.0), f64(LR),
                          f64(WD))
        state, _ = g_step(state, batch, rng, f64(LR), f64(LR), f64(LR),
                          f64(WD))
        _save_jax(state, {"epoch": 1, "arch": "resnet18",
                          "best_prec1": 0.0}, path)
        state, _ = d_step(state, batch, rng, f64(LR), f64(LR), f64(LR),
                          f64(WD))
        want_params = jax.tree.map(np.asarray, state.params)
        want_stats = jax.tree.map(np.asarray, state.batch_stats)

    model = dropout_off(DMCNet(NUM_CLASS, num_segments=S,
                               arch_estimator="DenseNetTiny",
                               gen_flow_or_delta=1, arch_d="Discriminator",
                               input_size=H)).double()
    opts = topt.make_optimizers(model, LR_CLS_MULT, LR_MSE_MULT, LR_D_MULT)
    tckpt.load_checkpoint(path, model, opts)
    assert [{float(s["step"]) for s in o.state.values()} for o in opts] \
        == [{1.0}, {1.0}, {1.0}]
    topt.adjust_learning_rate(opts, LR, WD)
    d, _ = engine_gan.make_gan_train_steps(model, *opts, num_segments=S,
                                           **LOSS_W)
    d(_torch_batch(_batch_np(np.float64)))
    _assert_close_to(model.state_dict(), want_params, want_stats,
                     STATE_RTOL, STATE_ATOL, "D step after the JAX file")


# --- scorers ---------------------------------------------------------------


def test_scorers_read_jax_files(tmp_path):
    """`DMCPredictor.from_checkpoint` and `cli.test`'s `--weights` loader
    on a JAX file give the JAX scorers' logits (their loader,
    `load_checkpoint_params`, and the flax forward); a GAN file loads into
    `cli.test --arch_d`'s model, discriminator included."""
    import jax
    import jax.numpy as jnp

    from dmcnet_tpu.train.checkpoints import (
        load_checkpoint_params,
        save_checkpoint,
    )
    from dmcnet_tpu.train.engine import TrainState
    from dmcnet_tpu_torch.serving import DMCPredictor

    fmodel, params, stats = _flax_variables("DenseNetTiny")
    path = str(tmp_path / "jax.pth.tar")
    save_checkpoint(TrainState(params=params, batch_stats=stats,
                               opt_cls=None, opt_gf=None),
                    {"epoch": 1, "arch": "resnet18", "best_prec1": 0.0},
                    path)
    template = TrainState(params=jax.tree.map(np.zeros_like, params),
                          batch_stats=jax.tree.map(np.zeros_like, stats),
                          opt_cls=None, opt_gf=None)
    loaded, _ = load_checkpoint_params(template, path)
    batch = _batch_np()
    want, _ = jax.jit(functools.partial(fmodel.apply, train=False))(
        {"params": loaded.params, "batch_stats": loaded.batch_stats},
        jnp.asarray(batch["mv"]), jnp.asarray(batch["residual"]))
    tb = _torch_batch(batch)
    mv = tb["mv"].flatten(0, 1)
    res = tb["residual"].flatten(0, 1)
    predictor = DMCPredictor.from_checkpoint(path, num_class=NUM_CLASS,
                                             device="cpu", input_size=H)
    with torch.no_grad():
        got = predictor.model(mv, res)[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=2e-4)

    net = DMCNet(NUM_CLASS, num_segments=S, arch_estimator="DenseNetTiny",
                 gen_flow_or_delta=1).eval()
    skipped, missing = tckpt.load_reference_weights(net, path)
    assert not skipped and not missing
    with torch.no_grad():
        got = net(tb["mv"], tb["residual"])[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=2e-4)

    _, gparams, gstats = _flax_gan("Discriminator")
    gpath = str(tmp_path / "gan.pth.tar")
    save_checkpoint(TrainState(params=gparams, batch_stats=gstats,
                               opt_cls=None, opt_gf=None), {"epoch": 1},
                    gpath)
    gnet = DMCNet(NUM_CLASS, num_segments=S, arch_estimator="DenseNetTiny",
                  gen_flow_or_delta=1, arch_d="Discriminator", input_size=H)
    skipped, missing = tckpt.load_reference_weights(gnet, gpath)
    assert not skipped and not missing
    _assert_close_to(gnet.state_dict(), gparams, gstats, 0, 0,
                     "GAN weights")


def test_jax_orbax_directory_raises(tmp_path):
    """A directory of the JAX package's orbax backend (tensorstore OCDBT)
    stops every loader with a SystemExit that names the format."""
    from dmcnet_tpu.train.checkpoints import save_checkpoint_orbax
    from dmcnet_tpu.train.engine import TrainState
    from dmcnet_tpu_torch.serving import DMCPredictor

    _, params, stats = _flax_variables("DenseNetTiny")
    directory = str(tmp_path / "jax_mv_checkpoint.pth.tar.orbax")
    save_checkpoint_orbax(TrainState(params=params, batch_stats=stats,
                                     opt_cls=None, opt_gf=None),
                          {"epoch": 1}, directory)
    model = DMCNet(NUM_CLASS, num_segments=S, arch_estimator="DenseNetTiny",
                   gen_flow_or_delta=1)
    for load in (lambda: tckpt.load_checkpoint(directory, model),
                 lambda: tckpt.read_model_state(directory),
                 lambda: tckpt.load_reference_weights(model, directory),
                 lambda: DMCPredictor.from_checkpoint(directory,
                                                      device="cpu")):
        with pytest.raises(SystemExit, match="JAX orbax checkpoint"):
            load()
