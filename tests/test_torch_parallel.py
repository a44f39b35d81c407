"""The port's parallel layer (dmcnet_tpu_torch/parallel) with 2 gloo
processes on the CPU, held against the JAX package's parallel layer
(dmcnet_tpu/parallel) on a 2-device CPU mesh (tests/conftest.py gives JAX
8 host devices).

Each case runs this file as a script in 2 worker processes (`python
tests/test_torch_parallel.py <case> <rank> <world> <port> <out>`), joined
at a free local port (bound to port 0 first: the test files run side by
side), each given `communicate(timeout=WORKER_TIMEOUT)` and killed on
failure, so a hang fails in bounded time.  The workers step on their rows
of one global batch; meanwhile the test process runs the JAX package's
sharded steps (`make_sharded_train_step`, `make_fsdp_train_step` over
`shard_state_fsdp`, the GAN's D and G steps) and its `validate` over a
sharded eval step on the whole batch.  Both start from the same flax
variables drawn with numpy (tests/test_torch_train.py `_draw`), bridged to
the port in float64 (tests/test_torch_gan.py `_bridge64`).

Float64 tolerances (tests/test_torch_gan.py's): losses and accuracies at
rtol 1e-9, parameters and BN running statistics at rtol 1e-7, atol 1e-11;
the per-rank BN the global one replaces misses them by orders of
magnitude.  Batch: B=4 (2 rows a rank), S=2, 32x32, 5 classes,
DenseNetTiny and ResNet-18; the GAN's Discriminator with its dropout at
rate 0 on both sides.
"""

import contextlib
import functools
import io
import json
import os
import socket
import subprocess
import sys
import types

import numpy as np
import pytest
import torch
from test_torch_dcp_checkpoint import (  # noqa: F401 (fixture)
    common_argv,
    corpus,
    train_argv,
)
from test_torch_gan import (
    LOSS_W,
    LR_D_MULT,
    STATE_ATOL,
    STATE_RTOL,
    STEP_RTOL,
    _assert_close_to,
    _bridge64,
    _flax_gan,
    jax_dropout_off,
)
from test_torch_train import (  # noqa: F401 (autouse)
    LR,
    LR_CLS_MULT,
    LR_MSE_MULT,
    NUM_CLASS,
    WD,
    H,
    S,
    W,
    _flax_variables,
    _two_torch_threads,
)

from dmcnet_tpu_torch.models.tsn import DMCNet
from dmcnet_tpu_torch.train import engine as tengine
from dmcnet_tpu_torch.train import engine_gan as tgan
from dmcnet_tpu_torch.train import optimizers as topt

B = 4
WORLD = 2
WORKER_TIMEOUT = 120
STEP_FLAGS = (False, True)      # train_cls per dmcnet step: the first frozen
N_VAL, VAL_BATCH = 5, 4         # a ragged last batch: rank 1 has no row
EVAL_W = dict(lr_cls_w=1.0, lr_mse_w=0.5)
CLI_SIZE = 32
_METRICS = ("loss", "loss_cls", "loss_mse", "top1", "top5")


def _batch(n=B, seed=0):
    """(N, S, C, H, W) float64 inputs and labels, drawn with numpy."""
    rng = np.random.default_rng(seed)
    out = {k: torch.from_numpy(rng.normal(size=(n, S, c, H, W)))
           for k, c in (("mv", 2), ("residual", 3), ("flow", 2))}
    out["label"] = torch.from_numpy(rng.integers(0, NUM_CLASS, n))
    return out


def _jax_batch(batch):
    """The same batch in the JAX package's (N, S, H, W, C) layout."""
    out = {k: np.moveaxis(v.numpy(), 2, -1) for k, v in batch.items()
           if v.dim() == 5}
    out["label"] = batch["label"].numpy().astype(np.int32)
    return out


def _rows(batch, rows):
    return {k: v[list(rows)] for k, v in batch.items()}


def _init_weights():
    """The flax variables of both models, bridged in float64."""
    _, params, stats = _flax_variables("DenseNetTiny")
    _, gparams, gstats = _flax_gan("Discriminator")
    return {"dmcnet": _bridge64(params, stats),
            "gan": _bridge64(gparams, gstats)}


def _model(init, arch_d=None):
    model = DMCNet(NUM_CLASS, num_segments=S, arch_estimator="DenseNetTiny",
                   gen_flow_or_delta=1, arch_d=arch_d,
                   input_size=H).double()
    model.load_state_dict(init["gan" if arch_d else "dmcnet"])
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout2d):
            m.p = 0.0
    return model


def _optimizers(model, gan=False):
    opts = topt.make_optimizers(model, LR_CLS_MULT, LR_MSE_MULT,
                                LR_D_MULT if gan else None)
    topt.adjust_learning_rate(opts, LR, WD)
    return opts


def _dmcnet_steps(model, opts, batch):
    step = tengine.make_train_step(model, *opts, num_segments=S,
                                   lr_cls_w=1.0, lr_mse_w=1.0)
    return [step(batch, flag) for flag in STEP_FLAGS]


def _gan_steps(model, opts, batch):
    d_step, g_step = tgan.make_gan_train_steps(model, *opts, num_segments=S,
                                               **LOSS_W)
    return [d_step(batch), g_step(batch), d_step(batch)]


class _ValAsm:
    """The validate() contract over N_VAL fixed rows."""

    def __init__(self, batch):
        self.batch = batch
        self.ds = range(N_VAL)

    def eval_batch(self, idx):
        return {k: v[list(idx)] for k, v in self.batch.items()}


def _printed_loss(text):
    return float(text.split("Loss")[-1]) if text else None


def _validate(model):
    """Prec@1 and the printed loss of the port's `cli.train.validate` over
    N_VAL rows in batches of VAL_BATCH (None on a rank that prints
    nothing)."""
    from dmcnet_tpu_torch.cli import train as train_cli

    step = tengine.make_eval_step(model, num_segments=S, **EVAL_W)
    out = io.StringIO()
    with pytest.MonkeyPatch.context() as mp, \
            contextlib.redirect_stdout(out):
        mp.setattr(train_cli, "augment_eval_batch", lambda raw, **kw: raw)
        prec1 = train_cli.validate(_ValAsm(_batch(N_VAL, seed=3)), step,
                                   VAL_BATCH, {})
    return prec1, _printed_loss(out.getvalue())


# --- the worker side ---------------------------------------------------------


def _worker(case, rank, world, port, out):
    from dmcnet_tpu_torch.parallel import fsdp, mesh, multihost

    torch.set_num_threads(1)
    result = {}
    if case == "cli":  # cli.train with this rank's --dist-* flags
        from dmcnet_tpu_torch.cli import train as train_cli

        real = train_cli.train

        def train(*args, **kwargs):
            res = real(*args, **kwargs)
            result["state"] = fsdp.gather_state(res.model)
            return res

        train_cli.train = train
        with open(os.path.join(out, "argv.json")) as f:
            argv = json.load(f)
        train_cli.main(argv + [
            "--dist-coordinator", f"localhost:{port}",
            "--dist-num-processes", str(world), "--dist-process-id",
            str(rank)], input_size=CLI_SIZE)
        torch.save(result, os.path.join(out, f"rank{rank}.pt"))
        return
    multihost.initialize_distributed(f"localhost:{port}", world, rank,
                                     device="cpu")
    init = torch.load(os.path.join(out, "init.pt"), weights_only=True)
    batch = _rows(_batch(), multihost.local_shard_indices(B))
    if case == "steps":
        from dmcnet_tpu_torch.train import checkpoints as tckpt

        def build(global_bn, shard):
            model = _model(init)
            if global_bn:
                mesh.use_global_batchnorm(model)
            sharded = fsdp.shard_model(model) if shard else None
            opts = _optimizers(model)
            if shard:
                fsdp.loop_optimizers(opts)
            mesh.sync_gradients(opts)
            return model, opts, sharded

        for name, global_bn, shard in (("dp", True, False),
                                       ("local_bn", False, False),
                                       ("fsdp", True, True)):
            model, opts, sharded = build(global_bn, shard)
            metrics = _dmcnet_steps(model, opts, batch)
            result[name] = {
                "metrics": [mesh.all_reduce_mean([m[k] for k in _METRICS])
                            for m in metrics],
                "state": fsdp.gather_state(model)}
            if name == "dp":
                result["eval"] = _validate(model)
        # the sharded state through a directory: each rank writes its
        # shards; a fresh sharded model resumes and steps as the original
        result["sharded"] = sharded
        directory = os.path.join(out, "fsdp.orbax")
        named = dict(zip(("optimizer_cls", "optimizer_gf"), opts))
        tckpt.save_checkpoint_dcp(model, {"epoch": 2}, directory, named)
        copy, copy_opts, _ = build(True, True)
        tckpt.load_checkpoint(directory, copy, copy_opts)
        step = tengine.make_train_step(model, *opts, num_segments=S,
                                       lr_cls_w=1.0, lr_mse_w=1.0)
        copy_step = tengine.make_train_step(copy, *copy_opts,
                                            num_segments=S, lr_cls_w=1.0,
                                            lr_mse_w=1.0)
        step(batch, True)
        copy_step(batch, True)
        result["fsdp_resumed"] = (fsdp.gather_state(copy),
                                  fsdp.gather_state(model))
        model = mesh.use_global_batchnorm(_model(init, "Discriminator"))
        opts = _optimizers(model, gan=True)
        mesh.sync_gradients(opts)
        metrics = _gan_steps(model, opts, batch)
        result["gan"] = {"metrics": [mesh.all_reduce_mean(list(m.values()))
                                     for m in metrics],
                         "keys": [list(m) for m in metrics],
                         "state": fsdp.gather_state(model)}
    torch.save(result, os.path.join(out, f"rank{rank}.pt"))
    multihost.shutdown()


# --- the JAX package's side ---------------------------------------------------


def _jax_reference():
    """The JAX package's parallel layer on a WORLD-device CPU mesh, float64,
    from the variables of `_init_weights`: the data-parallel dmcnet steps
    and `validate` after them, the FSDP steps, and the data-parallel GAN
    D, G and D steps.  {name: {"metrics", "params", "stats"}, "eval":
    (Prec@1, printed loss)} as numpy."""
    import jax
    import jax.numpy as jnp

    from dmcnet_tpu.cli import train as jax_train
    from dmcnet_tpu.parallel import (
        make_fsdp_train_step,
        make_mesh,
        make_sharded_eval_step,
        make_sharded_train_step,
        replicate_state,
        shard_state_fsdp,
    )
    from dmcnet_tpu.train.engine import (
        TrainState,
        make_eval_step,
        make_optimizers,
        make_train_step,
    )
    from dmcnet_tpu.train.engine_gan import make_gan_train_steps

    mesh = make_mesh(jax.devices()[:WORLD])
    to_np = functools.partial(jax.tree.map, np.asarray)
    out = {}
    with jax.enable_x64(True), jax_dropout_off():
        f64 = jnp.float64
        to64 = functools.partial(jax.tree.map, lambda a: jnp.asarray(
            a, jnp.float64))

        def fresh(arch_d=None):
            fmodel, params, stats = (_flax_gan(arch_d) if arch_d else
                                     _flax_variables("DenseNetTiny"))
            p, st = to64(params), to64(stats)
            opts = make_optimizers(fmodel, p, LR_CLS_MULT, LR_MSE_MULT,
                                   *((LR_D_MULT,) if arch_d else ()))
            state = TrainState(params=p, batch_stats=st,
                               opt_cls=opts["cls"].init(p),
                               opt_gf=opts["gf"].init(p),
                               opt_d=opts["d"].init(p) if arch_d else None)
            return fmodel, opts, state

        def record(name, state, metrics):
            out[name] = {"metrics": [to_np(m) for m in metrics],
                         "params": to_np(state.params),
                         "stats": to_np(state.batch_stats)}

        batch = _jax_batch(_batch())
        rest = (jax.random.key(1), f64(LR), f64(WD))
        for name in ("dp", "fsdp"):
            fmodel, opts, state = fresh()
            raw = make_train_step(fmodel, opts, num_segments=S,
                                  lr_cls_w=1.0, lr_mse_w=1.0, jit=False)
            if name == "dp":
                state = replicate_state(state, mesh)
                step = make_sharded_train_step(raw, mesh)
            else:
                state, specs = shard_state_fsdp(state, mesh)
                step = make_fsdp_train_step(raw, mesh, specs)
            metrics = []
            for flag in STEP_FLAGS:
                state, m = step(state, batch, *rest, jnp.asarray(flag))
                metrics.append(m)
            record(name, state, metrics)
            if name == "dp":
                eval_step = make_sharded_eval_step(make_eval_step(
                    fmodel, num_segments=S, jit=False, **EVAL_W), mesh)
                text = io.StringIO()
                with pytest.MonkeyPatch.context() as mp, \
                        contextlib.redirect_stdout(text):
                    mp.setattr(jax_train, "augment_eval_batch",
                               lambda raw, **kw: raw)
                    prec1 = jax_train.validate(
                        range(N_VAL), _ValAsm(_jax_batch(_batch(N_VAL, 3))),
                        eval_step, state,
                        types.SimpleNamespace(batch_size=VAL_BATCH), {})
                out["eval"] = (prec1, _printed_loss(text.getvalue()))

        fmodel, opts, state = fresh("Discriminator")
        d_step, g_step = (make_sharded_train_step(f, mesh)
                          for f in make_gan_train_steps(
                              fmodel, opts, num_segments=S, jit=False,
                              **LOSS_W))
        state = replicate_state(state, mesh)
        lrs = (jax.random.key(1), f64(LR), f64(LR), f64(LR), f64(WD))
        metrics = []
        for fn in (d_step, g_step, d_step):
            state, m = fn(state, batch, *lrs)
            metrics.append(m)
        record("gan", state, metrics)
    return out


# --- the test side -----------------------------------------------------------


def free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_ranks(argvs, timeout=WORKER_TIMEOUT, env=None, meanwhile=None):
    """Start one process per argv, run `meanwhile()` while they work, wait
    for each at most `timeout` s, kill them all when one fails or hangs;
    returns their stdout."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ if env is None else env)
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    env.setdefault("OMP_NUM_THREADS", "1")
    procs = [subprocess.Popen(argv, cwd=root, env=env, text=True,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT) for argv in argvs]
    outs = []
    try:
        if meanwhile is not None:
            meanwhile()
        for p in procs:
            out, _ = p.communicate(timeout=timeout)
            outs.append(out)
            assert p.returncode == 0, out[-4000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both ranks' results of the dmcnet steps (data parallel, per-rank BN,
    FSDP2), the eval meters and the GAN steps, from one pair of processes;
    and the JAX package's, computed while they run."""
    tmp = tmp_path_factory.mktemp("ranks")
    torch.save(_init_weights(), tmp / "init.pt")
    want = {}
    port = free_port()
    run_ranks([[sys.executable, os.path.abspath(__file__), "steps", str(r),
                str(WORLD), str(port), str(tmp)] for r in range(WORLD)],
              meanwhile=lambda: want.update(_jax_reference()))
    ranks = [dict(torch.load(tmp / f"rank{r}.pt", weights_only=True),
                  out=str(tmp)) for r in range(WORLD)]
    return ranks, want


@pytest.fixture(scope="module")
def ranks(runs):
    return runs[0]


@pytest.fixture(scope="module")
def want(runs):
    return runs[1]


def _assert_metrics(got, want, keys, what):
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g, [float(w[k]) for k in keys],
                                   rtol=STEP_RTOL, atol=1e-12,
                                   err_msg=f"{what}: step {i}")


def _assert_states(got, want, what, rtol=0, atol=0):
    """Two port state dicts."""
    assert set(got) == set(want), what
    for k, v in want.items():
        np.testing.assert_allclose(got[k].double().numpy(),
                                   v.double().numpy(), rtol=rtol, atol=atol,
                                   err_msg=f"{what}: {k}")


def _assert_like_jax(got, want, what):
    """A port state dict against the JAX params and batch_stats."""
    _assert_close_to(got, want["params"], want["stats"], STATE_RTOL,
                     STATE_ATOL, what)


def test_data_parallel_step_equals_global_batch(ranks, want):
    """Two dmcnet steps (the first frozen) on 2 ranks x 2 rows equal the
    JAX package's data-parallel steps on the 4 rows over 2 devices:
    losses, accuracies, parameters and running statistics, both ranks
    alike."""
    for r, res in enumerate(ranks):
        _assert_metrics(res["dp"]["metrics"], want["dp"]["metrics"],
                        _METRICS, f"rank {r}")
        _assert_like_jax(res["dp"]["state"], want["dp"], f"rank {r}")


def test_per_rank_batchnorm_would_differ(ranks, want):
    """Without the global BN each rank normalizes its 2 rows alone: the
    running statistics and parameters miss the global batch's by far more
    than the tolerance, so the agreement above shows global statistics."""
    got = ranks[0]["local_bn"]["state"]
    ref = _bridge64(want["dp"]["params"], want["dp"]["stats"])
    worst = max(float((got[k] - v).abs().max()) for k, v in ref.items()
                if k.endswith("running_var"))
    assert worst > 1e3 * STATE_ATOL + 1e-6
    with pytest.raises(AssertionError):
        _assert_like_jax(got, want["dp"], "per-rank BN")


def test_fsdp_equals_data_parallel(ranks, want):
    """FSDP2 (ResNet-18's convolutions of 2**14 weights or more sharded;
    its stem, BN, 5-class classifier and the generator replicated) steps
    as the JAX package's FSDP step (`shard_state_fsdp`) and its
    data-parallel step do."""
    for r, res in enumerate(ranks):
        sharded = res["sharded"]
        assert "base_model.layer4.1.conv2" in sharded
        assert not {"base_model.conv1", "base_model.bn1", "base_model.fc"} \
            & set(sharded)
        for ref in ("fsdp", "dp"):
            what = f"rank {r} against the JAX {ref} step"
            _assert_metrics(res["fsdp"]["metrics"], want[ref]["metrics"],
                            _METRICS, what)
            _assert_like_jax(res["fsdp"]["state"], want[ref], what)


def test_fsdp_directory_resume(ranks):
    """The FSDP2 state written as a step directory by both ranks (each its
    shards) and read back into a fresh sharded model and its optimizers:
    the next step equals the original's, bit for bit."""
    from dmcnet_tpu_torch.train import checkpoints as tckpt

    for r, res in enumerate(ranks):
        resumed, continued = res["fsdp_resumed"]
        _assert_states(resumed, continued, f"rank {r}")
    directory = os.path.join(ranks[0]["out"], "fsdp.orbax")
    shards = os.listdir(os.path.join(directory, "2", "state"))
    assert len([n for n in shards if n.endswith(".distcp")]) == WORLD
    full = tckpt.read_model_state(directory)
    _assert_states(full, ranks[0]["fsdp"]["state"], "the directory")


def test_eval_meters_equal_single_process(ranks, want):
    """Validation over 5 rows in batches of 4, each rank scoring its rows
    (rank 1 has none in the last batch): Prec@1 and the loss are those of
    the JAX package's `validate`, one process over its sharded eval
    step."""
    prec1, loss = ranks[0]["eval"]
    want_prec1, want_loss = want["eval"]
    np.testing.assert_allclose(prec1, want_prec1, rtol=STEP_RTOL)
    np.testing.assert_allclose(loss, want_loss, rtol=1e-4)  # as printed
    assert ranks[1]["eval"][1] is None  # rank 1 prints nothing


def test_gan_steps_equal_global_batch(ranks, want):
    """The GAN's D, G, D steps on 2 ranks equal the JAX package's
    data-parallel steps: global BN in the discriminator too, and each step
    averages only the optimizers that step (the generator's D-step
    gradient and the discriminator's G-step one are never reduced, never
    used)."""
    for r, res in enumerate(ranks):
        for i, keys in enumerate(res["gan"]["keys"]):
            _assert_metrics(res["gan"]["metrics"][i:i + 1],
                            want["gan"]["metrics"][i:i + 1], keys,
                            f"rank {r} step {i}")
        _assert_like_jax(res["gan"]["state"], want["gan"], f"rank {r}")


def _cli_flags():
    return ["--epochs", "1", "--epoch-thre", "0", "--eval-freq", "1"]


def _score(corpus, weights, tmp):
    """`cli.test` scores of every corpus video with `weights`."""
    from dmcnet_tpu_torch.cli import test as test_cli

    out = str(tmp / "scores")
    test_cli.main(common_argv(corpus) + [
        "--test-list", str(corpus / "list.txt"), "--weights", weights,
        "--test_segments", "2", "--test-crops", "1", "--input_size",
        str(CLI_SIZE), "--save-scores", out, "--device", "cpu"])
    with np.load(out + ".npz", allow_pickle=True) as z:
        return np.stack([s[0] for s in z["scores"]])


def test_cli_train_two_processes(corpus, tmp_path):
    """`cli.train --dist-*` as 2 gloo processes, 1 row of each batch a
    rank, `--ckpt-backend orbax`: both ranks end with identical
    parameters and running statistics, rank 0's directory holds them, and
    `cli.test` and `DMCPredictor` score from it."""
    from dmcnet_tpu_torch.serving import DMCPredictor
    from dmcnet_tpu_torch.train import checkpoints as tckpt

    prefix = str(tmp_path / "dist")
    with open(tmp_path / "argv.json", "w") as f:
        json.dump(train_argv(corpus, prefix, 1, _cli_flags() + [
            "--ckpt-backend", "orbax"]), f)
    port = free_port()
    outs = run_ranks([[sys.executable, os.path.abspath(__file__), "cli",
                       str(r), str(WORLD), str(port), str(tmp_path)]
                      for r in range(WORLD)])
    assert "Testing Results" in outs[0] and "Testing Results" not in outs[1]
    states = [torch.load(tmp_path / f"rank{r}.pt", weights_only=True)
              ["state"] for r in range(WORLD)]
    _assert_states(states[1], states[0], "rank 1 vs rank 0")
    directory = prefix + "_mv_checkpoint.pth.tar.orbax"
    _assert_states(tckpt.read_model_state(directory), states[0],
                   "the directory")
    scores = _score(corpus, directory, tmp_path)
    assert scores.shape == (4, 1, 51) and np.isfinite(scores).all()
    predictor = DMCPredictor.from_checkpoint(directory, device="cpu",
                                             input_size=CLI_SIZE)
    assert torch.equal(predictor.model.base_model.fc.weight,
                       states[0]["base_model.fc.weight"])


def test_cli_fsdp_spawned_ranks(corpus, tmp_path):
    """`--gpus 0 1 --device cpu --fsdp 1 --ckpt-backend orbax-async`: one
    command starts 2 gloo ranks that shard the large convolutions, write
    their shards in the background and commit one step, and
    `--save-reference-ckpt` gathers the shards into rank 0's reference
    file beside the directory.  `--fsdp` across processes with torch
    files refuses."""
    from dmcnet_tpu_torch.train import checkpoints as tckpt

    prefix = str(tmp_path / "fsdp")
    argv = train_argv(corpus, prefix, 1, _cli_flags() + [
        "--gpus", "0", "1", "--fsdp", "1", "--ckpt-backend", "orbax-async",
        "--save-reference-ckpt", "1"])
    code = ("import sys; from dmcnet_tpu_torch.cli import train; "
            f"train.main(sys.argv[1:], input_size={CLI_SIZE})")
    out = run_ranks([[sys.executable, "-c", code] + argv])[0]
    assert out.count("Testing Results") == 1
    directory = prefix + "_mv_checkpoint.pth.tar.orbax"
    assert tckpt._committed_steps(directory) == [1]
    shards = [n for n in os.listdir(os.path.join(directory, "1", "state"))
              if n.endswith(".distcp")]
    assert len(shards) == WORLD
    state = tckpt.read_model_state(directory)
    assert state["base_model.layer4.1.conv2.weight"].shape == (512, 512, 3,
                                                               3)
    ref = torch.load(prefix + "_mv_checkpoint.pth.tar.ref.pth.tar",
                     weights_only=True)
    _assert_states(ref["state_dict"], state, "the reference file")

    from dmcnet_tpu_torch.cli import train as train_cli

    with pytest.raises(SystemExit, match="--fsdp across processes"):
        train_cli.main(train_argv(corpus, prefix, 1, [
            "--gpus", "0", "1", "--fsdp", "1"]), input_size=CLI_SIZE)


def test_ranks_draw_their_own_samples(corpus, monkeypatch):
    """A training `CoviarDataset` draws its videos from its seed and a
    counter, whatever the index: each rank seeds its own, so two ranks'
    rows are not copies of one another (with one seed they would be, as
    in the JAX package, ROADMAP §C)."""
    from dmcnet_tpu_torch.cli import train as train_cli
    from dmcnet_tpu_torch.cli.train_options import build_parser
    from dmcnet_tpu_torch.data.dmc_dataset import BatchAssembler
    from dmcnet_tpu_torch.parallel import multihost

    args = build_parser().parse_args(train_argv(corpus, "unused", 1))
    drawn = []
    for rank in range(WORLD):
        monkeypatch.setattr(multihost, "world", lambda r=rank: (r, WORLD))
        train_ds, _ = train_cli.make_datasets(args)
        asm = BatchAssembler(train_ds, input_size=CLI_SIZE,
                             seed=multihost.process_seed(0))
        drawn.append(asm.train_batch([0, 1, 2, 3]))
    assert not np.array_equal(drawn[0]["frames"], drawn[1]["frames"])


def test_initialize_distributed_errors():
    """The JAX contract: nothing to start for 1 or None processes, a
    coordinator without a process count raises, and a CUDA run needs
    CUDA (a CPU run says --device cpu)."""
    from dmcnet_tpu_torch.parallel import multihost

    assert multihost.initialize_distributed(None, None, None) is False
    assert multihost.initialize_distributed("localhost:1", 1, 0) is False
    with pytest.raises(ValueError, match="without --dist-num-processes"):
        multihost.initialize_distributed("localhost:1", None, None)
    with pytest.raises(ValueError, match="--dist-process-id"):
        multihost.initialize_distributed("localhost:1", 2, None)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            multihost.initialize_distributed("localhost:1", 2, 0)
    assert multihost.world() == (0, 1)
    assert list(multihost.local_shard_indices(8)) == list(range(8))
    assert multihost.process_seed(3) == 3
    assert multihost.effective_lr_step_divisor(6) == 6


if __name__ == "__main__":
    _worker(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]),
            int(sys.argv[4]), sys.argv[5])
