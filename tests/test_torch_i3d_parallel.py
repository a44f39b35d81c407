"""I3D training over several processes (the steps of `cli/train_i3d.py`
with `--dist-*` and `--fsdp`, and the command's loop) with 2 gloo processes
on the CPU, the steps held against the JAX package's sharded I3D steps on a
2-device CPU mesh (tests/conftest.py gives JAX 8 host devices).

One pair of worker processes (this file run as a script, as
tests/test_torch_parallel.py does) does both parts while the test process
runs the JAX side:

  * D, G, D, G macro steps of 2 microbatches (the GAN's carry across the
    phases, the classification term dropped in the first G step), batch 4
    (2 rows a rank), T = 4, 32x32, float64, nesterov SGD for the classifier
    and the generator (an update in proportion to the gradient), data
    parallel and FSDP2,
    against `make_sharded_train_step(..., batch_axis=1)` over the JAX
    package's `make_i3d_steps`: losses at rtol 1e-9, parameters and BN
    running statistics at rtol 1e-7, atol 1e-11, and the carried gradients
    (averaged over the ranks: each rank carries its own sums) against the
    JAX state's `grad_acc`;
  * then `cli.train_i3d.train` (the `--dist-*` group, `--auto-resume`,
    `--fsdp`, `--tp`) over in-memory clips (T = 4, 32x32, batch 2 of 1 row
    a rank, 2 microbatches a macro step, `--epoch-thre 1`, `--ckpt-backend
    orbax`): 2 epochs straight through, against 1 epoch then
    `--auto-resume` to 2, bit for bit; a rerun where rank 1 does not see
    the epoch-2 directory, so both ranks agree on epoch 1 (the oldest
    newest epoch, as the JAX command's `process_allgather(...).min()`) and
    end where the straight run does; and one epoch each with `--fsdp 1`
    and `--tp 2`, whose directories read back whole.  Each batch is drawn
    from its first index and the rank's data row
    (tests/test_torch_dcp_checkpoint.py `index_seeded`), and the
    discriminator's dropout is off: neither random stream is checkpointed.

The steps' weights are the flax initialisation's shapes drawn with numpy
(tests/test_torch_i3d.py `draw_variables`), bridged in float64; dropout is
off on both sides.
"""

import contextlib
import functools
import io
import os
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
from test_torch_gan import _bridge64, dropout_off, jax_dropout_off
from test_torch_i3d import draw_variables
from test_torch_parallel import free_port, run_ranks

B, T, HW, ITER, NUM_CLASS = 4, 4, 32, 2, 5
WORLD = 2
# nesterov SGD for the classifier and the generator (Adam for the
# discriminator, as always): an SGD update is proportional to the gradient,
# so a gradient averaged twice or summed over the ranks shows in the
# parameters, where Adam's normalized update would hide it; its lr is a
# tenth of tests/test_torch_i3d_train.py's Adam lr, as there
LR, LR1, LR_D, WD, ADV, LR_MUL = 2e-6, 1e-6, 4e-6, 1e-4, 0.7, 0.5
STEPS = (("d", False), ("g", True), ("d", False), ("g", False))
STEP_RTOL = 1e-9
STATE_RTOL, STATE_ATOL = 1e-7, 1e-11
_D_METRICS = ("loss", "loss_cls", "loss_adv", "top1", "top5", "acc_D_adv")
_G_METRICS = ("loss", "loss_cls", "loss_mse", "loss_adv", "top1", "top5")


@functools.lru_cache(maxsize=None)
def _flax_i3d():
    """(flax I3D with generator and discriminator, params, batch_stats) at
    T x HW x HW, numpy-drawn."""
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


def _micro_np(seed):
    """ITER microbatches of B clips, NDHWC float64, stacked on axis 0."""
    rng = np.random.default_rng(seed)
    shape = (ITER, B, T, HW, HW)
    return {"mv": rng.normal(size=shape + (2,)),
            "residual": rng.normal(size=shape + (3,)),
            "flow": rng.normal(size=shape + (2,)),
            "label": rng.integers(0, NUM_CLASS, size=(ITER, B))
            .astype(np.int32)}


def _micro_torch(batch, rows):
    """This rank's rows of the stacked microbatches as NCTHW batches."""
    out = []
    for i in range(ITER):
        mb = {k: torch.from_numpy(np.ascontiguousarray(v[i][rows]))
              .permute(0, 4, 1, 2, 3).contiguous()
              for k, v in batch.items() if k != "label"}
        mb["label"] = torch.as_tensor(batch["label"][i][rows],
                                      dtype=torch.long)
        out.append(mb)
    return out


def _port_i3d(state_dict):
    from dmcnet_tpu_torch.models.i3d import get_symbol

    net, _ = get_symbol("I3D", modality="flow+mp4", num_classes=NUM_CLASS,
                        arch_estimator="DenseNetTiny",
                        arch_d="Discriminator", input_size=HW)
    net.double().load_state_dict(state_dict)
    return dropout_off(net)


# --- the worker side ---------------------------------------------------------


def _steps(init, rank):
    """The D, G, D, G macro steps data-parallel and under FSDP2: {name:
    {metrics, state, carry}} (the carry averaged over the ranks)."""
    from dmcnet_tpu_torch.parallel import fsdp, mesh, multihost
    from dmcnet_tpu_torch.train.engine_i3d import make_i3d_steps
    from dmcnet_tpu_torch.train.optimizers import make_i3d_optimizers

    rows = list(multihost.local_shard_indices(B))
    out = {}
    for name in ("dp", "fsdp"):
        model = mesh.use_global_batchnorm(_port_i3d(init))
        if name == "fsdp":
            out["sharded"] = fsdp.shard_model(model)
        opts = make_i3d_optimizers(model, optim="sgd", lr_mul=LR_MUL,
                                   has_gan=True)
        if name == "fsdp":
            fsdp.loop_optimizers(opts.values())
        mesh.sync_gradients(opts.values())
        d_step, g_step = make_i3d_steps(model, opts, adv=ADV)
        metrics = []
        for i, (kind, drop) in enumerate(STEPS):
            m = (d_step if kind == "d" else g_step)(
                _micro_torch(_micro_np(i), rows), LR, LR1, LR_D, WD, drop)
            keys = sorted(m)
            metrics.append(dict(zip(keys, mesh.all_reduce_mean(
                [m[k] for k in keys]))))
        mesh.average_gradients(model.parameters())  # FSDP2's are already
        carry = {k: (p.grad.full_tensor() if hasattr(p.grad, "full_tensor")
                     else p.grad).detach().clone()
                 for k, p in model.named_parameters() if p.grad is not None}
        out[name] = {"metrics": metrics, "state": fsdp.gather_state(model),
                     "carry": carry}
    return out


class _Clips:
    """A `VideoClipDataset` stand-in of `n` random flow+mp4 clips."""

    modality = "flow+mp4"

    def __init__(self, n, seed):
        rng = np.random.default_rng(seed)
        self.clips = rng.integers(0, 256, size=(n, T, HW, HW, 7),
                                  dtype=np.uint8)

    def __len__(self):
        return len(self.clips)

    def __getitem__(self, i):
        return self.clips[i], i % NUM_CLASS


def _cli_flags(out, task, end, extra=()):
    return ["--modality", "flow+mp4", "--arch-estimator", "DenseNetTiny",
            "--arch-d", "Discriminator", "--adv", "1", "--optimizer", "adam",
            "--drop-out", "0", "--fine_tune", "0", "--batch-size", "2",
            "--iter-size", "2", "--clip-length", str(T), "--lr-base", "1e-3",
            "--lr-base2", "1e-3", "--lr-d", "2e-3", "--workers", "1",
            "--epoch-thre", "1", "--end-epoch", str(end),
            "--ckpt-backend", "orbax", "--model-dir", out, "--task-name",
            task, "--device", "cpu"] + list(extra)


def _directory_state(directory):
    from dmcnet_tpu_torch.train.checkpoints import _dcp_keys, _newest_step

    import torch.distributed.checkpoint as dcp

    step = _newest_step(directory)
    state = {k: torch.zeros(tuple(md.size), dtype=md.properties.dtype)
             for k, md in _dcp_keys(step).items()}
    dcp.load(state, storage_reader=dcp.FileSystemReader(
        os.path.join(step, "state")), no_dist=True)
    return state


def _seeded_assembler(train_i3d, row):
    """`I3DBatchAssembler` drawing each batch from its first index and the
    rank's data row (`row[0]`): a resumed run draws what a straight one
    does (tests/test_torch_dcp_checkpoint.py `index_seeded`), and the
    `--tp` ranks of a row draw the same."""
    base = train_i3d.I3DBatchAssembler

    class Seeded(base):
        def batch(self, indices):
            self.rng = np.random.default_rng(1000 * row[0] + indices[0] + 7)
            return super().batch(indices)

    train_i3d.I3DBatchAssembler = Seeded


def _cli(out, rank):
    """The `cli.train_i3d.train` runs of the module docstring; each run's
    printed lines, last directory and (on rank 0) the keys of its step
    that differ from the straight run's."""
    from dmcnet_tpu_torch.cli import train_i3d
    from dmcnet_tpu_torch.parallel import fsdp

    row = [rank]
    _seeded_assembler(train_i3d, row)
    real_build = train_i3d.build_model
    train_i3d.build_model = lambda *a, **kw: (
        lambda net_conf: (dropout_off(net_conf[0]), net_conf[1]))(
        real_build(*a, **kw))
    models = os.path.join(out, "models")
    init = real_build(train_i3d.autofill(train_i3d.build_parser().parse_args(
        _cli_flags(models, "x", 1))), 51, HW)[0].state_dict()
    runs = {"init": init}

    def run(name, task, end, extra=()):
        args = train_i3d.autofill(train_i3d.build_parser().parse_args(
            _cli_flags(models, task, end, extra)))
        args.score_dir = os.path.join(out, "score", name)
        row[0] = rank // max(args.tp, 1)
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            result = train_i3d.train(args, _Clips(4, 0), _Clips(3, 1),
                                     device="cpu", input_size=HW)
        # every rank gathers its shards; per-tensor sums, to hold the ranks'
        # states against each other
        state = fsdp.gather_state(result.model)
        runs[name] = {"out": text.getvalue(), "dir": result.checkpoint,
                      "sums": {k: float(v.double().sum())
                               for k, v in state.items()},
                      "moved": {k.split(".")[0] for k, v in state.items()
                                if not torch.equal(v, init[k])}}
        if rank == 0 and name in ("full", "resumed", "agreed"):
            state = _directory_state(result.checkpoint)
            want = runs["full"].setdefault("state", state)
            runs[name]["mismatch"] = sorted(
                set(state) ^ set(want)
                | {k for k in state.keys() & want.keys()
                   if not torch.equal(state[k], want[k])})
            runs[name]["grads"] = sum(k.startswith("grad/") for k in state)

    run("full", "full", 2)
    run("first", "parts", 1)
    run("resumed", "parts", 2, ["--auto-resume", "1"])
    # rank 1 does not see the epoch-2 directory: both resume at epoch 1
    real_found = train_i3d.dcp_checkpoint_committed
    if rank == 1:
        train_i3d.dcp_checkpoint_committed = lambda d: (
            "ep-0002" not in d and real_found(d))
    run("agreed", "parts", 2, ["--auto-resume", "1"])
    train_i3d.dcp_checkpoint_committed = real_found
    run("fsdp", "fsdp", 1, ["--fsdp", "1"])
    run("tp", "tp", 1, ["--tp", "2"])
    runs["full"].pop("state", None)
    return runs


def _worker(rank, world, port, out):
    """The steps, then the command's runs; each sharded run's directory
    described by its metadata ({key: shape}) and every directory removed
    (an I3D step with three optimizers' states is ~0.2 GB)."""
    import shutil

    import torch.distributed as dist

    from dmcnet_tpu_torch.parallel import multihost
    from dmcnet_tpu_torch.train.checkpoints import _dcp_keys, _newest_step

    torch.set_num_threads(1)
    multihost.initialize_distributed(f"localhost:{port}", world, rank,
                                     device="cpu")
    init = torch.load(os.path.join(out, "init.pt"), weights_only=True)
    result = _steps(init, rank)
    runs = result["cli"] = _cli(out, rank)
    for name in ("fsdp", "tp"):
        runs[name]["shapes"] = {
            k: tuple(md.size) for k, md in
            _dcp_keys(_newest_step(runs[name]["dir"])).items()}
    dist.barrier()
    if rank == 0:
        shutil.rmtree(os.path.join(out, "models"))
    torch.save(result, os.path.join(out, f"rank{rank}.pt"))
    multihost.shutdown()


# --- the JAX package's side ---------------------------------------------------


def _jax_reference():
    """The JAX package's D, G, D, G steps data-parallel over a WORLD-device
    mesh (batch axis 1 of the stacked microbatches), float64: per step the
    metrics, and the final params, batch_stats and grad_acc, as numpy."""
    import jax
    import jax.numpy as jnp

    from dmcnet_tpu.parallel import (
        make_mesh,
        make_sharded_train_step,
        replicate_state,
        shard_batch,
    )
    from dmcnet_tpu.train.engine import TrainState
    from dmcnet_tpu.train.engine_i3d import make_i3d_optimizers as jax_opts
    from dmcnet_tpu.train.engine_i3d import make_i3d_steps

    net, params, stats = _flax_i3d()
    mesh = make_mesh(jax.devices()[:WORLD])
    to_np = functools.partial(jax.tree.map, np.asarray)
    with jax.enable_x64(True), jax_dropout_off():
        to64 = functools.partial(jax.tree.map, lambda a: jnp.asarray(
            a, jnp.float64))
        p64 = to64(params)
        opts = jax_opts(p64, optim="sgd", lr_mul=LR_MUL, has_gan=True)
        state = replicate_state(TrainState(
            params=p64, batch_stats=to64(stats),
            opt_cls=opts["cls"].init(p64), opt_gf=opts["gf"].init(p64),
            opt_d=opts["d"].init(p64),
            # numpy zeros put on the device: no program compiled per shape
            grad_acc=jax.tree.map(lambda a: jnp.asarray(np.zeros(
                a.shape, a.dtype)), p64)), mesh)
        f64 = jnp.float64
        batches = [shard_batch(_micro_np(i), mesh, batch_axis=1)
                   for i in range(len(STEPS))]

        def args(i, drop):
            return (jax.random.key(i), f64(LR), f64(LR1), f64(LR_D),
                    f64(WD), jnp.asarray(drop))

        # the D and G programs compile in two threads (XLA's compiles
        # overlap; the traces take turns)
        steps = dict(zip("dg", (make_sharded_train_step(f, mesh,
                                                        batch_axis=1)
                                for f in make_i3d_steps(net, opts, adv=ADV,
                                                        jit=False))))
        def compile_step(kind):
            with jax.enable_x64(True):   # a thread-local setting
                return steps[kind].lower(state, batches[0],
                                         *args(0, False)).compile()

        with ThreadPoolExecutor(2) as pool:
            compiled = dict(zip("dg", pool.map(compile_step, "dg")))
        metrics = []
        for i, (kind, drop) in enumerate(STEPS):
            state, m = compiled[kind](state, batches[i], *args(i, drop))
            metrics.append(to_np(m))
        return {"metrics": metrics, "params": to_np(state.params),
                "stats": to_np(state.batch_stats),
                "grad_acc": to_np(state.grad_acc)}


# --- the test side -----------------------------------------------------------


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("i3d_ranks")
    _, params, stats = _flax_i3d()
    torch.save(_bridge64(params, stats), tmp / "init.pt")
    want = {}
    port = free_port()
    run_ranks([[sys.executable, os.path.abspath(__file__), str(r),
                str(WORLD), str(port), str(tmp)] for r in range(WORLD)],
              meanwhile=lambda: want.update(_jax_reference()))
    ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False)
             for r in range(WORLD)]
    return ranks, want


def _assert_like_jax(res, want, what):
    _, params, stats = _flax_i3d()
    ref = _bridge64(want["params"], want["stats"])
    got = res["state"]
    assert set(got) == set(ref), what
    for k, v in ref.items():
        if not k.endswith("num_batches_tracked"):
            np.testing.assert_allclose(
                got[k].numpy(), v.numpy(), rtol=STATE_RTOL, atol=STATE_ATOL,
                err_msg=f"{what}: {k}")
    carry = _bridge64(want["grad_acc"], stats)
    for k, g in res["carry"].items():
        w = carry[k]
        np.testing.assert_allclose(
            g.numpy(), w.numpy(), rtol=0,
            atol=STATE_ATOL + STATE_RTOL * float(w.abs().max()),
            err_msg=f"{what}: the carried gradient of {k}")
    assert {k.split(".")[0] for k in res["carry"]} >= {"classifier",
                                                       "discriminator"}


def _assert_metrics(got, want, what):
    for i, ((kind, _), g, w) in enumerate(zip(STEPS, got, want)):
        keys = _D_METRICS if kind == "d" else _G_METRICS
        for k in keys:
            np.testing.assert_allclose(g[k], float(w[k]), rtol=STEP_RTOL,
                                       atol=1e-12,
                                       err_msg=f"{what}: step {i} {k}")


@pytest.mark.parametrize("name", ["dp", "fsdp"])
def test_i3d_macro_steps_match_jax_mesh(runs, name):
    """D, G, D, G macro steps of 2 microbatches on 2 ranks x 2 rows, data
    parallel and FSDP2, equal the JAX package's data-parallel steps on the
    4 rows over 2 devices (`batch_axis=1`): losses and accuracies, every
    parameter and running statistic, and the carried gradients (each
    averaged exactly once: the D-phase carry of the generator reaches the
    G step as each rank's own sum), on both ranks."""
    ranks, want = runs
    for r, res in enumerate(ranks):
        _assert_metrics(res[name]["metrics"], want["metrics"], f"rank {r}")
        _assert_like_jax(res[name], want, f"{name} rank {r}")
    if name == "fsdp":
        sharded = ranks[0]["sharded"]
        assert "mixed_5c.branch_1.1.conv3d" in sharded
        assert "classifier" not in sharded


@pytest.fixture(scope="module")
def cli_runs(runs):
    """Each rank's `cli.train_i3d.train` runs: printed lines, directory,
    per-tensor sums, moved modules."""
    return [res["cli"] for res in runs[0]]


def test_ranks_stay_identical(cli_runs):
    """After every run, the stage-2 swap's fresh optimizers included (they
    average their gradients too), both ranks hold the same parameters and
    running statistics."""
    for name, res in cli_runs[0].items():
        if name != "init":
            assert res["sums"] == cli_runs[1][name]["sums"], name


def test_auto_resume_equals_uninterrupted(cli_runs):
    """Epoch 1 then `--auto-resume` to epoch 2, on 2 ranks, ends where 2
    epochs straight through do, bit for bit: model, optimizers (the
    stage-2 swap at `--epoch-thre 1` included) and the carried gradients
    of the step directory."""
    cli = cli_runs[0]
    assert "--auto-resume: epoch 1" in cli["resumed"]["out"]
    assert "Epoch[0]" not in cli["resumed"]["out"]
    assert cli["resumed"]["grads"] > 0
    assert cli["resumed"]["mismatch"] == []


def test_auto_resume_agrees_on_oldest_epoch(cli_runs):
    """Rank 0 finds the epoch-2 directory, rank 1 does not: both resume at
    epoch 1, the oldest newest epoch (an all-reduce min, as the JAX
    command's `process_allgather(...).min()`), and end where the straight
    run does; without the agreement rank 0 would start at epoch 2 and the
    ranks' collectives would part ways."""
    cli = cli_runs[0]
    assert "--auto-resume: epoch 1" in cli["agreed"]["out"]
    assert "Epoch[1]" in cli["agreed"]["out"]
    assert cli["agreed"]["mismatch"] == []
    assert cli_runs[1]["agreed"]["out"] == ""   # rank 1 prints nothing


@pytest.mark.parametrize("name", ["fsdp", "tp"])
def test_sharded_training_directories(cli_runs, name):
    """One epoch of `train` with `--fsdp 1` and with `--tp 2` on 2 ranks:
    both ranks wrote one step directory, committed, whose model keys hold
    the whole tensors at the model's shapes; the step moved the
    discriminator and the classifier (the epoch's one macro step is a D
    step) in every rank's gathered state."""
    assert cli_runs[0][name]["dir"] == cli_runs[1][name]["dir"]
    shapes = cli_runs[0][name]["shapes"]
    init = cli_runs[0]["init"]
    for k, v in init.items():
        assert shapes["state_dict/" + k] == tuple(v.shape), k
    for r in range(WORLD):
        assert cli_runs[r][name]["moved"] >= {"discriminator", "classifier"}


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]),
            sys.argv[4])
