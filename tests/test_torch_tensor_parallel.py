"""Tensor parallelism (`dmcnet_tpu_torch/parallel/tensor.py`, `cli.train
--tp`) with 4 gloo processes on the CPU, held against the JAX package's
`shard_state_tp` + `make_fsdp_train_step` on the matching CPU meshes
(tests/conftest.py gives JAX 8 host devices; tests/test_tensor_parallel.py
is the JAX package's own test).

One set of 4 worker processes (this file run as a script, as
tests/test_torch_parallel.py does) does every check, while the test process
runs the JAX side:

  * (data 1, model 2): a 3-D (rep 2, data 1, model 2) mesh, two model rows
    stepping on all 4 rows;
  * (data 2, model 2): a 2-D mesh, each data row on 2 of the rows;
  * (data 2, model 2) with FSDP2 over `data` on the TP-sharded layers;

each the two dmcnet steps of tests/test_torch_parallel.py (DenseNetTiny and
ResNet-18 at 32x32, whose convolutions from `layer1` on clear 2**14
weights; batch 4, S = 2, float64; the first step frozen) against the JAX
steps: losses at rtol 1e-9, parameters and BN running statistics at rtol
1e-7, atol 1e-11.  Then each sharded weight's gradient (averaged as the
optimizers' hooks average it) against the unsharded model's on the whole
batch: a `g` whose backward summed over the model group would double it, an
average over every rank would mix the shards of the two model ranks.
Last, `cli.train --tp 2` over the 4 processes (a 2x2 mesh) writes a step
directory that `cli.test` scores unsharded.  Rank 0 saves its gathered
states whole and the others a digest of theirs (per-tensor sums), which
must equal rank 0's.
"""

import functools
import json
import os
import sys
import time

import numpy as np
import pytest
import torch
from test_torch_dcp_checkpoint import (  # noqa: F401 (fixture)
    common_argv,
    corpus,
    train_argv,
)
from test_torch_gan import STATE_ATOL, STATE_RTOL, _bridge64
from test_torch_parallel import (
    _METRICS,
    B,
    STEP_FLAGS,
    _assert_like_jax,
    _assert_metrics,
    _batch,
    _dmcnet_steps,
    _jax_batch,
    _model,
    _optimizers,
    _rows,
    _score,
    free_port,
    run_ranks,
)
from test_torch_train import (
    LR,
    LR_CLS_MULT,
    LR_MSE_MULT,
    WD,
    _flax_variables,
)

WORLD = 4
CASES = {"1x2": (1, 2, False), "2x2": (2, 2, False),
         "2x2-fsdp": (2, 2, True)}
CLI_SIZE = 32


# --- the worker side ---------------------------------------------------------


def _mesh(data):
    from torch.distributed.device_mesh import init_device_mesh

    if data == 1:   # two independent (1, 2) rows
        return init_device_mesh("cpu", (2, 1, 2),
                                mesh_dim_names=("rep", "data", "model"))
    return init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))


def _tp_model(init, mesh, shard_fsdp):
    from dmcnet_tpu_torch.parallel import fsdp, tensor
    from dmcnet_tpu_torch.parallel import mesh as pmesh

    model = _model(init)
    names = tensor.shard_model_tp(model, mesh)
    data_group = mesh["data"].get_group()
    pmesh.use_global_batchnorm(model, data_group)
    if shard_fsdp:
        fsdp.shard_model(model, mesh["data"])
    return model, names, data_group


def _data_rows(mesh):
    """This rank's rows, as the commands take them: the ranks of a data
    row (both model rows of the (rep, 1, 2) mesh) share its rows."""
    from dmcnet_tpu_torch.parallel.multihost import local_shard_indices

    return local_shard_indices(B, WORLD // mesh["data"].size())


def _loss(model, batch):
    """A loss through both outputs of the dmcnet model."""
    logits, gen = model(batch["mv"], batch["residual"])[:2]
    flow = batch["flow"].reshape(gen.shape)
    return logits.square().mean() + (gen - flow).square().mean()


def _gradients(init, mesh, rank):
    """Each sharded weight's gradient on this rank's rows, averaged as
    `sync_gradients` averages it, against the unsharded model's gradient
    on the whole batch, sliced to this rank's output channels: {layer:
    (the gradient, max(|got - want| - STATE_RTOL * |want|), max |want|)}
    (the largest excess over assert_allclose's rtol term, for the test's
    atol)."""
    from dmcnet_tpu_torch.parallel import mesh as pmesh

    model, names, data_group = _tp_model(init, mesh, False)
    _loss(model, _rows(_batch(), _data_rows(mesh))).backward()
    pmesh.average_gradients(model.parameters(), data_group)
    plain = _model(init)   # its BN normalizes the whole batch
    _loss(plain, _batch()).backward()
    modules = dict(model.named_modules())
    plain_modules = dict(plain.named_modules())
    n, r = mesh["model"].size(), mesh.get_local_rank("model")
    out = {}
    for name in names:
        got = modules[name].weight.grad.to_local()
        want = plain_modules[name].weight.grad.chunk(n)[r]
        excess = ((got - want).abs() - STATE_RTOL * want.abs()).max()
        out[name] = (got.clone(), float(excess), float(want.abs().max()))
    return out


def _shared_port(rank, out, name):
    """A free local port rank 0 picks just before the ranks need it and
    hands the others through a file (a port picked at the start could be
    taken by another connection meanwhile)."""
    path = os.path.join(out, name)
    if rank == 0:
        with open(path + ".tmp", "w") as f:
            f.write(str(free_port()))
        os.replace(path + ".tmp", path)
    while not os.path.exists(path):
        time.sleep(0.02)
    with open(path) as f:
        return int(f.read())


def _digest(tensors):
    """Per-tensor (sum, sum of |x|) in float64: what the ranks that keep
    no full copy save (a float64 state of this model is ~0.1 GB)."""
    return {k: (float(v.double().sum()), float(v.double().abs().sum()))
            for k, v in tensors.items()}


def _worker(rank, world, port, out):
    from dmcnet_tpu_torch.parallel import fsdp, multihost
    from dmcnet_tpu_torch.parallel import mesh as pmesh

    torch.set_num_threads(1)
    multihost.initialize_distributed(f"localhost:{port}", world, rank,
                                     device="cpu")
    init = torch.load(os.path.join(out, "init.pt"), weights_only=True)
    result = {}
    meshes = {1: _mesh(1), 2: _mesh(2)}
    for case, (data, _, shard_fsdp) in CASES.items():
        mesh = meshes[data]
        model, names, data_group = _tp_model(init, mesh, shard_fsdp)
        opts = _optimizers(model)
        fsdp.loop_optimizers(opts)
        pmesh.sync_gradients(opts, None if shard_fsdp else data_group)
        batch = _rows(_batch(), _data_rows(mesh))
        metrics = _dmcnet_steps(model, opts, batch)
        state = fsdp.gather_state(model)   # the same on every rank
        result[case] = {
            "names": names,
            "metrics": [pmesh.all_reduce_mean([m[k] for k in _METRICS])
                        for m in metrics],
            "state": state if rank == 0 else None, "digest": _digest(state)}
    # ranks 0 and 1 hold the two shards; 2 and 3 the same two again
    result["grads"], result["grad_digest"] = {}, {}
    for data in (1, 2):
        grads = _gradients(init, meshes[data], rank)
        result["grads"][data] = {k: v[1:] for k, v in grads.items()}
        result["grad_digest"][data] = _digest(
            {k: v[0] for k, v in grads.items()})
    multihost.shutdown()

    # cli.train --tp 2 over the 4 processes
    from dmcnet_tpu_torch.cli import train as train_cli

    with open(os.path.join(out, "argv.json")) as f:
        argv = json.load(f)
    real = train_cli.train

    def train(*args, **kwargs):
        res = real(*args, **kwargs)
        state = fsdp.gather_state(res.model)
        result.setdefault("cli_states", []).append(
            state if rank == 0 else None)
        result.setdefault("cli_digests", []).append(_digest(state))
        return res

    train_cli.train = train
    for i, extra in enumerate(([],   # then resumed from its directory
                               ["--epochs", "2", "--auto-resume", "1"])):
        p = _shared_port(rank, out, f"port{i}")
        train_cli.main(argv + extra + [
            "--dist-coordinator", f"localhost:{p}", "--dist-num-processes",
            str(world), "--dist-process-id", str(rank)], input_size=CLI_SIZE)
    torch.save(result, os.path.join(out, f"rank{rank}.pt"))


# --- the JAX package's side ---------------------------------------------------


def _jax_reference():
    """The JAX package's two dmcnet steps under `shard_state_tp` (with
    `with_fsdp` for the FSDP case) on a (data, model) CPU mesh per case,
    float64: {case: {metrics, params, stats}} as numpy."""
    from concurrent.futures import ThreadPoolExecutor

    import jax
    import jax.numpy as jnp

    from dmcnet_tpu.parallel import (
        make_fsdp_train_step,
        make_mesh_2d,
        shard_state_tp,
    )
    from dmcnet_tpu.train.engine import (
        TrainState,
        make_optimizers,
        make_train_step,
    )
    to_np = functools.partial(jax.tree.map, np.asarray)
    fmodel, params, stats = _flax_variables("DenseNetTiny")
    batch = _jax_batch(_batch())

    def run(case):
        data, model_n, with_fsdp = CASES[case]
        with jax.enable_x64(True):   # a thread-local setting
            f64 = jnp.float64
            to64 = functools.partial(jax.tree.map, lambda a: jnp.asarray(
                a, f64))
            p, st = to64(params), to64(stats)
            opts = make_optimizers(fmodel, p, LR_CLS_MULT, LR_MSE_MULT)
            state = TrainState(params=p, batch_stats=st,
                               opt_cls=opts["cls"].init(p),
                               opt_gf=opts["gf"].init(p))
            mesh = make_mesh_2d(data=data, model=model_n,
                                devices=jax.devices()[:data * model_n])
            state, specs = shard_state_tp(state, mesh, with_fsdp=with_fsdp)
            step = make_fsdp_train_step(make_train_step(
                fmodel, opts, num_segments=2, lr_cls_w=1.0, lr_mse_w=1.0,
                jit=False), mesh, specs)
            metrics = []
            for flag in STEP_FLAGS:
                state, m = step(state, batch, jax.random.key(1), f64(LR),
                                f64(WD), jnp.asarray(flag))
                metrics.append(to_np(m))
            return case, {"metrics": metrics, "params": to_np(state.params),
                          "stats": to_np(state.batch_stats)}

    with ThreadPoolExecutor(len(CASES)) as pool:
        return dict(pool.map(run, CASES))


# --- the test side -----------------------------------------------------------


@pytest.fixture(scope="module")
def runs(corpus, tmp_path_factory):  # noqa: F811
    tmp = tmp_path_factory.mktemp("tp_ranks")
    _, params, stats = _flax_variables("DenseNetTiny")
    torch.save({"dmcnet": _bridge64(params, stats)}, tmp / "init.pt")
    prefix = str(tmp / "tp")
    with open(tmp / "argv.json", "w") as f:
        json.dump(train_argv(corpus, prefix, 4, [
            "--epochs", "1", "--epoch-thre", "0", "--eval-freq", "1",
            "--tp", "2", "--ckpt-backend", "orbax"]), f)
    want = {}
    port = free_port()
    outs = run_ranks(
        [[sys.executable, os.path.abspath(__file__), str(r), str(WORLD),
          str(port), str(tmp)] for r in range(WORLD)],
        meanwhile=lambda: want.update(_jax_reference()))
    ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=True)
             for r in range(WORLD)]
    return ranks, want, outs, prefix + "_mv_checkpoint.pth.tar.orbax", tmp


@pytest.mark.parametrize("case", list(CASES))
def test_tp_steps_match_jax(runs, case):
    """Two dmcnet steps with the large layers' output channels sharded over
    the `model` ranks equal the JAX package's steps under `shard_state_tp`
    on the same (data, model) mesh: losses and accuracies, every parameter
    and running statistic, on every rank.  ResNet-18's convolutions from
    `layer1` on and the generator's widest convolutions are sharded; the
    stem, BN and the 5-class classifier are not."""
    ranks, want = runs[:2]
    for r, res in enumerate(ranks):
        got = res[case]
        assert "base_model.layer4.1.conv2" in got["names"]
        assert "base_model.layer1.0.conv1" in got["names"]
        assert not {"base_model.conv1", "base_model.fc"} & set(got["names"])
        _assert_metrics(got["metrics"], want[case]["metrics"], _METRICS,
                        f"{case} rank {r}")
        # rank 0's gathered state, every other rank's the same
        assert got["digest"] == ranks[0][case]["digest"], (case, r)
    _assert_like_jax(ranks[0][case]["state"], want[case], case)


@pytest.mark.parametrize("data", [1, 2], ids=["1x2", "2x2"])
def test_tp_weight_gradients_equal_unsharded(runs, data):
    """Each sharded weight's gradient (its output channels' slice, averaged
    over the data group) equals the unsharded model's gradient on the whole
    batch: g's backward slices the output gradient (a sum over the model
    ranks would double it) and the shards average over `data` only (an
    average over every rank would mix the two model ranks' channels)."""
    ranks = runs[0]
    for r, res in enumerate(ranks):
        grads = res["grads"][data]
        assert len(grads) >= 10
        for name, (excess, want_max) in grads.items():
            # assert_allclose(got, want, rtol=STATE_RTOL, atol=...)
            assert excess <= STATE_ATOL + STATE_RTOL * want_max, (r, name)
    for r in (2, 3):   # the same shards on the other data row
        assert ranks[r]["grad_digest"][data] == \
            ranks[r - 2]["grad_digest"][data], r


def test_cli_train_tp_directory(runs, corpus):  # noqa: F811
    """`cli.train --tp 2` over 4 processes (a 2x2 mesh, each data row on 2
    of the 4 rows) for an epoch, then `--auto-resume` to a second from the
    step directory each rank wrote its shards of: every rank ends with the
    same gathered parameters, the directory holds them whole, and
    `cli.test` scores from it unsharded."""
    from dmcnet_tpu_torch.train import checkpoints as tckpt

    ranks, _, outs, directory, tmp = runs
    assert "tensor-parallel 2x2 mesh" in outs[0]
    assert "tensor-parallel" not in outs[1]
    assert f"--auto-resume: found {directory}" in outs[0]
    assert f"=> loaded checkpoint '{directory}' (epoch 1)" in outs[0]
    assert "Epoch: [1]" in outs[0]
    for run in range(2):   # the first run, then the resumed one
        for r in range(1, WORLD):
            assert ranks[r]["cli_digests"][run] == \
                ranks[0]["cli_digests"][run], (run, r)
    # the directory's newest step: a best epoch's state (the run saves
    # on a best epoch only)
    full = tckpt.read_model_state(directory)
    newest = tckpt._committed_steps(directory)[-1]
    for k, v in ranks[0]["cli_states"][newest - 1].items():
        assert torch.equal(full[k], v), k
    assert full["base_model.layer4.1.conv2.weight"].shape == (512, 512, 3, 3)
    scores = _score(corpus, directory, tmp)
    assert scores.shape == (4, 1, 51) and np.isfinite(scores).all()


def test_tp_checks_and_refusals(monkeypatch):
    """The JAX commands' rules: `--tp` must divide the processes and the
    data axis the batch, and across processes it writes step directories
    only; the plan shards output channels that divide the model axis."""
    from dmcnet_tpu_torch.cli.common import check_parallel_flags
    from dmcnet_tpu_torch.parallel import tensor

    with pytest.raises(SystemExit, match="--tp 3 must divide"):
        check_parallel_flags(4, 8, 3, False, True)
    with pytest.raises(SystemExit, match="must be divisible by the data"):
        check_parallel_flags(4, 3, 2, False, True)
    with pytest.raises(SystemExit, match="--tp across processes requires"):
        check_parallel_flags(4, 8, 2, False, False)
    check_parallel_flags(4, 2, 2, True, True)
    model = torch.nn.Sequential(torch.nn.Conv2d(128, 128, 1),
                                torch.nn.Conv2d(128, 127, 1),
                                torch.nn.Linear(64, 64))
    assert tensor.tp_plan(model, 2) == ["0"]
    monkeypatch.setattr(tensor, "DEFAULT_MIN_SIZE", 4096)
    assert tensor.tp_plan(model, 2) == ["0", "2"]


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]),
            sys.argv[4])
