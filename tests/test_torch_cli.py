"""The port's training slice as a whole on the CPU: `cli.train` ->
`cli.test` -> `cli.combine` on a synthetic corpus built like
tests/test_cli_e2e.py:16-44, and both packages' train and test CLIs from
one initialisation.

The shared initialisation is written by the JAX package's
`save_reference_checkpoint` and passed to both train CLIs as `--weights`,
which fills every tensor, so the JAX CLIs' own eager flax init is swapped
for zeros of its shapes (`zero_flax_init`);
`--workers 1` makes the data layers' draw counters advance in the same
order, so both see the same videos, frames and crops.  Two epochs, the
first in the freeze phase, one batch each; `SAVE_FREQ` is set to 1 in both
CLIs so that each saves after every epoch, and the test keeps each saved
state dict.  The flags give each group its own step size (lr 1e-3, classifier
multiplier 0.5, generator 1) and a weight decay (0.05) large enough that a
swapped multiplier or a dropped decay changes the updates.

Float32 tolerances: the `--metrics-jsonl` losses and accuracies at rtol
1e-4; both test CLIs' scores on the port's checkpoint at rtol 1e-4, atol
2e-4 (tests/test_torch_models.py).  Parameters are held by their updates,
not their values: after each epoch, per tensor, |d_port - d_jax| / |d_jax|
with d = state - init.  The two data layers' crops differ by up to 5e-5
after normalization (tests/test_torch_data.py), and Adam (eps 1e-3) turns a
gradient near eps into a step that follows that noise, so single weights
can differ by a step while each tensor's update agrees.

BN running statistics are compared by value.  Train-mode batch means carry
the crops' differences into the running means: up to 5.0e-5 apart, many
near zero where no relative tolerance applies.  A running mean is therefore
held at 5e-4 of its channel's running standard deviation, the scale of the
activations it averages; running variances at rtol 5e-4, atol 5e-6.  With
identical inputs (tests/test_torch_train.py) parameters and running
statistics agree at rtol 5e-4, atol 5e-6.
"""

import json
import os
import types

import numpy as np
import pytest
import torch
from PIL import Image
from test_torch_train import _two_torch_threads  # noqa: F401 (autouse)
from test_torch_train import flax_init

from dmcnet_tpu_torch.codec.mpeg4 import encode_mpeg4

H, W, T, NVID = 96, 112, 30, 3
SIZE = 64
PARAM_RTOL, PARAM_ATOL = 5e-4, 5e-6
LOSS_RTOL = 1e-4
# |d_port - d_jax| / |d_jax| per tensor, (worst, median), for the generator
# (both epochs) and the classifier (epoch 2).  Measured on the CPU: generator
# 2.1e-5 / 7.4e-6, classifier 0.311 / 0.054, the worst a layer1 BN scale.
UPDATE_RTOL = {"gen": (1e-4, 5e-5), "cls": (0.6, 0.1)}
SCORE_RTOL, SCORE_ATOL = 1e-4, 2e-4
COMPARE_FLAGS = ["--lr", "0.001", "--lr-steps", "1", "--lr-decay", "0.1",
                 "--lr_cls_mult", "0.5", "--lr_mse_mult", "1",
                 "--weight-decay", "0.05"]
_BUFFERS = ("running_mean", "running_var", "num_batches_tracked")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_cli")
    data_root = root / "videos"
    flow_root = root / "flow"
    rng = np.random.default_rng(11)
    lines = []
    for v in range(NVID):
        os.makedirs(data_root / "cls", exist_ok=True)
        frames = (rng.integers(0, 256, size=(T, H, W, 3)) // 4 * 4).astype(
            np.uint8)
        encode_mpeg4(str(data_root / "cls" / f"v{v}.mp4"), frames,
                     gop_size=12, bit_rate=1_000_000)
        fdir = flow_root / "cls" / f"v{v}"
        os.makedirs(fdir)
        for i in range(1, T + 1):
            for ax in "xy":
                Image.fromarray(rng.integers(0, 256, size=(H, W),
                                             dtype=np.uint8), mode="L").save(
                    fdir / f"flow_{ax}_{i:05d}.jpg")
        lines.append(f"cls/v{v}.avi 0 {v % 2}")
    train_list = root / "train.txt"
    train_list.write_text("\n".join(lines) + "\n")
    return dict(data_root=str(data_root), flow_root=str(flow_root),
                list=str(train_list))


def _common(corpus):
    """The flags of examples/hmdb51_gen_flow/run.sh shared by train and
    test."""
    return ["--data-name", "hmdb51", "--data-root", corpus["data_root"],
            "--flow-root", corpus["flow_root"], "--representation", "mv",
            "--arch", "resnet18", "--arch_estimator", "DenseNetTiny",
            "--no-accumulation", "--mv_minmaxnorm", "1",
            "--flow_ds_factor", "16", "--gen_flow_or_delta", "1"]


def _train_args(corpus, prefix, epochs=2):
    return _common(corpus) + [
        "--num_segments", "2", "--train-list", corpus["list"],
        "--test-list", corpus["list"], "--epochs", str(epochs),
        "--epoch-thre", "1", "--batch-size", "3",
        "--lr-mse", "1", "--eval-freq", "1", "--workers", "1",
        "--model-prefix", prefix]


def _test_args(corpus, weights, scores):
    return _common(corpus) + [
        "--test-list", corpus["list"], "--weights", weights,
        "--test_segments", "2", "--test-crops", "1", "--input_size",
        str(SIZE), "--save-scores", scores]


def zero_flax_init(mp, *classes):
    """Make `init` of each flax Module class in `classes` return zeros of
    its variables' shapes (`jax.eval_shape`) instead of running eagerly,
    ~20 s a call on an 8-core CPU.  Only around JAX CLI runs whose
    checkpoint (`--weights`) fills every parameter and statistic, which
    then overwrites the zeros as it overwrites an init."""
    import functools

    import flax.linen as fnn
    import jax
    import jax.numpy as jnp

    def zeros_init(self, rngs, *args, **kwargs):
        shapes = jax.eval_shape(functools.partial(fnn.Module.init, self,
                                                  **kwargs), rngs, *args)
        # numpy zeros put on the device: no program compiled per shape
        return jax.tree.map(lambda x: jnp.asarray(np.zeros(x.shape, x.dtype)),
                            shapes)

    for cls in classes:
        mp.setattr(cls, "init", zeros_init)


def _scores(path):
    with np.load(path, allow_pickle=True) as data:
        return (np.stack([s[0] for s in data["scores"]]),
                list(data["labels"]), list(data["names"]))


def test_port_train_test_combine(corpus, tmp_path, capsys):
    """train (with --metrics-jsonl and --save-reference-ckpt) -> a resumed
    second epoch (--auto-resume) -> test -> combine, all on the CPU."""
    from dmcnet_tpu_torch.cli import combine as combine_cli
    from dmcnet_tpu_torch.cli import test as test_cli
    from dmcnet_tpu_torch.cli import train as train_cli

    prefix = str(tmp_path / "model")
    jsonl = str(tmp_path / "metrics.jsonl")
    args = _train_args(corpus, prefix, epochs=1) + [
        "--device", "cpu", "--workers", "2", "--metrics-jsonl", jsonl,
        "--save-reference-ckpt", "1"]
    assert train_cli.main(args, input_size=SIZE) >= 0.0
    ckpt = prefix + "_mv_checkpoint.pth.tar"
    payload = torch.load(ckpt, map_location="cpu", weights_only=True)
    assert payload["epoch"] == 1 and payload["arch"] == "resnet18"
    ref = torch.load(ckpt + ".ref.pth.tar", map_location="cpu",
                     weights_only=True)
    assert set(ref) == {"epoch", "arch", "best_prec1", "state_dict"}
    with open(jsonl) as f:
        kinds = [line.split('"kind": "')[1].split('"')[0] for line in f]
    assert kinds == ["train", "eval"]

    capsys.readouterr()
    train_cli.main(_train_args(corpus, prefix) + [
        "--device", "cpu", "--auto-resume", "1"], input_size=SIZE)
    out = capsys.readouterr().out
    assert f"--auto-resume: found {ckpt}" in out
    assert "Epoch: [1][0/1]" in out and "Epoch: [0]" not in out

    score_file = str(tmp_path / "mv_score")
    acc = test_cli.main(_test_args(corpus, ckpt, score_file)
                        + ["--device", "cpu"])
    assert 0.0 <= acc <= 1.0
    scores, labels, names = _scores(score_file + ".npz")
    assert scores.shape == (NVID, 1, 51) and np.isfinite(scores).all()
    assert names == sorted(names) and labels == [0, 1, 0]
    fused, n = combine_cli.combine(*[score_file + ".npz"] * 4)
    assert n == NVID and 0.0 <= fused <= 1.0


@pytest.mark.parametrize("flags,message", [
    (["--pp", "2", "--arch", "resnet34"], "--pp currently supports --arch "
     "resnet18"),
    (["--pp", "2", "--viz", "1"], "--pp composes with the plain scoring"),
    (["--pp", "4", "--arch_d", "Discriminator"], "--pp composes with the "
     "plain scoring"),
    (["--pp", "2", "--att", "1"], "--pp composes with the plain scoring"),
    (["--plain", "1", "--viz", "1"], "--plain scores the bare TSN backbone"),
], ids=["pp_arch", "pp_viz", "pp_arch_d", "pp_att", "plain_viz"])
def test_refused_flag_combinations(corpus, flags, message):
    """The JAX test command's refusals (dmcnet_tpu/cli/test.py:113-115,
    197-201): each combination stops the command before it reads a
    video."""
    from dmcnet_tpu_torch.cli import test as test_cli

    argv = _test_args(corpus, "unused", "unused") + flags + [
        "--device", "cpu"]   # a later --arch overrides the first
    with pytest.raises(SystemExit, match=message):
        test_cli.main(argv)


@pytest.mark.parametrize("flags", [
    ["--fsdp", "1"], ["--dist-coordinator", "localhost:1234"],
    ["--ckpt-backend", "orbax-async"], ["--tp", "2"]],
    ids=["fsdp", "coordinator", "orbax", "tp"])
def test_ported_flags_work(corpus, tmp_path, capsys, flags):
    """Flags that raised before their slice was ported: `--fsdp` on one
    process has nothing to shard and trains; a coordinator without a
    process count stops with the JAX package's error; `orbax-async`
    writes a committed step directory; `--tp 2` on one process stops
    with the JAX package's divisibility error (tests/test_torch_parallel.py,
    tests/test_torch_tensor_parallel.py and
    tests/test_torch_dcp_checkpoint.py run them in full)."""
    from dmcnet_tpu_torch.cli import train as train_cli
    from dmcnet_tpu_torch.train.checkpoints import dcp_checkpoint_committed

    prefix = str(tmp_path / "model")
    argv = _train_args(corpus, prefix, epochs=1) + ["--device", "cpu"] \
        + flags
    if flags[0] == "--dist-coordinator":
        with pytest.raises(ValueError, match="without --dist-num-processes"):
            train_cli.main(argv, input_size=SIZE)
        return
    if flags[0] == "--tp":
        with pytest.raises(SystemExit, match="--tp 2 must divide the number "
                           "of processes"):
            train_cli.main(argv, input_size=SIZE)
        return
    train_cli.main(argv, input_size=SIZE)
    ckpt = prefix + "_mv_checkpoint.pth.tar"
    if flags[0] == "--fsdp":
        assert "--fsdp 1 on one process: nothing to shard" in \
            capsys.readouterr().out
        assert os.path.isfile(ckpt)
    else:
        assert dcp_checkpoint_committed(ckpt + ".orbax")
        assert os.listdir(ckpt + ".orbax") == ["1"]
        assert not os.path.exists(ckpt)


def test_test_cli_ignores_extra_gpus(corpus, tmp_path):
    """A JAX-style `--gpus 0 1` (the JAX command parses it and never reads
    it) scores on the first id, as the same command line without it."""
    from dmcnet_tpu_torch.cli import test as test_cli
    from dmcnet_tpu_torch.cli import train as train_cli
    from dmcnet_tpu_torch.cli.train_options import build_parser

    model = train_cli.build_model(build_parser().parse_args(
        _train_args(corpus, "unused")), 51, SIZE)
    weights = str(tmp_path / "w.pth")
    torch.save(model.state_dict(), weights)
    got = []
    for extra in ([], ["--gpus", "0", "1"]):
        out = str(tmp_path / f"scores{len(got)}")
        test_cli.main(_test_args(corpus, weights, out)
                      + ["--device", "cpu"] + extra)
        got.append(_scores(out + ".npz"))
    np.testing.assert_array_equal(got[1][0], got[0][0])
    assert got[1][1:] == got[0][1:]


def _is_buffer(key):
    return key.rsplit(".", 1)[-1] in _BUFFERS


def _check_phases(sd, init_sd, side):
    """The freeze phase on one side's per-epoch state dicts: the classifier
    bit-unchanged in epoch 1 and moved in epoch 2, every generator tensor
    moved in both epochs."""
    for k, v in init_sd.items():
        if _is_buffer(k):
            continue
        before, e1, e2 = v, sd[1][k], sd[2][k]
        if k.startswith("base_model."):
            assert torch.equal(e1, before), f"{side}: frozen {k} moved"
            assert not torch.equal(e2, e1), f"{side}: {k} never trained"
        else:
            assert not torch.equal(e1, before), f"{side}: {k} still in epoch 1"
            assert not torch.equal(e2, e1), f"{side}: {k} still in epoch 2"


def test_train_and_test_clis_match_jax(corpus, tmp_path, monkeypatch):
    """Both train CLIs from one exported initialisation, their state dicts
    kept after each epoch: the same tensors move on both sides (the
    classifier not in the freeze epoch), each tensor's update matches the
    JAX update, and the BN statistics agree; both test CLIs score the
    port's checkpoint alike."""
    import jax
    import jax.numpy as jnp

    from dmcnet_tpu.cli import test as jax_test_cli
    from dmcnet_tpu.cli import train as jax_train_cli
    from dmcnet_tpu.models import DMCNet as FlaxDMCNet
    from dmcnet_tpu.models import export_torch
    from dmcnet_tpu_torch.cli import test as test_cli
    from dmcnet_tpu_torch.cli import train as train_cli

    fmodel = FlaxDMCNet(num_class=51, num_segments=2,
                        arch_estimator="DenseNetTiny", gen_flow_or_delta=1)
    variables = flax_init(
        fmodel, jax.random.key(3), jnp.zeros((1, 1, SIZE, SIZE, 2)),
        jnp.zeros((1, 1, SIZE, SIZE, 3)), train=False)
    init = str(tmp_path / "init.pth.tar")
    export_torch.save_reference_checkpoint(types.SimpleNamespace(
        params=variables["params"], batch_stats=variables["batch_stats"]),
        init)
    init_sd = torch.load(init, map_location="cpu",
                         weights_only=True)["state_dict"]

    # each CLI's state dict after every epoch, as it saves it
    saved = {"jax": {}, "port": {}}
    save_ref = export_torch.save_reference_checkpoint
    save_port = train_cli.save_checkpoint

    def jax_save(state, path, epoch=0, **kw):
        save_ref(state, path, epoch=epoch, **kw)
        saved["jax"][epoch] = torch.load(path, map_location="cpu",
                                         weights_only=True)["state_dict"]

    def port_save(model, meta, filename, *a, **kw):
        saved["port"][meta["epoch"]] = {
            k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
        return save_port(model, meta, filename, *a, **kw)

    monkeypatch.setattr(export_torch, "save_reference_checkpoint", jax_save)
    monkeypatch.setattr(train_cli, "save_checkpoint", port_save)
    monkeypatch.setattr(jax_train_cli, "SAVE_FREQ", 1)
    monkeypatch.setattr(train_cli, "SAVE_FREQ", 1)
    zero_flax_init(monkeypatch, FlaxDMCNet)
    jax_prefix = str(tmp_path / "jax")
    jax_train_cli.main(_train_args(corpus, jax_prefix) + COMPARE_FLAGS + [
        "--weights", init, "--save-reference-ckpt", "1",
        "--metrics-jsonl", jax_prefix + ".jsonl"], input_size=SIZE)
    port_prefix = str(tmp_path / "port")
    train_cli.main(_train_args(corpus, port_prefix) + COMPARE_FLAGS + [
        "--weights", init, "--device", "cpu",
        "--metrics-jsonl", port_prefix + ".jsonl"], input_size=SIZE)
    logs = []
    for prefix in (jax_prefix, port_prefix):
        with open(prefix + ".jsonl") as f:
            logs.append([json.loads(line) for line in f])
    assert [r["kind"] for r in logs[0]] == [r["kind"] for r in logs[1]] \
        == ["train", "eval"] * 2
    for want_rec, got_rec in zip(*logs):
        for k in ("loss", "top1", "top5", "prec1"):
            if k in want_rec:
                np.testing.assert_allclose(got_rec[k], want_rec[k],
                                           rtol=LOSS_RTOL, err_msg=k)

    assert sorted(saved["jax"]) == sorted(saved["port"]) == [1, 2]
    for side in ("jax", "port"):
        _check_phases(saved[side], init_sd, side)
    rel = {"gen": {}, "cls": {}}  # (epoch, key) -> |d_port - d_jax| / |d_jax|
    for epoch in (1, 2):
        want, got = saved["jax"][epoch], saved["port"][epoch]
        for k, v in want.items():
            d_jax = v - init_sd[k]
            if not _is_buffer(k) and d_jax.any():
                part = "cls" if k.startswith("base_model.") else "gen"
                rel[part][epoch, k] = float(
                    (got[k] - init_sd[k] - d_jax).norm() / d_jax.norm())
    for part, (worst_tol, median_tol) in UPDATE_RTOL.items():
        worst = max(rel[part], key=rel[part].get)
        median = float(np.median(list(rel[part].values())))
        assert rel[part][worst] <= worst_tol, (worst, rel[part][worst])
        assert median <= median_tol, (part, median)

    for k, v in saved["jax"][2].items():
        if not _is_buffer(k):
            continue
        got = saved["port"][2][k]
        if k.endswith("running_mean"):
            std = saved["jax"][2][k[:-len("mean")] + "var"].sqrt()
            diff = (got - v).abs()
            assert bool((diff <= PARAM_RTOL * std).all()), \
                (k, float((diff / std).max()))
        else:
            np.testing.assert_allclose(got.numpy(), v.numpy(),
                                       rtol=PARAM_RTOL, atol=PARAM_ATOL,
                                       err_msg=k)

    port_ckpt = port_prefix + "_mv_checkpoint.pth.tar"
    jax_scores = str(tmp_path / "jax_scores")
    port_scores = str(tmp_path / "port_scores")
    jax_test_cli.main(_test_args(corpus, port_ckpt, jax_scores))
    test_cli.main(_test_args(corpus, port_ckpt, port_scores)
                  + ["--device", "cpu"])
    s_jax, l_jax, n_jax = _scores(jax_scores + ".npz")
    s_port, l_port, n_port = _scores(port_scores + ".npz")
    assert (l_port, n_port) == (l_jax, n_jax)
    np.testing.assert_allclose(s_port, s_jax, rtol=SCORE_RTOL,
                               atol=SCORE_ATOL)


def test_test_cli_packed_gen(corpus, tmp_path):
    """`cli.test --packed-gen 2` scores the same checkpoint as
    `--packed-gen 0` within float32 round-off: the packed layout is a
    reparameterization of the same parameters."""
    from dmcnet_tpu_torch.cli import test as test_cli
    from dmcnet_tpu_torch.cli import train as train_cli
    from dmcnet_tpu_torch.cli.train_options import build_parser

    model = train_cli.build_model(build_parser().parse_args(
        _train_args(corpus, "unused")), 51, SIZE)
    weights = str(tmp_path / "w.pth")
    torch.save(model.state_dict(), weights)
    got = []
    for s in ("0", "2"):
        out = str(tmp_path / f"scores{s}")
        test_cli.main(_test_args(corpus, weights, out)
                      + ["--device", "cpu", "--packed-gen", s])
        got.append(_scores(out + ".npz")[0])
    np.testing.assert_allclose(got[1], got[0], rtol=1e-5, atol=1e-6)


def test_train_cli_packed_gen(corpus, tmp_path):
    """A `cli.train --packed-gen 2` epoch (the generator trains, the
    classifier is frozen, its BN statistics move) leaves the state of
    `--packed-gen 0` within float32 round-off, under the same checkpoint
    keys."""
    from dmcnet_tpu_torch.cli import train as train_cli

    states = []
    for s in ("0", "2"):
        prefix = str(tmp_path / f"p{s}")
        train_cli.main(_train_args(corpus, prefix, epochs=1)
                       + ["--device", "cpu", "--packed-gen", s],
                       input_size=SIZE)
        states.append(torch.load(prefix + "_mv_checkpoint.pth.tar",
                                 map_location="cpu",
                                 weights_only=True)["state_dict"])
    assert states[0].keys() == states[1].keys()
    # measured: at most 2.1e-6 apart (a layer4 BN running variance of 1.2)
    for k, v in states[0].items():
        torch.testing.assert_close(states[1][k], v, rtol=1e-5, atol=1e-5,
                                   msg=k)
