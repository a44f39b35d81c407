"""The port's dmcnet_GAN commands on the CPU: `cli.train_gan` -> `cli.test
--arch_d` -> `cli.combine` on a small corpus, `--weights` from a dmcnet
checkpoint, both packages' `train_gan` and `test --arch_d` commands from
one initialisation, and `cli.test --plain 1` for the flow and mv
representations against the JAX test command.

The corpus has tests/test_torch_cli.py's layout (videos/cls/vN.mp4, flow
JPEGs, list lines `cls/vN.avi 0 label`) with 4 videos whose frames pan
across random 8x8 blocks (pixel noise would encode as I-frames, whose MV
and residual are zero).  With `--batch-size 2` an epoch is one D step and
one G step.

CLI against CLI: the JAX command's variables at flax's shapes drawn with
numpy (tests/test_torch_train.py `_draw`) are written by the JAX package's
`save_reference_checkpoint` and passed to both train commands as
`--weights`; `--workers 1` keeps both data layers on one stream of videos,
frames and crops.  Every JAX command here loads a checkpoint that fills
each variable, so its eager flax init is swapped for zeros of its shapes
(tests/test_torch_cli.py `zero_flax_init`).  Two epochs, the first
frozen; both commands save after each epoch (`SAVE_FREQ` = 1) and the
test keeps each saved state dict.  The
discriminators' dropout is off on both sides (tests/test_torch_gan.py
`dropout_off`, `jax_dropout_off`): the two frameworks cannot draw the same
masks.  Each group has its own step size (lr 1e-3; classifier 0.5,
generator 1, discriminator 0.25) and a weight decay of 0.05.

Tolerances (float32): the `--metrics-jsonl` losses and accuracies at rtol
1e-4; scores at rtol 1e-4, atol 2e-4; the G adversarial accuracies equal.
Parameters are held by their updates d = state - init, per tensor,
|d_port - d_jax| / |d_jax| (see tests/test_torch_cli.py): limits in
UPDATE_RTOL, set from readings on a CPU.  BN running statistics as in
tests/test_torch_cli.py.
"""

import json
import os
import re
import types

import numpy as np
import pytest
import torch
from PIL import Image
from test_torch_cli import _is_buffer, zero_flax_init
from test_torch_gan import dropout_off, jax_dropout_off
from test_torch_i3d_data import panning_canvas
from test_torch_train import _draw, _two_torch_threads  # noqa: F401

from dmcnet_tpu_torch.codec.mpeg4 import encode_mpeg4

H, W, T, NVID = 96, 112, 30, 4
SIZE = 64
LOSS_RTOL = 1e-4
SCORE_RTOL, SCORE_ATOL = 1e-4, 2e-4
PARAM_RTOL, PARAM_ATOL = 5e-4, 5e-6
# |d_port - d_jax| / |d_jax| per tensor, (worst, median), for the generator
# (both epochs), the discriminator (both epochs) and the classifier (epoch
# 2).  Measured on a CPU: generator 1.8e-3 / 6.5e-5 (the worst a conv
# bias), discriminator 5.3e-5 / 1.2e-5, classifier 4.3e-3 / 4.3e-5.
UPDATE_RTOL = {"gen": (0.01, 3e-4), "d": (3e-4, 6e-5), "cls": (0.02, 2e-4)}
GAN_FLAGS = ["--lr", "0.001", "--lr-steps", "1", "--lr-decay", "0.1",
             "--lr_cls_mult", "0.5", "--lr_mse_mult", "1",
             "--lr_d_mult", "0.25", "--lr-adv-g", "0.5", "--lr-adv-d", "0.75",
             "--weight-decay", "0.05"]
PARTS = (("base_model.", "cls"), ("gen_flow_model.", "gen"),
         ("discriminator.", "d"))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_gan_cli")
    data_root, flow_root = root / "videos", root / "flow"
    os.makedirs(data_root / "cls")
    rng = np.random.default_rng(13)
    lines = []
    for v in range(NVID):
        canvas = panning_canvas(rng, H + T, W + 2 * NVID * T)
        frames = np.stack([canvas[i:i + H, (v + 1) * i:(v + 1) * i + W]
                           for i in range(T)])
        encode_mpeg4(str(data_root / "cls" / f"v{v}.mp4"), frames,
                     gop_size=12, bit_rate=1_000_000)
        fdir = flow_root / "cls" / f"v{v}"
        os.makedirs(fdir)
        for i in range(1, T + 1):
            for ax in "xy":
                Image.fromarray(rng.integers(0, 256, size=(H, W),
                                             dtype=np.uint8), mode="L").save(
                    fdir / f"flow_{ax}_{i:05d}.jpg")
        lines.append(f"cls/v{v}.avi 0 {v % 3}")
    listing = root / "list.txt"
    listing.write_text("\n".join(lines) + "\n")
    return dict(data_root=str(data_root), flow_root=str(flow_root),
                list=str(listing))


def _common(corpus, representation="mv"):
    """examples/hmdb51_gan/run.sh's flags shared by train and test."""
    return ["--data-name", "hmdb51", "--data-root", corpus["data_root"],
            "--flow-root", corpus["flow_root"],
            "--representation", representation, "--arch", "resnet18",
            "--arch_estimator", "DenseNetTiny", "--no-accumulation",
            "--mv_minmaxnorm", "1", "--flow_ds_factor", "16",
            "--gen_flow_or_delta", "1"]


def _train_args(corpus, prefix, epochs=2):
    return _common(corpus) + [
        "--arch_d", "Discriminator", "--num_segments", "2",
        "--train-list", corpus["list"], "--test-list", corpus["list"],
        "--epochs", str(epochs), "--epoch-thre", "1", "--batch-size", "2",
        "--lr-mse", "1", "--eval-freq", "1", "--workers", "1",
        "--model-prefix", prefix]


def _test_args(corpus, weights, scores, representation="mv"):
    return _common(corpus, representation) + [
        "--test-list", corpus["list"], "--weights", weights,
        "--test_segments", "3", "--test-crops", "10", "--input_size",
        str(SIZE), "--save-scores", scores]


def _scores(path):
    with np.load(path, allow_pickle=True) as data:
        return (np.stack([s[0] for s in data["scores"]]),
                list(data["labels"]), list(data["names"]))


def _g_adv(out):
    """The G adversarial accuracy a test command printed, in percent."""
    found = re.findall(r"G adversarial accuracy ([0-9.]+)%", out)
    assert len(found) == 1, out
    return float(found[0])


def test_port_train_gan_test_combine(corpus, tmp_path, capsys, monkeypatch):
    """train_gan (D and G lines, loss_adv in the metrics log, three
    optimizers in the checkpoint) -> a resumed second epoch
    (--auto-resume restores all three) -> test --arch_d (G adversarial
    accuracy) -> combine, all on the CPU."""
    from dmcnet_tpu_torch.cli import combine as combine_cli
    from dmcnet_tpu_torch.cli import test as test_cli
    from dmcnet_tpu_torch.cli import train as train_cli
    from dmcnet_tpu_torch.cli import train_gan

    monkeypatch.setattr(train_cli, "PRINT_FREQ", 1)
    monkeypatch.setattr(train_cli, "SAVE_FREQ", 1)  # save every epoch
    prefix = str(tmp_path / "gan")
    jsonl = str(tmp_path / "metrics.jsonl")
    assert train_gan.main(_train_args(corpus, prefix, epochs=1) + [
        "--device", "cpu", "--metrics-jsonl", jsonl],
        input_size=SIZE) >= 0.0
    out = capsys.readouterr().out
    assert re.search(r"^D Epoch: \[0\]\[0/2\].*Loss_adv .*acc_D_adv .*"
                     r"acc_G_adv", out, re.M), out
    assert re.search(r"^G Epoch: \[0\]\[1/2\]", out, re.M), out
    ckpt = prefix + "_mv_checkpoint.pth.tar"
    payload = torch.load(ckpt, map_location="cpu", weights_only=True)
    assert {"optimizer_cls", "optimizer_gf", "optimizer_d"} <= set(payload)
    assert any(k.startswith("discriminator.") for k in payload["state_dict"])
    with open(jsonl) as f:
        records = [json.loads(line) for line in f]
    assert [r["kind"] for r in records] == ["train", "train", "eval"]
    assert all("loss_adv" in r for r in records[:2])

    train_gan.main(_train_args(corpus, prefix) + [
        "--device", "cpu", "--auto-resume", "1"], input_size=SIZE)
    out = capsys.readouterr().out
    assert f"--auto-resume: found {ckpt}" in out
    assert "Epoch: [1][0/2]" in out and "Epoch: [0]" not in out
    resumed = torch.load(ckpt, map_location="cpu", weights_only=True)
    for key in ("optimizer_cls", "optimizer_gf", "optimizer_d"):
        steps = {float(s["step"]) for s in resumed[key]["state"].values()}
        # one step of each optimizer per epoch: D steps cls and d, G gf
        assert steps == {2.0}, (key, steps)

    score_file = str(tmp_path / "gan_score")
    acc = test_cli.main(_test_args(corpus, ckpt, score_file) + [
        "--arch_d", "Discriminator", "--device", "cpu"])
    assert 0.0 <= acc <= 1.0
    assert 0.0 <= _g_adv(capsys.readouterr().out) <= 100.0
    scores, labels, names = _scores(score_file + ".npz")
    assert scores.shape == (NVID, 1, 51) and np.isfinite(scores).all()
    assert names == sorted(names) and labels == [v % 3 for v in range(NVID)]
    fused, n = combine_cli.combine(*[score_file + ".npz"] * 4)
    assert n == NVID and 0.0 <= fused <= 1.0


def test_weights_from_dmcnet_checkpoint(corpus, tmp_path, capsys):
    """train_gan --weights <dmcnet checkpoint> (examples/hmdb51_gan/run.sh):
    every key but `discriminator.*` loads, those are reported missing."""
    from dmcnet_tpu_torch.cli import train as train_cli
    from dmcnet_tpu_torch.cli.train_options import build_parser
    from dmcnet_tpu_torch.models.tsn import DMCNet
    from dmcnet_tpu_torch.train.checkpoints import save_checkpoint

    torch.manual_seed(5)
    src = DMCNet(51, num_segments=2, arch_estimator="DenseNetTiny",
                 gen_flow_or_delta=1)
    weights = str(tmp_path / "dmcnet_mv_checkpoint.pth.tar")
    save_checkpoint(src, {"epoch": 1, "arch": "resnet18",
                          "best_prec1": 0.0}, weights)
    args = build_parser(gan=True).parse_args(
        _train_args(corpus, str(tmp_path / "gan"), epochs=0)
        + ["--weights", weights])
    result = train_cli.train(args, *train_cli.make_datasets(args),
                             device="cpu", input_size=SIZE)
    sd = result.model.state_dict()
    n_d = sum(k.startswith("discriminator.") for k in sd)
    assert n_d == 4 * 2 + 3 * 5 + 2
    assert f"(skipped 0, missing {n_d})" in capsys.readouterr().out
    for k, v in src.state_dict().items():
        assert torch.equal(sd[k], v), k
    assert len(result.optimizers) == 3


@pytest.fixture(scope="module")
def gan_runs(corpus, tmp_path_factory):
    """Both packages' train_gan commands from one exported initialisation,
    dropout off: {"init": state dict, "saved": {side: {epoch: state
    dict}}, "logs": (jax, port) metrics records, "port_ckpt": path}."""
    import jax
    import jax.numpy as jnp

    from dmcnet_tpu.cli import train as jax_train_cli
    from dmcnet_tpu.cli import train_gan as jax_train_gan
    from dmcnet_tpu.models import DMCNet as FlaxDMCNet
    from dmcnet_tpu.models import export_torch
    from dmcnet_tpu_torch.cli import train as train_cli
    from dmcnet_tpu_torch.cli import train_gan

    tmp = tmp_path_factory.mktemp("gan_runs")
    fmodel = FlaxDMCNet(num_class=51, num_segments=2,
                        arch_estimator="DenseNetTiny", gen_flow_or_delta=1,
                        arch_d="Discriminator", detach_classifier=False)
    shapes = jax.eval_shape(
        lambda: fmodel.init(jax.random.key(3),
                            jnp.zeros((1, 1, SIZE, SIZE, 2)),
                            jnp.zeros((1, 1, SIZE, SIZE, 3)),
                            jnp.zeros((1, 1, SIZE, SIZE, 2)), train=False))
    rng = np.random.default_rng(3)
    variables = {c: jax.tree_util.tree_map_with_path(
        lambda p, x: _draw(p, x.shape, rng).astype(np.float32), shapes[c])
        for c in ("params", "batch_stats")}
    init = str(tmp / "init.pth.tar")
    export_torch.save_reference_checkpoint(
        types.SimpleNamespace(**variables), init)
    init_sd = torch.load(init, map_location="cpu",
                         weights_only=True)["state_dict"]

    saved = {"jax": {}, "port": {}}
    save_ref = export_torch.save_reference_checkpoint
    save_port = train_cli.save_checkpoint
    build_port = train_cli.build_model

    def jax_save(state, path, epoch=0, **kw):
        save_ref(state, path, epoch=epoch, **kw)
        saved["jax"][epoch] = torch.load(path, map_location="cpu",
                                         weights_only=True)["state_dict"]

    def port_save(model, meta, filename, *a, **kw):
        saved["port"][meta["epoch"]] = {
            k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
        return save_port(model, meta, filename, *a, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(export_torch, "save_reference_checkpoint", jax_save)
        mp.setattr(train_cli, "save_checkpoint", port_save)
        mp.setattr(train_cli, "build_model",
                   lambda *a, **kw: dropout_off(build_port(*a, **kw)))
        mp.setattr(jax_train_cli, "SAVE_FREQ", 1)
        mp.setattr(train_cli, "SAVE_FREQ", 1)
        zero_flax_init(mp, FlaxDMCNet)
        jax_prefix = str(tmp / "jax")
        with jax_dropout_off():
            jax_train_gan.main(_train_args(corpus, jax_prefix) + GAN_FLAGS + [
                "--weights", init, "--save-reference-ckpt", "1",
                "--metrics-jsonl", jax_prefix + ".jsonl"], input_size=SIZE)
        port_prefix = str(tmp / "port")
        train_gan.main(_train_args(corpus, port_prefix) + GAN_FLAGS + [
            "--weights", init, "--device", "cpu",
            "--metrics-jsonl", port_prefix + ".jsonl"], input_size=SIZE)
    logs = []
    for prefix in (jax_prefix, port_prefix):
        with open(prefix + ".jsonl") as f:
            logs.append([json.loads(line) for line in f])
    return {"init": init_sd, "saved": saved, "logs": logs,
            "port_ckpt": port_prefix + "_mv_checkpoint.pth.tar"}


def _part(key):
    return next(p for prefix, p in PARTS if key.startswith(prefix))


def _check_phases(sd, init_sd, side):
    """The freeze on one side's per-epoch state dicts: in epoch 1 the
    classifier bit-unchanged while the generator and the discriminator
    move; in epoch 2 every tensor moves."""
    for k, before in init_sd.items():
        if _is_buffer(k):
            continue
        e1, e2 = sd[1][k], sd[2][k]
        if _part(k) == "cls":
            assert torch.equal(e1, before), f"{side}: frozen {k} moved"
        else:
            assert not torch.equal(e1, before), f"{side}: {k} still in epoch 1"
        assert not torch.equal(e2, e1), f"{side}: {k} still in epoch 2"


def test_train_gan_clis_match_jax(gan_runs):
    """Both train_gan commands: the same records in their metrics logs
    (losses, accuracies, loss_adv), the freeze on both sides, each tensor's
    update against the JAX update, and the BN running statistics."""
    init_sd, saved, logs = gan_runs["init"], gan_runs["saved"], \
        gan_runs["logs"]
    assert [r["kind"] for r in logs[0]] == [r["kind"] for r in logs[1]] \
        == ["train", "eval"] * 2
    for want_rec, got_rec in zip(*logs):
        for k in ("loss", "loss_adv", "top1", "top5", "prec1"):
            if k in want_rec:
                np.testing.assert_allclose(got_rec[k], want_rec[k],
                                           rtol=LOSS_RTOL, err_msg=k)

    assert sorted(saved["jax"]) == sorted(saved["port"]) == [1, 2]
    for side in ("jax", "port"):
        _check_phases(saved[side], init_sd, side)
    rel = {"gen": {}, "cls": {}, "d": {}}
    for epoch in (1, 2):
        want, got = saved["jax"][epoch], saved["port"][epoch]
        for k, v in want.items():
            d_jax = v - init_sd[k]
            if not _is_buffer(k) and d_jax.any():
                rel[_part(k)][epoch, k] = float(
                    (got[k] - init_sd[k] - d_jax).norm() / d_jax.norm())
    readings = {}
    for part, (worst_tol, median_tol) in UPDATE_RTOL.items():
        worst = max(rel[part], key=rel[part].get)
        median = float(np.median(list(rel[part].values())))
        readings[part] = (worst, rel[part][worst], median)
        assert rel[part][worst] <= worst_tol, (part, worst, rel[part][worst])
        assert median <= median_tol, (part, median)
    print("update readings (tensor, worst, median):", readings)

    for k, v in saved["jax"][2].items():
        if not _is_buffer(k) or k.endswith("num_batches_tracked"):
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


def test_test_clis_g_adversarial_accuracy_match_jax(gan_runs, corpus,
                                                    tmp_path, capsys):
    """Both test commands with --arch_d on one GAN checkpoint: the same G
    adversarial accuracy over 4 videos x 3 segments x 10 crops, and the same
    scores.  The trained discriminator rates every cue real (100%), which
    no fault upstream of the argmax could change; the checkpoint scored is
    therefore the port's, with the adv_layer's "real" bias lowered to the
    midpoint of the widest gap among the middle half of the rows' logit
    margins, so that 25-75% of the rows read real and no row lies near the
    boundary."""
    from dmcnet_tpu.cli import test as jax_test_cli
    from dmcnet_tpu.models import DMCNet as FlaxDMCNet
    from dmcnet_tpu_torch.cli import test as test_cli
    from dmcnet_tpu_torch.models import discriminators as tdisc

    margins = []
    forward = tdisc._Discriminator.forward

    def recording(self, x):
        out = forward(self, x)
        margins.append((out[:, 1] - out[:, 0]).detach())
        return out

    port_args = lambda w, s: _test_args(corpus, w, s) + [  # noqa: E731
        "--arch_d", "Discriminator", "--device", "cpu"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tdisc._Discriminator, "forward", recording)
        test_cli.main(port_args(gan_runs["port_ckpt"],
                                str(tmp_path / "trained")))
    assert _g_adv(capsys.readouterr().out) == 100.0
    m = torch.cat(margins).sort().values
    lo, hi = len(m) // 4, 3 * len(m) // 4
    j = lo + int((m[lo + 1:hi + 1] - m[lo:hi]).argmax())
    cut, gap = float(m[j] + m[j + 1]) / 2, float(m[j + 1] - m[j])
    assert gap > 1e-3, gap  # far above the packages' logit differences
    payload = torch.load(gan_runs["port_ckpt"], map_location="cpu",
                         weights_only=True)
    payload["state_dict"]["discriminator.adv_layer.bias"][1] -= cut
    ckpt = str(tmp_path / "balanced.pth.tar")
    torch.save(payload, ckpt)

    with pytest.MonkeyPatch.context() as mp:
        zero_flax_init(mp, FlaxDMCNet)
        jax_test_cli.main(_test_args(corpus, ckpt, str(tmp_path / "jax"))
                          + ["--arch_d", "Discriminator"])
    want = _g_adv(capsys.readouterr().out)
    test_cli.main(port_args(ckpt, str(tmp_path / "port")))
    got = _g_adv(capsys.readouterr().out)
    print(f"G adversarial accuracy {got}% (JAX {want}%), cut {cut:.4g}, "
          f"gap {gap:.3g}")
    assert got == want and 25.0 <= got <= 75.0, (got, want)
    s_jax, l_jax, n_jax = _scores(str(tmp_path / "jax.npz"))
    s_port, l_port, n_port = _scores(str(tmp_path / "port.npz"))
    assert (l_port, n_port) == (l_jax, n_jax)
    np.testing.assert_allclose(s_port, s_jax, rtol=SCORE_RTOL,
                               atol=SCORE_ATOL)


@pytest.mark.parametrize("representation", ["flow", "mv"])
def test_plain_scores_match_jax(corpus, tmp_path, representation):
    """test --plain 1 on a 2-channel CoViAR-style TSN checkpoint: the flow
    and mv slots hold 2 channels, and both commands score alike."""
    from dmcnet_tpu.cli import test as jax_test_cli
    from dmcnet_tpu.models import PlainTSN as FlaxPlainTSN
    from dmcnet_tpu_torch.cli import test as test_cli
    from dmcnet_tpu_torch.models.tsn import PlainTSN

    torch.manual_seed(2)
    weights = str(tmp_path / "plain.pth.tar")
    torch.save({"epoch": 1, "arch": "resnet18", "best_prec1": 0.0,
                "state_dict": PlainTSN(51, in_channels=2).state_dict()},
               weights)
    args = {side: _test_args(corpus, weights, str(tmp_path / side),
                             representation) + ["--plain", "1"]
            for side in ("jax", "port")}
    with pytest.MonkeyPatch.context() as mp:
        zero_flax_init(mp, FlaxPlainTSN)
        jax_test_cli.main(args["jax"])
    test_cli.main(args["port"] + ["--device", "cpu"])
    s_jax, l_jax, n_jax = _scores(str(tmp_path / "jax.npz"))
    s_port, l_port, n_port = _scores(str(tmp_path / "port.npz"))
    assert (l_port, n_port) == (l_jax, n_jax)
    assert np.ptp(s_port[:, 0], axis=0).max() > 1e-3  # the videos differ
    np.testing.assert_allclose(s_port, s_jax, rtol=SCORE_RTOL,
                               atol=SCORE_ATOL)
