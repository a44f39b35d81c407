"""The port's I3D training command (`cli.train_i3d` and its aliases) on the
CPU against the JAX package's, on a small corpus with real flow JPEGs.

The corpus has tests/test_torch_i3d_cli.py's layout (24-frame 64x80 MPEG-4
videos, GOP 12, under videos/cls/, lists `id label subpath` under
raw/list_cvt/) with 8 training and 2 test videos whose frames pan across
random 8x8 blocks (pixel noise encodes as I-frames, whose MV and residual
are zero), and TV-L1-style flow JPEGs `flow_{x,y}_%05d.jpg` that pan across
blocks of their own: without them a clip's flow reads as a constant 128,
and the generator's MSE and the discriminator would see a constant target.

CLI against CLI: both commands start from one set of variables at flax's
shapes drawn with numpy (tests/test_torch_i3d.py `draw_variables`), written
as a reference-layout `.pth` and passed as `--pretrained_3d`; the JAX
command's eager flax init (over a minute here) is replaced by zeros of its
shapes, which the file then overwrites.  The flags are examples/i3d/train.sh
cut to size: Adam, DenseNetTiny, `--arch-d Discriminator --adv 1
--detach 1 --fine_tune 0`, `--epoch-thre 1` so that the second epoch runs
after the stage-2 swap, `--batch-size 2 --iter-size 2 --clip-length 8` and
two macro steps an epoch (a D and a G), `--workers 1` so that both data
layers draw one stream of frames and crops.  The port draws the JAX
command's init clip too, and 2 test videos fill whole validation batches
(the JAX command pads a ragged one with extra draws), so both commands see
the same clips.  Dropout is off on both sides (tests/test_torch_gan.py
`dropout_off`, `jax_dropout_off`, and `--drop-out 0`); the JAX dataset reads
the reference's GOP positions (tests/test_torch_i3d_data.py
`fix_jax_gop_positions`).

Tolerances (float32): the metrics logs' losses at rtol 1e-4; the epochs'
eval top-1 equal; parameters held by their updates d = state - init, per
tensor, |d_port - d_jax| / |d_jax| (tests/test_torch_cli.py), limits in
UPDATE_RTOL set from readings on a CPU; BN running statistics as in
tests/test_torch_gan_cli.py.
"""

import json
import os

import numpy as np
import pytest
import torch
from PIL import Image
from test_torch_cli import _is_buffer
from test_torch_gan import dropout_off, jax_dropout_off
from test_torch_i3d_data import fix_jax_gop_positions, panning_canvas
from test_torch_train import _draw, _two_torch_threads  # noqa: F401

from dmcnet_tpu_torch.cli import evaluate_video_i3d as eval_cli
from dmcnet_tpu_torch.cli import train_hmdb51, train_i3d, train_ucf101
from dmcnet_tpu_torch.codec.mpeg4 import encode_mpeg4
from dmcnet_tpu_torch.data.iterator_factory import creat

T_FRAMES, H, W, N_TRAIN, N_TEST = 24, 64, 80, 8, 2
SIZE, CLIP = 64, 8
LOSS_RTOL, LATER_LOSS_RTOL, SCORE_RTOL = 1e-4, 0.05, 1e-3
PARAM_RTOL, PARAM_ATOL = 5e-4, 5e-6
# |d_port - d_jax| / |d_jax| per tensor, (worst, median), by (epoch, part).
# Measured on a CPU: epoch 1 discriminator 3.3e-5 / 7.5e-6, generator
# 0.19 / 1.2e-5 (a few tensors whose smallest gradients sit at float32's
# noise; Adam's eps 1e-8 turns each into a step of +-lr), epoch 2
# discriminator 4.8e-3 / 1.1e-3.
UPDATE_RTOL = {(1, "d"): (3e-4, 5e-5), (1, "gen"): (0.5, 1e-4),
               (2, "d"): (0.03, 5e-3)}
# |d_port| / |d_jax| per tensor within 1 +- NORM_RATIO_TOL.  Measured: epoch
# 1 within 1.2e-5 of 1, the classifier's stage-2 updates within 3.3e-3.
NORM_RATIO_KEYS = ((1, "d"), (1, "gen"), (2, "d"), (2, "cls"))
NORM_RATIO_TOL = 0.02
FLAGS = ["--dataset", "HMDB51", "--split", "1", "--network", "I3D",
         "--modality", "flow+mp4", "--arch-estimator", "DenseNetTiny",
         "--arch-d", "Discriminator", "--adv", "1", "--optimizer", "adam",
         "--drop-out", "0", "--detach", "1", "--fine_tune", "0",
         "--epoch-thre", "1", "--end-epoch", "2", "--batch-size", "2",
         "--iter-size", "2", "--clip-length", str(CLIP),
         "--train-frame-interval", "1", "--val-frame-interval", "1",
         "--lr-base", "1e-3", "--lr-base2", "5e-4", "--lr-d", "2e-3",
         "--lr-factor", "0.2", "--ds_factor", "16", "--mv-minmaxnorm", "1",
         "--accumulate", "0", "--workers", "1", "--save-frequency", "1"]
PARTS = (("gen_flow_model.", "gen"), ("discriminator.", "d"))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("i3d_train")
    os.makedirs(root / "raw" / "list_cvt")
    os.makedirs(root / "videos" / "cls")
    rng = np.random.default_rng(21)
    lines = []
    for v in range(N_TRAIN + N_TEST):
        canvas = panning_canvas(rng, H + T_FRAMES, W + 3 * T_FRAMES)
        step = v % 3 + 1
        encode_mpeg4(root / "videos" / "cls" / f"v{v}.mp4",
                     np.stack([canvas[i:i + H, step * i:step * i + W]
                               for i in range(T_FRAMES)]),
                     gop_size=12, bit_rate=1_000_000)
        flow_dir = root / "flow" / "cls" / f"v{v}"
        os.makedirs(flow_dir)
        field = panning_canvas(rng, H + T_FRAMES, W + T_FRAMES)
        for i in range(T_FRAMES):
            for axis, ch in (("x", 0), ("y", 1)):
                Image.fromarray(field[i:i + H, i:i + W, ch]).save(
                    flow_dir / f"flow_{axis}_{i + 1:05d}.jpg")
        lines.append(f"{v} {v % 3} cls/v{v}.mp4")
    lists = root / "raw" / "list_cvt"
    (lists / "hmdb51_split1_train.txt").write_text(
        "\n".join(lines[:N_TRAIN]) + "\n")
    (lists / "hmdb51_split1_test.txt").write_text(
        "\n".join(lines[N_TRAIN:]) + "\n")
    return root


def _data_flags(corpus):
    return ["--data-root", str(corpus), "--video-prefix",
            str(corpus / "videos"), "--flow-prefix", str(corpus / "flow")]


def _port_build(real):
    def build(*a, **kw):
        net, conf = real(*a, **kw)
        return dropout_off(net), conf
    return build


@pytest.fixture(scope="module")
def runs(corpus, tmp_path_factory):
    """Both train_i3d commands from one exported initialisation: {"init":
    state dict, "saved": {side: {epoch: state dict}}, "logs": (jax, port)
    metrics records, "scores": (jax, port) score_best.npz contents, "dir":
    the port's model dir}."""
    import jax
    import jax.numpy as jnp

    from dmcnet_tpu.cli import train_i3d as jax_cli
    from dmcnet_tpu.data import video_iter as jax_video_iter
    from dmcnet_tpu.models.i3d import get_symbol, init_i3d_variables
    from dmcnet_tpu_torch.models.weights import state_dict_from_flax

    tmp = tmp_path_factory.mktemp("i3d_runs")
    net, _ = get_symbol("I3D", modality="flow+mp4", num_classes=51,
                        arch_estimator="DenseNetTiny", arch_d="Discriminator")
    shapes = jax.eval_shape(lambda: init_i3d_variables(
        net, jax.random.key(0), jnp.zeros((1, CLIP, SIZE, SIZE, 5))))
    rng = np.random.default_rng(4)
    v = {c: jax.tree_util.tree_map_with_path(
        lambda p, x: _draw(p, x.shape, rng).astype(np.float32), shapes[c])
        for c in ("params", "batch_stats")}
    init_sd = state_dict_from_flax(v["params"], v["batch_stats"])
    init = str(tmp / "init.pth")
    torch.save({"state_dict": init_sd}, init)

    saved = {"jax": {}}

    def jax_save(state, meta, path):
        saved["jax"][meta["epoch"]] = state_dict_from_flax(
            jax.tree.map(np.asarray, state.params),
            jax.tree.map(np.asarray, state.batch_stats))

    init_fn = jax_cli.init_i3d_variables
    logs, scores = [], []
    with pytest.MonkeyPatch.context() as mp:
        fix_jax_gop_positions(mp, jax_video_iter)
        mp.setattr(jax_cli, "init_i3d_variables", lambda *a: jax.tree.map(
            lambda s: jnp.zeros(s.shape, s.dtype),
            jax.eval_shape(lambda: init_fn(*a))))
        mp.setattr(jax_cli, "save_checkpoint", jax_save)
        mp.setattr(train_i3d, "build_model",
                   _port_build(train_i3d.build_model))
        for side in ("jax", "port"):
            os.makedirs(tmp / side)
            mp.chdir(tmp / side)
            argv = FLAGS + _data_flags(corpus) + [
                "--pretrained_3d", init, "--model-dir", str(tmp / side),
                "--task-name", "hmdb_1",
                "--metrics-jsonl", str(tmp / side / "metrics.jsonl")]
            if side == "jax":
                with jax_dropout_off():
                    jax_cli.main(argv, input_size=SIZE)
            else:
                train_hmdb51.main(argv + ["--device", "cpu"],
                                  input_size=SIZE)
            with open(tmp / side / "metrics.jsonl") as f:
                logs.append([json.loads(line) for line in f])
            with np.load(tmp / side / "exps" / "score" / "HMDB51_1" /
                         "hmdb_1" / "score_best.npz") as z:
                scores.append({k: z[k] for k in z.files})
    saved["port"] = {
        e: torch.load(tmp / "port" / f"hmdb_1_ep-{e:04d}.pth",
                      weights_only=True)["state_dict"] for e in (1, 2)}
    return {"init": init_sd, "saved": saved, "logs": logs, "scores": scores,
            "dir": tmp / "port"}


def _part(key):
    return next((p for prefix, p in PARTS if key.startswith(prefix)), "cls")


def test_train_i3d_clis_match_jax(runs):
    """Both commands across the stage-2 swap: the same first-epoch records
    in their metrics logs and the same eval top-1 each epoch, the same best
    scores file; in epoch 1 (stage 1 under --detach) the classifier
    bit-unchanged on both sides while the generator and the discriminator
    move, and in epoch 2 every tensor moves; per tensor, the updates of the
    discriminator (both epochs) and the generator (epoch 1) against the JAX
    update, and the norms of the classifier's stage-2 updates; BN running
    statistics after epoch 1."""
    init_sd, saved, logs = runs["init"], runs["saved"], runs["logs"]
    assert [r["kind"] for r in logs[0]] == [r["kind"] for r in logs[1]] \
        == ["train", "eval"] * 2
    for want_rec, got_rec in zip(*logs):
        keys = set(want_rec) - {"kind", "wall_s", "speed", "epoch_s"}
        assert keys <= set(got_rec) and keys >= {"epoch", "top1"}
        rtol = LOSS_RTOL if want_rec["epoch"] == 0 else LATER_LOSS_RTOL
        for k in keys:
            np.testing.assert_allclose(got_rec[k], want_rec[k], rtol=rtol,
                                       err_msg=f"{want_rec['kind']} {k}")
    want_s, got_s = runs["scores"]
    assert sorted(got_s) == sorted(want_s) == ["labels", "scores", "top1"]
    assert got_s["scores"].shape == (N_TEST, 51)
    np.testing.assert_array_equal(got_s["labels"], want_s["labels"])
    assert float(got_s["top1"]) == float(want_s["top1"])
    np.testing.assert_allclose(got_s["scores"], want_s["scores"],
                               rtol=SCORE_RTOL)

    assert sorted(saved["jax"]) == sorted(saved["port"]) == [1, 2]
    for side in ("jax", "port"):
        for k, before in init_sd.items():
            if _is_buffer(k):
                continue
            e1, e2 = saved[side][1][k], saved[side][2][k]
            if _part(k) == "cls":
                assert torch.equal(e1, before), f"{side}: frozen {k} moved"
            else:
                assert not torch.equal(e1, before), f"{side}: {k} still"
            assert not torch.equal(e2, e1), f"{side}: {k} still in epoch 2"
    rel, ratio = {}, {}
    for epoch in (1, 2):
        want, got = saved["jax"][epoch], saved["port"][epoch]
        for k, v in want.items():
            d_jax, d_port = v - init_sd[k], got[k] - init_sd[k]
            if not _is_buffer(k) and d_jax.any():
                key = (epoch, _part(k))
                rel.setdefault(key, {})[k] = float(
                    (d_port - d_jax).norm() / d_jax.norm())
                ratio.setdefault(key, {})[k] = float(
                    d_port.norm() / d_jax.norm())
    readings = {}
    for key, (worst_tol, median_tol) in UPDATE_RTOL.items():
        worst = max(rel[key], key=rel[key].get)
        median = float(np.median(list(rel[key].values())))
        readings[key] = (worst, rel[key][worst], median)
        assert rel[key][worst] <= worst_tol, (key, worst, rel[key][worst])
        assert median <= median_tol, (key, median)
    for key in NORM_RATIO_KEYS:
        worst = max(ratio[key], key=lambda k: abs(ratio[key][k] - 1))
        readings[key, "norm ratio"] = (worst, ratio[key][worst])
        assert abs(ratio[key][worst] - 1) <= NORM_RATIO_TOL, \
            (key, worst, ratio[key][worst])
    print("update readings (tensor, worst, median):", readings)

    for k, v in saved["jax"][1].items():
        if not _is_buffer(k) or k.endswith("num_batches_tracked"):
            continue
        got = saved["port"][1][k]
        if k.endswith("running_mean"):
            std = saved["jax"][1][k[:-len("mean")] + "var"].sqrt()
            diff = (got - v).abs()
            assert bool((diff <= PARAM_RTOL * std).all()), \
                (k, float((diff / std).max()))
        else:
            np.testing.assert_allclose(got.numpy(), v.numpy(),
                                       rtol=PARAM_RTOL, atol=PARAM_ATOL,
                                       err_msg=k)


def test_evaluate_reads_the_checkpoint(runs, corpus, tmp_path):
    """`evaluate_video_i3d --load-weights` scores the port's last
    checkpoint: every key of the model filled, finite scores."""
    scores = str(tmp_path / "eval")
    top1 = eval_cli.main([
        "--dataset", "HMDB51", "--modality", "flow+mp4",
        "--arch-estimator", "DenseNetTiny", "--mv-minmaxnorm", "1",
        "--accumulate", "0", "--ds_factor", "16", "--clip-length",
        str(CLIP), "--input-size", str(SIZE), "--batch-size", "2",
        "--load-weights", str(runs["dir"] / "hmdb_1_ep-0002.pth"),
        "--score-file", scores, "--device", "cpu"] + _data_flags(corpus))
    with np.load(scores + ".npz") as z:
        assert z["scores"].shape == (N_TEST, 51)
        assert np.isfinite(z["scores"]).all()
        assert float(z["top1"]) == top1


def _train_args(corpus, model_dir, extra):
    return train_i3d.autofill(train_i3d.build_parser().parse_args(
        FLAGS + _data_flags(corpus) + ["--model-dir", str(model_dir),
                                       "--task-name", "hmdb_1",
                                       "--device", "cpu"] + extra))


def _datasets(args):
    return creat(args.dataset, args.data_root, args.video_prefix,
                 args.flow_prefix, split=args.split,
                 clip_length=args.clip_length,
                 train_interval=args.train_frame_interval,
                 val_interval=args.val_frame_interval,
                 modality=args.modality, accumulate=bool(args.accumulate),
                 mv_minmaxnorm=bool(args.mv_minmaxnorm),
                 seed=args.random_seed)


@pytest.mark.parametrize("resume,stage2_state", [
    (["--resume-epoch", "1", "--end-epoch", "1"], False),
    (["--resume-epoch", "2", "--end-epoch", "2"], True),
    (["--auto-resume", "1", "--end-epoch", "2"], True)],
    ids=["at-epoch-thre", "after", "auto"])
def test_resume_epoch_across_epoch_thre(runs, corpus, tmp_path, monkeypatch,
                                        resume, stage2_state):
    """`--resume-epoch` / `--auto-resume` from the port's own run: the
    stage-2 optimizers are built before the load; a file of the epoch at
    `--epoch-thre` (stage 1) leaves the classifier's and the generator's
    optimizers fresh, as the swap does, and restores the discriminator's
    and the carried gradients; a later file restores all three."""
    monkeypatch.chdir(tmp_path)
    args = _train_args(corpus, runs["dir"], resume)
    result = train_i3d.train(args, *_datasets(args), device="cpu",
                             input_size=SIZE)
    epoch = args.resume_epoch
    assert epoch == (2 if resume[0] == "--auto-resume" else int(resume[1]))
    payload = torch.load(runs["dir"] / f"hmdb_1_ep-{epoch:04d}.pth",
                         weights_only=True)
    assert payload["stage2"] == stage2_state
    opts = result.optimizers
    assert opts["gf"].param_groups[0]["eps"] == 1e-3
    assert {g["lr_mult"] for g in opts["cls"].param_groups} == {1.0}
    for key in ("cls", "gf", "d"):
        state = opts[key].state_dict()["state"]
        if key != "d" and not stage2_state:
            assert state == {}, key
        else:
            want = payload[f"optimizer_{key}"]["state"]
            assert state.keys() == want.keys() and state, key
            assert all(torch.equal(v, want[i][s]) for i, st in state.items()
                       for s, v in st.items()), key
    for k, p in result.model.named_parameters():
        want = payload["grad"].get(k)
        assert (p.grad is None if want is None
                else torch.equal(p.grad, want)), k
    assert any(p.grad is not None and p.grad.any()
               for p in result.model.parameters())
    assert result.epochs == []


def test_aliases_and_refusals(corpus, monkeypatch, capsys, tmp_path):
    """train_hmdb51 and train_ucf101 set the dataset default; the
    parallel flags stop on one process where the JAX command does, and
    `--fsdp` and the directory checkpoint backend reach the loop; the TPU workarounds
    parse and say they change nothing, while `--packed-gen` reaches the
    model; a missing --pretrained_3d raises; without CUDA the default
    device raises."""
    got = {}
    monkeypatch.setattr(train_i3d, "train", lambda args, *a, **kw: got.update(
        dataset=args.dataset, backend=args.ckpt_backend,
        packed=args.packed_gen) or type("R", (), {"best_top1": 1.0})())
    monkeypatch.setattr(train_i3d, "creat", lambda *a, **kw: (None, None))
    base = FLAGS[2:] + _data_flags(corpus) + ["--device", "cpu"]
    train_ucf101.main(base)
    assert got["dataset"] == "UCF101"
    train_hmdb51.main(base + ["--accum-chunk", "4", "--remat", "1",
                              "--packed-gen", "2"])
    assert got["dataset"] == "HMDB51" and got["packed"] == 2
    out = capsys.readouterr().out
    for flag in ("--accum-chunk", "--remat"):
        assert f"{flag}: a TPU workaround" in out, flag
    assert "--packed-gen:" not in out
    args = train_i3d.build_parser().parse_args(FLAGS[2:] + ["--packed-gen",
                                                            "2"])
    net, _ = train_i3d.build_model(args, 5, 32)
    assert net.gen_flow_model.packed == 2
    args = _train_args(corpus, tmp_path, [
        "--pretrained_3d", str(tmp_path / "missing.pth")])
    with pytest.raises(SystemExit, match="missing.pth does not exist"):
        train_i3d.init_pretrained(args, None)
    # the parallel flags are ported (tests/test_torch_i3d_parallel.py runs
    # them): on one process --tp 2 and a coordinator without a process
    # count stop with the JAX command's errors, --fsdp reaches the loop
    with pytest.raises(SystemExit, match="--tp 2 must divide the number of "
                       "processes"):
        train_i3d.main(base + ["--tp", "2"])
    with pytest.raises(ValueError, match="without --dist-num-processes"):
        train_i3d.main(base + ["--dist-coordinator", "h:1"])
    with pytest.raises(SystemExit, match="--fsdp across processes"):
        train_i3d.main(base + ["--gpus", "0,1", "--fsdp", "1"])
    train_i3d.main(base + ["--fsdp", "1"])
    train_i3d.main(base + ["--ckpt-backend", "orbax"])  # ported: no refusal
    assert got["backend"] == "orbax"
    for extra, match in ((["--modality", "rgb"], "flow\\+mp4"),
                         (["--arch-d", ""], "needs a discriminator")):
        with pytest.raises(SystemExit, match=match):
            train_i3d.main(base + extra)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_i3d.main(FLAGS[2:] + _data_flags(corpus))
