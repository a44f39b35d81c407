"""The port's directory checkpoints (`--ckpt-backend orbax | orbax-async`,
`train/checkpoints.save_checkpoint_dcp` on torch.distributed.checkpoint) on
the CPU: round trip, `keep` pruning, background saves, torn steps, resumed
training runs of `cli.train` and `cli.train_i3d`, and the scorers reading a
directory.

A resumed run is held against an uninterrupted one bit for bit.  The data
layers draw crops and frames from counters that start again in a new
process (in the JAX package too), so these runs draw them from each
batch's first index instead (`index_seeded`); the model, BN and optimizer
state, the step counters and, for I3D, the carried gradients all come from
the checkpoint.  The discriminator's dropout is off
(tests/test_torch_gan.py `dropout_off`): its random generator is not
checkpointed either.
"""

import itertools
import os
import pickle

import numpy as np
import pytest
import torch
from PIL import Image
from test_torch_i3d_train_cli import _data_flags as i3d_data_flags
from test_torch_i3d_train_cli import _port_build
from test_torch_i3d_train_cli import FLAGS as I3D_FLAGS
from test_torch_i3d_train_cli import corpus as i3d_corpus  # noqa: F401
from test_torch_train import _two_torch_threads  # noqa: F401 (autouse)

from dmcnet_tpu_torch.codec.mpeg4 import encode_mpeg4
from dmcnet_tpu_torch.models.tsn import DMCNet
from dmcnet_tpu_torch.train import checkpoints as tckpt
from dmcnet_tpu_torch.train import engine as tengine
from dmcnet_tpu_torch.train import optimizers as topt

NUM_CLASS, S, SIZE = 5, 2, 32
NVID, T, H, W = 4, 24, 48, 64
I3D_SIZE = 64


def _model(seed=0):
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return DMCNet(NUM_CLASS, num_segments=S,
                      arch_estimator="DenseNetTiny", gen_flow_or_delta=1)


def _batch(seed=0, b=2):
    rng = np.random.default_rng(seed)
    out = {k: torch.from_numpy(rng.normal(size=(b, S, c, SIZE, SIZE))
                               .astype(np.float32))
           for k, c in (("mv", 2), ("residual", 3), ("flow", 2))}
    out["label"] = torch.from_numpy(rng.integers(0, NUM_CLASS, b))
    return out


def _trained(seed=0):
    """A model and its two Adams after one step, so each holds state."""
    model = _model(seed)
    opts = topt.make_optimizers(model, 0.5, 1.0)
    topt.adjust_learning_rate(opts, 1e-3, 0.05)
    step = tengine.make_train_step(model, *opts, num_segments=S,
                                   lr_cls_w=1.0, lr_mse_w=1.0)
    step(_batch(seed), True)
    return model, opts, step


def _named(opts):
    return dict(zip(("optimizer_cls", "optimizer_gf"), opts))


def _assert_equal_states(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def _opt_states(model, opt):
    names = {id(p): n for n, p in model.named_parameters()}
    return {names[id(p)]: s for p, s in opt.state.items()}


def test_round_trip(tmp_path):
    """Model, BN buffers and both optimizers come back bit-equal, and the
    next step from the copy equals the next step from the original."""
    model, opts, step = _trained()
    directory = str(tmp_path / "m.orbax")
    meta = {"epoch": 3, "arch": "resnet18", "best_prec1": 12.5}
    assert tckpt.save_checkpoint_dcp(model, meta, directory,
                                     _named(opts)) == directory
    assert sorted(os.listdir(directory)) == ["3"]
    assert tckpt.checkpoint_format(directory) == "dcp"

    copy, copy_opts, copy_step = _trained(seed=1)   # other values
    assert tckpt.load_checkpoint(directory, copy, copy_opts) == meta
    _assert_equal_states(copy.state_dict(), model.state_dict())
    for a, b in zip(opts, copy_opts):
        want, got = _opt_states(model, a), _opt_states(copy, b)
        assert want.keys() == got.keys() and want
        for name, entry in want.items():
            for k, v in entry.items():
                assert torch.equal(got[name][k], v), (name, k)
    saved = {k: v.clone() for k, v in model.state_dict().items()}
    step(_batch(5), True)
    copy_step(_batch(5), True)
    _assert_equal_states(copy.state_dict(), model.state_dict())
    _assert_equal_states(tckpt.read_model_state(directory), saved)


def _torn(directory, step):
    """A step a crash cut short: meta.pkl written, DCP's commit not."""
    os.makedirs(os.path.join(directory, str(step), "state"))
    with open(os.path.join(directory, str(step), "meta.pkl"), "wb") as f:
        pickle.dump({"epoch": step}, f)


def test_keep_prunes_committed_steps(tmp_path):
    """keep=2: each save keeps the newest committed step and adds its own;
    a torn step is neither read nor counted, and a save of its number
    replaces it."""
    model, opts, _ = _trained()
    directory = str(tmp_path / "m.orbax")
    for epoch in (1, 2, 3, 4):
        tckpt.save_checkpoint_dcp(model, {"epoch": epoch}, directory,
                                  _named(opts))
    assert sorted(os.listdir(directory)) == ["3", "4"]
    _torn(directory, 5)
    assert tckpt._committed_steps(directory) == [3, 4]
    assert tckpt.load_checkpoint(directory, _model())["epoch"] == 4
    tckpt.save_checkpoint_dcp(model, {"epoch": 6}, directory)
    assert sorted(os.listdir(directory)) == ["4", "5", "6"]
    tckpt.save_checkpoint_dcp(model, {"epoch": 5}, directory)
    assert tckpt._committed_steps(directory) == [5, 6]
    assert not tckpt.dcp_checkpoint_committed(str(tmp_path / "none"))


def test_async_save_then_wait(tmp_path):
    """orbax-async: the call returns once the state is copied to the host,
    so a step taken right after does not reach the file; the step commits
    by `wait_for_checkpoints`."""
    model, opts, step = _trained()
    want = {k: v.clone() for k, v in model.state_dict().items()}
    directory = str(tmp_path / "m.orbax")
    tckpt.save_checkpoint_dcp(model, {"epoch": 1}, directory, _named(opts),
                              wait=False)
    step(_batch(7), True)
    tckpt.wait_for_checkpoints()
    assert tckpt._committed_steps(directory) == [1]
    _assert_equal_states(tckpt.read_model_state(directory), want)
    assert not tckpt._PENDING


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """4 panning MPEG-4 videos with flow JPEGs, tests/test_torch_cli.py's
    layout."""
    root = tmp_path_factory.mktemp("dcp_corpus")
    rng = np.random.default_rng(5)
    lines = []
    for v in range(NVID):
        os.makedirs(root / "videos" / "cls", exist_ok=True)
        canvas = rng.integers(0, 256, size=(H // 8 + T, W // 8 + T, 3))
        canvas = np.repeat(np.repeat(canvas, 8, 0), 8, 1).astype(np.uint8)
        encode_mpeg4(str(root / "videos" / "cls" / f"v{v}.mp4"),
                     np.stack([canvas[i:i + H, i:i + W] for i in range(T)]),
                     gop_size=12, bit_rate=1_000_000)
        fdir = root / "flow" / "cls" / f"v{v}"
        os.makedirs(fdir)
        for i in range(1, T + 1):
            for ax in "xy":
                Image.fromarray(rng.integers(0, 256, size=(H, W),
                                             dtype=np.uint8), mode="L").save(
                    fdir / f"flow_{ax}_{i:05d}.jpg")
        lines.append(f"cls/v{v}.avi 0 {v % 2}")
    (root / "list.txt").write_text("\n".join(lines) + "\n")
    return root


def common_argv(corpus):
    """The flags `cli.train` and `cli.test` share (examples/
    hmdb51_gen_flow/run.sh's)."""
    return ["--data-name", "hmdb51", "--data-root", str(corpus / "videos"),
            "--flow-root", str(corpus / "flow"), "--representation", "mv",
            "--arch", "resnet18", "--arch_estimator", "DenseNetTiny",
            "--no-accumulation", "--mv_minmaxnorm", "1",
            "--flow_ds_factor", "16", "--gen_flow_or_delta", "1"]


def train_argv(corpus, prefix, epochs, extra=()):
    return common_argv(corpus) + [
            "--num_segments", str(S), "--train-list", str(corpus / "list.txt"),
            "--test-list", str(corpus / "list.txt"), "--epochs", str(epochs),
            "--epoch-thre", "1", "--batch-size", "2", "--lr-mse", "1",
            "--eval-freq", "1", "--workers", "1", "--device", "cpu",
            "--model-prefix", prefix] + list(extra)


def index_seeded(monkeypatch, module, name):
    """`module.<name>` (an assembler class) drawing each batch from its
    first index: the batch counters and the dataset's item counters start
    there, so a resumed run draws what an uninterrupted one does."""
    base = getattr(module, name)

    class Seeded(base):
        def train_batch(self, indices):
            self._draws = itertools.count(indices[0])
            self.ds._draws = itertools.count(100 * indices[0])
            return super().train_batch(indices)

        def batch(self, indices):
            self.rng = np.random.default_rng(indices[0] + 7)
            self.ds.sampler.rng = np.random.default_rng(indices[0] + 11)
            return super().batch(indices)

    monkeypatch.setattr(module, name, Seeded)


def _step_state(directory):
    """(model state dict, {optimizer key/name/state key: tensor}, meta) of
    a directory's newest step, read whole."""
    import torch.distributed.checkpoint as dcp

    step = tckpt._newest_step(directory)
    keys = tckpt._dcp_keys(step)
    state = {k: torch.zeros(tuple(md.size), dtype=md.properties.dtype)
             for k, md in keys.items()}
    dcp.load(state, storage_reader=dcp.FileSystemReader(
        os.path.join(step, "state")), no_dist=True)
    return state, tckpt._read_meta(step)


def test_train_resume_equals_uninterrupted(corpus, tmp_path, monkeypatch,
                                           capsys):
    """`cli.train --ckpt-backend orbax-async`: 2 epochs (the first frozen)
    in one run, and 1 epoch, a torn step 2 planted, then `--auto-resume`
    for the second: the resumed run skips the torn step, starts at epoch
    1, and ends with the uninterrupted run's model, BN statistics, Adam
    moments and step counts, bit for bit."""
    from dmcnet_tpu_torch.cli import train as train_cli

    monkeypatch.setattr(train_cli, "SAVE_FREQ", 1)
    index_seeded(monkeypatch, train_cli, "BatchAssembler")
    flags = ["--ckpt-backend", "orbax-async"]
    full, parts = str(tmp_path / "full"), str(tmp_path / "parts")
    train_cli.main(train_argv(corpus, full, 2, flags), input_size=SIZE)
    train_cli.main(train_argv(corpus, parts, 1, flags), input_size=SIZE)
    directory = parts + "_mv_checkpoint.pth.tar.orbax"
    _torn(directory, 2)
    capsys.readouterr()
    train_cli.main(train_argv(corpus, parts, 2, flags + [
        "--auto-resume", "1"]), input_size=SIZE)
    out = capsys.readouterr().out
    assert f"--auto-resume: found {directory}" in out
    assert "(epoch 1)" in out and "Epoch: [0]" not in out
    want, want_meta = _step_state(full + "_mv_checkpoint.pth.tar.orbax")
    got, got_meta = _step_state(directory)
    assert want_meta == got_meta and got_meta["epoch"] == 2
    assert any(k.startswith("optimizer_cls/") for k in want)
    _assert_equal_states(got, want)


def test_train_i3d_resume_equals_uninterrupted(i3d_corpus, tmp_path,
                                               monkeypatch):
    """`cli.train_i3d --ckpt-backend orbax-async` at its CLI test's size
    (D and G macro steps of 2 microbatches, `--epoch-thre 1`): epoch 1
    resumed from the epoch-1 directory (stage-1 optimizers read into
    stage 2: only the discriminator's state and the carried gradients
    restore) ends where the uninterrupted run does."""
    from dmcnet_tpu_torch.cli import train_i3d

    monkeypatch.setattr(train_i3d, "build_model",
                        _port_build(train_i3d.build_model))
    index_seeded(monkeypatch, train_i3d, "I3DBatchAssembler")
    monkeypatch.chdir(tmp_path)

    def run(task, end, extra=()):
        train_i3d.main(I3D_FLAGS + i3d_data_flags(i3d_corpus) + [
            "--model-dir", str(tmp_path), "--task-name", task,
            "--end-epoch", str(end), "--ckpt-backend", "orbax-async",
            "--device", "cpu"] + list(extra), input_size=I3D_SIZE)
        return str(tmp_path / f"{task}_ep-{end:04d}.pth.orbax")

    want_dir = run("full", 2)
    first = run("parts", 1)
    assert tckpt._read_meta(tckpt._newest_step(first))["stage2"] is False
    got_dir = run("parts", 2, ["--auto-resume", "1"])
    want, want_meta = _step_state(want_dir)
    got, got_meta = _step_state(got_dir)
    assert want_meta["stage2"] and got_meta["stage2"]
    assert any(k.startswith("grad/") for k in want)
    assert any(k.startswith("optimizer_d/") for k in want)
    _assert_equal_states(got, want)


def test_scorers_read_a_directory(corpus, tmp_path):
    """`DMCPredictor.from_checkpoint` and `cli.test --weights` read a step
    directory as they read a torch file of the same state."""
    from dmcnet_tpu_torch.cli import test as test_cli
    from dmcnet_tpu_torch.serving import DMCPredictor

    model, opts, _ = _trained()
    directory = str(tmp_path / "m.orbax")
    tckpt.save_checkpoint_dcp(model, {"epoch": 1}, directory, _named(opts))
    path = str(tmp_path / "m.pth.tar")
    tckpt.save_checkpoint(model, {"epoch": 1}, path)
    kw = dict(num_class=NUM_CLASS, device="cpu", input_size=SIZE)
    a = DMCPredictor.from_checkpoint(directory, **kw).model.state_dict()
    b = DMCPredictor.from_checkpoint(path, **kw).model.state_dict()
    _assert_equal_states(a, b)

    scores = []
    for weights in (directory, path):
        out = str(tmp_path / f"scores{len(scores)}")
        test_cli.main(common_argv(corpus) + [
                       "--test-list",
                       str(corpus / "list.txt"), "--weights", weights,
                       "--test_segments", "2", "--test-crops", "1",
                       "--input_size", str(SIZE), "--save-scores", out,
                       "--device", "cpu"])
        with np.load(out + ".npz", allow_pickle=True) as z:
            scores.append(np.stack([s[0] for s in z["scores"]]))
    np.testing.assert_array_equal(scores[0], scores[1])


def test_i3d_scorer_reads_a_directory(i3d_corpus, tmp_path):
    """`evaluate_video_i3d --load-weights` (strict) reads an I3D step
    directory with its generator and BN statistics."""
    from dmcnet_tpu_torch.cli import evaluate_video_i3d as eval_cli
    from dmcnet_tpu_torch.models.i3d import get_symbol

    net, _ = get_symbol("I3D", modality="flow+mp4", num_classes=51,
                        arch_estimator="DenseNetTiny", input_size=I3D_SIZE)
    directory = str(tmp_path / "i3d.orbax")
    tckpt.save_checkpoint_dcp(net, {"epoch": 1, "top1": 0.0,
                                    "stage2": False}, directory)
    other, _ = get_symbol("I3D", modality="flow+mp4", num_classes=51,
                          arch_estimator="DenseNetTiny",
                          input_size=I3D_SIZE)
    eval_cli.load_weights(other, directory, "flow+mp4")
    _assert_equal_states(other.state_dict(), net.state_dict())
