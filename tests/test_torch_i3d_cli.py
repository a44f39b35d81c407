"""The port's `evaluate_video_i3d` command against the JAX package's, on the
CPU, on a corpus shaped as tests/test_evaluate_i3d.py's (5 videos, 24
frames, 64x80, GOP 12, labels v % 3) with the flags of examples/i3d/eval.sh
cut to size (`--clip-length 8 --batch-size 2 --num-sample 2 --input-size
64`, so the last batch of each round is ragged).  Its frames pan across
random 8x8 blocks instead of being pixel noise: noise encodes every frame
as an I-frame, whose MV and residual are zero, and the scores could then
not see which frames a command drew.

Both commands start from one set of variables at flax's shapes drawn with
numpy (tests/test_torch_i3d.py `draw_variables`): the JAX command reads it
from its own `save_checkpoint`, the port from `torch.save(
state_dict_from_flax(...))`.  The two data layers' crops differ by up to
5e-5 after normalization, the models by float32 summation order; scores
are held at rtol 1e-4, atol 2e-4 (measured worst |diff| on this CPU: 6.0e-6
of up to 7.7); labels and top-1 must be equal.  The JAX package reads
flow+mp4 clips at GOP position 0 (zero MV and residual, a fault the port
fixes): its dataset gets the reference's positions through
tests/test_torch_i3d_data.py `fix_jax_gop_positions`.  The JAX command
draws clips the port's does not (its model-init clip and the padding of a
ragged batch): the port's sampler makes those draws too (`JaxDrawOrder`).
"""

import os

import numpy as np
import pytest
import torch
from test_torch_i3d import draw_variables
from test_torch_i3d_data import fix_jax_gop_positions, panning_canvas
from test_torch_train import _two_torch_threads  # noqa: F401

from dmcnet_tpu_torch.cli import evaluate_video_i3d as port_cli
from dmcnet_tpu_torch.data.sampling import RandomSampling
from dmcnet_tpu_torch.models.weights import state_dict_from_flax

T_FRAMES, H, W, N_VIDS = 24, 64, 80, 5
FLAGS = ["--dataset", "HMDB51", "--modality", "flow+mp4",
         "--arch-estimator", "DenseNetTiny", "--mv-minmaxnorm", "1",
         "--accumulate", "0", "--ds_factor", "16", "--frame-interval", "1",
         "--clip-length", "8", "--num-sample", "2", "--batch-size", "2",
         "--input-size", "64"]
SCORE_RTOL, SCORE_ATOL = 1e-4, 2e-4


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Five panning clips in the layout of tests/test_evaluate_i3d.py."""
    from dmcnet_tpu.codec.mpeg4 import encode_mpeg4

    root = tmp_path_factory.mktemp("i3d_eval")
    os.makedirs(root / "raw" / "list_cvt")
    os.makedirs(root / "videos" / "cls")
    rng = np.random.default_rng(9)
    lines = []
    for v in range(N_VIDS):
        canvas = panning_canvas(rng, H + T_FRAMES, W + N_VIDS * T_FRAMES)
        frames = np.stack([canvas[i:i + H, (v + 1) * i:(v + 1) * i + W]
                           for i in range(T_FRAMES)])
        encode_mpeg4(root / "videos" / "cls" / f"v{v}.mp4", frames,
                     gop_size=12, bit_rate=1_000_000)
        lines.append(f"{v} {v % 3} cls/v{v}.mp4")
    (root / "raw" / "list_cvt" / "hmdb51_split1_test.txt").write_text(
        "\n".join(lines) + "\n")
    return root


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """(JAX checkpoint, port checkpoint) of one set of variables."""
    import jax
    import jax.numpy as jnp

    from dmcnet_tpu.models.i3d import get_symbol, init_i3d_variables
    from dmcnet_tpu.train.checkpoints import save_checkpoint
    from dmcnet_tpu.train.engine import TrainState

    net, _ = get_symbol("I3D", modality="flow+mp4", num_classes=51,
                        arch_estimator="DenseNetTiny")
    shapes = jax.eval_shape(lambda: init_i3d_variables(
        net, jax.random.key(0), jnp.zeros((1, 8, 64, 64, 5))))
    v = draw_variables(shapes)
    d = tmp_path_factory.mktemp("i3d_ckpt")
    jax_ckpt, port_ckpt = str(d / "jax_ep-0001.pth"), str(d / "port.pth")
    save_checkpoint(TrainState(params=v["params"],
                               batch_stats=v["batch_stats"], opt_cls=None,
                               opt_gf=None), {"epoch": 1, "top1": 0.0},
                    jax_ckpt)
    torch.save(state_dict_from_flax(v["params"], v["batch_stats"]),
               port_ckpt)
    return jax_ckpt, port_ckpt


class JaxDrawOrder(RandomSampling):
    """The port command's sampler, made to draw what the JAX command draws:
    that command also samples one clip of video 0 to initialise its model,
    and pads each round's ragged last batch with a second clip of the last
    video.  Both are extra draws just before a round's first video (the
    padding draw of the round before), which this sampler makes and
    discards, so that both commands score the same frames."""

    calls = 0

    def sampling(self, range_max):
        if self.calls % N_VIDS == 0:
            super().sampling(range_max)
        self.calls += 1
        return super().sampling(range_max)


def _data_flags(corpus):
    return ["--data-root", str(corpus), "--video-prefix",
            str(corpus / "videos")]


def test_evaluate_cli_matches_jax(corpus, checkpoints, tmp_path,
                                  monkeypatch):
    import jax
    import jax.numpy as jnp

    from dmcnet_tpu.cli import evaluate_video_i3d as jax_cli
    from dmcnet_tpu.data import video_iter as jax_video_iter

    fix_jax_gop_positions(monkeypatch, jax_video_iter)
    monkeypatch.setattr(port_cli, "RandomSampling", JaxDrawOrder)
    # The JAX command initialises its variables with flax's init, then
    # loads the checkpoint over every one of them; run eagerly, that init
    # takes over a minute on this CPU, so it gets zeros of the same shapes.
    init = jax_cli.init_i3d_variables
    monkeypatch.setattr(jax_cli, "init_i3d_variables", lambda *a: jax.tree.map(
        lambda s: jnp.zeros(s.shape, s.dtype),
        jax.eval_shape(lambda: init(*a))))
    jax_ckpt, port_ckpt = checkpoints
    jf, tf = str(tmp_path / "jax_scores"), str(tmp_path / "port_scores")
    top1_j = jax_cli.main(FLAGS + _data_flags(corpus) + [
        "--load-weights", jax_ckpt, "--score-file", jf])
    top1_t = port_cli.main(FLAGS + _data_flags(corpus) + [
        "--load-weights", port_ckpt, "--score-file", tf, "--device", "cpu"])
    with np.load(jf + ".npz") as want, np.load(tf + ".npz") as got:
        assert sorted(got.files) == sorted(want.files) == \
            ["labels", "scores", "top1"]
        assert got["scores"].shape == (N_VIDS, 51)
        assert got["scores"].dtype == np.float64
        # the videos' scores differ: the comparison sees which frames each
        # command drew
        assert got["scores"].std(axis=0).max() > 0.1
        np.testing.assert_allclose(got["scores"], want["scores"],
                                   rtol=SCORE_RTOL, atol=SCORE_ATOL)
        np.testing.assert_array_equal(got["labels"], want["labels"])
        assert list(got["labels"]) == [v % 3 for v in range(N_VIDS)]
        np.testing.assert_array_equal(got["scores"].argmax(1),
                                      want["scores"].argmax(1))
        assert float(got["top1"]) == float(want["top1"]) == top1_t == top1_j


def test_refused_flags_raise(corpus, checkpoints, tmp_path):
    """Flags that raised before their slice was ported.  `--load-weights`
    of the JAX package's file and of a step directory of the port's
    `--ckpt-backend orbax` score exactly as the port's torch file of the
    same weights.  `--shard-time 1 --gpus 0 1 2` splits each 8-frame clip
    over the largest count of the ids that divides it, 2 gloo processes,
    and scores as the unsharded forward (float32, summed in another
    order)."""
    from dmcnet_tpu_torch.models.i3d import get_symbol
    from dmcnet_tpu_torch.train.checkpoints import save_checkpoint_dcp

    jax_ckpt, port_ckpt = checkpoints
    base = FLAGS + _data_flags(corpus) + ["--device", "cpu"]
    net, _ = get_symbol("I3D", modality="flow+mp4", num_classes=51,
                        arch_estimator="DenseNetTiny", input_size=64)
    net.load_state_dict(torch.load(port_ckpt, weights_only=True))
    orbax_dir = str(tmp_path / "i3d_ep-0001.pth.orbax")
    save_checkpoint_dcp(net, {"epoch": 1, "top1": 0.0, "stage2": True},
                        orbax_dir)
    scores = []
    for weights, extra in ((port_ckpt, []), (jax_ckpt, []), (orbax_dir, []),
                           (port_ckpt, ["--shard-time", "1", "--gpus", "0",
                                        "1", "2"])):
        out = str(tmp_path / f"scores{len(scores)}")
        port_cli.main(base + ["--load-weights", weights, "--score-file",
                              out] + extra)
        with np.load(out + ".npz") as z:
            scores.append(z["scores"])
    np.testing.assert_array_equal(scores[1], scores[0])
    np.testing.assert_array_equal(scores[2], scores[0])
    np.testing.assert_allclose(scores[3], scores[0], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dropped", ["gen_flow_model.", "running_"])
def test_partial_checkpoint_raises(corpus, checkpoints, tmp_path, dropped):
    """A file without the generator, or without BN statistics, would leave
    those tensors at their initialisation: the command names them and
    stops, as the JAX command's restore does."""
    sd = torch.load(checkpoints[1], weights_only=True)
    path = str(tmp_path / "partial.pth")
    torch.save({k: v for k, v in sd.items() if dropped not in k}, path)
    with pytest.raises(SystemExit, match=f"does not fill .*{dropped}"):
        port_cli.main(FLAGS + _data_flags(corpus)
                      + ["--load-weights", path, "--device", "cpu"])


def test_cuda_default_raises_without_cuda(corpus, checkpoints, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_cli.main(FLAGS + _data_flags(corpus)
                      + ["--load-weights", checkpoints[1]])
