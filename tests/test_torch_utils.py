"""The port's last modules against the JAX package: flow pictures
(`utils/viz.py`), profiling (`utils/profiling.py`, `cli.train
--profile-dir`), `codec.mpeg4.encode_video` and the `python -m
dmcnet_tpu_torch` dispatcher.

`viz_flow` is the same numpy arithmetic in both packages, so its pictures
are held bit for bit; `write_png` is held by decoding its file with PIL.
`--profile-dir` must trace the JAX command's window
(dmcnet_tpu/cli/train.py:301-313, 364-366): steps min(2, batches - 1) to
7 of the first epoch only, one `ProfilerStep#<step>` span a step; it runs
`cli.train.train` on the CPU at input 32 over datasets of random group
stacks (CoviarDataset's item contract), 2 epochs of 3 and of 10 batches
of 2 videos (train-mode BN needs more than one value a channel).
`encode_video` clips must decode to the same frames in both packages'
decoders.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image
from test_torch_train import _two_torch_threads  # noqa: F401 (autouse)

from dmcnet_tpu_torch.utils.viz import viz_flow, write_png


def test_viz_flow_matches_jax():
    """The same flow gives the same picture, bit for bit, log and linear
    scale, and a zero flow does not divide by zero."""
    from dmcnet_tpu.utils.viz import viz_flow as jax_viz_flow

    rng = np.random.default_rng(0)
    u, v = rng.normal(0, 4, size=(2, 37, 53)).astype(np.float32)
    for kw in ({}, {"logscale": False, "scaledown": 3}):
        want = jax_viz_flow(u, v, **kw)
        got = viz_flow(u, v, **kw)
        assert got.shape == (37, 53, 3) and got.dtype == np.float64
        np.testing.assert_array_equal(got, want)
    zero = viz_flow(np.zeros((4, 4)), np.zeros((4, 4)))
    np.testing.assert_array_equal(zero, np.ones((4, 4, 3)))


def test_write_png_decodes(tmp_path):
    """PIL reads `write_png`'s file back to the same pixels; another shape
    than (H, W, 3) raises."""
    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, size=(31, 45, 3), dtype=np.uint8)
    path = tmp_path / "a.png"
    write_png(path, img)
    with Image.open(path) as f:
        assert f.mode == "RGB"
        np.testing.assert_array_equal(np.asarray(f), img)
    with pytest.raises(ValueError, match="RGB"):
        write_png(tmp_path / "b.png", img[..., :2])


def _steps(path):
    """The step numbers of a trace's host `ProfilerStep#k` spans (a card's
    trace repeats them on the device's timeline)."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return sorted(int(e["name"].split("#")[1]) for e in events
                  if e.get("name", "").startswith("ProfilerStep#")
                  and e.get("cat") == "user_annotation")


def test_profiling_helpers(tmp_path):
    """`trace` writes a Chrome trace whose steps are `prof.step()`'s, with
    a `span` inside; `step_timer` measures its block."""
    from dmcnet_tpu_torch.utils.profiling import span, step_timer, trace

    x = torch.ones(64, 64)
    with trace(str(tmp_path / "prof"), device="cpu") as prof:
        for _ in range(3):
            with span("matmul"):
                x = x @ x / 64
            prof.step()
    assert os.path.dirname(prof.trace_path) == str(tmp_path / "prof")
    assert _steps(prof.trace_path) == [0, 1, 2, 3]
    with open(prof.trace_path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "dmc.matmul" in names
    with step_timer(sync=x) as t:
        y = x @ x
    assert t.elapsed > 0 and y.shape == (64, 64)


def _random_dataset(num_videos, is_train):
    """A CoviarDataset over random (H, W, 7) group stacks: no decoder."""
    from dmcnet_tpu_torch.data.dmc_dataset import CoviarDataset
    from dmcnet_tpu_torch.data.lists import VideoItem

    class RandomStacks(CoviarDataset):
        def _segment_frame(self, item, gop_index, gop_pos):
            rng = np.random.default_rng((item.label, gop_index, gop_pos))
            return rng.integers(0, 256, size=(40, 48, 7), dtype=np.uint8)

    items = [VideoItem(f"random/{v}.avi", v % 3, 24)
             for v in range(num_videos)]
    return RandomStacks(None, None, None, "mv", 1, is_train=is_train,
                        items=items)


@pytest.mark.parametrize("batches,want", [(3, [2]), (10, list(range(2, 8)))])
def test_train_profile_dir_window(tmp_path, capsys, batches, want):
    """`cli.train --profile-dir` over 2 epochs: one trace, of the first
    epoch, whose steps are the JAX command's window."""
    from dmcnet_tpu_torch.cli import train as train_cli
    from dmcnet_tpu_torch.cli.train_options import build_parser

    prof_dir = tmp_path / "prof"
    args = build_parser().parse_args([
        "--data-name", "hmdb51", "--representation", "mv",
        "--arch", "resnet18", "--arch_estimator", "DenseNetTiny",
        "--num_segments", "1", "--epochs", "2", "--batch-size", "2",
        "--workers", "1", "--eval-freq", "5", "--profile-dir", str(prof_dir),
        "--model-prefix", str(tmp_path / "model")])
    train_cli.train(args, _random_dataset(2 * batches, True),
                    _random_dataset(1, False), device="cpu", input_size=32)
    files = os.listdir(prof_dir)
    assert len(files) == 1
    assert _steps(prof_dir / files[0]) == want
    out = capsys.readouterr().out
    assert out.count("profiler trace written to ") == 1
    assert str(prof_dir / files[0]) in out


@pytest.mark.parametrize("codec", ["mpeg2video", "mjpeg"])
def test_encode_video_decodes_alike(tmp_path, codec):
    """A clip of another codec written by the port decodes to the same
    frames in the JAX package's decoder and the port's, close to what was
    encoded."""
    from dmcnet_tpu.codec.mpeg4 import VideoReader as JaxReader
    from dmcnet_tpu_torch.codec.mpeg4 import (
        NativeCodecUnavailable,
        VideoReader,
        _lib,
        encode_video,
    )

    try:
        _lib()
    except NativeCodecUnavailable as exc:
        pytest.skip(f"the native codec does not build here: {exc}")
    rng = np.random.default_rng(2)
    small = rng.integers(0, 256, size=(9, 13, 3))
    canvas = np.kron(small, np.ones((8, 8, 1))).astype(np.uint8)
    frames = np.stack([canvas[i:i + 48, 2 * i:2 * i + 64] for i in range(20)])
    path = str(tmp_path / f"clip_{codec}.avi")
    encode_video(path, frames, codec=codec, gop_size=12,
                 bit_rate=4_000_000)
    with VideoReader(path) as port, JaxReader(path) as ref:
        assert not port.is_mpeg4 and port.codec_id == ref.codec_id
        assert port.num_gops == ref.num_gops >= 1
        got = np.concatenate([port.decode_gop(g, with_mv=False)[0]
                              for g in range(port.num_gops)])
        want = np.concatenate([ref.decode_gop(g, with_mv=False)[0]
                               for g in range(ref.num_gops)])
    assert got.shape == frames.shape
    np.testing.assert_array_equal(got, want)
    assert np.abs(got.astype(int) - frames).mean() < 12.0
    with pytest.raises(IOError, match="no_such_codec encode failed"):
        encode_video(str(tmp_path / "x.avi"), frames, codec="no_such_codec")


def test_dispatcher(tmp_path, capsys):
    """The JAX dispatcher's commands in its order, exit code 0 for the
    listing and for a command returning a score, 2 for an unknown one."""
    from dmcnet_tpu.__main__ import COMMANDS as JAX_COMMANDS
    from dmcnet_tpu_torch.__main__ import COMMANDS, main
    from dmcnet_tpu_torch.cli.common import save_scores_npz

    assert list(COMMANDS) == list(JAX_COMMANDS)
    assert all(v.startswith("dmcnet_tpu_torch.cli.")
               for v in COMMANDS.values())
    for argv in ([], ["--help"]):
        assert main(argv) == 0
        lines = capsys.readouterr().out.splitlines()
        assert [x.strip() for x in lines[3:]] == list(JAX_COMMANDS)
    assert main(["no-such-command"]) == 2
    assert "unknown command 'no-such-command'" in capsys.readouterr().err

    scores = str(tmp_path / "s.npz")
    save_scores_npz(scores, [(np.eye(3)[i][None], i) for i in range(3)],
                    [0, 1, 2], ["a", "b", "c"])
    assert main(["combine", "--iframe", scores, "--mv", scores,
                 "--res", scores]) == 0
    assert "Accuracy: 1.000000 (3)." in capsys.readouterr().out

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    run = subprocess.run([sys.executable, "-m", "dmcnet_tpu_torch",
                          "no-such-command"], cwd=root, capture_output=True,
                         text=True, timeout=120)
    assert run.returncode == 2 and "unknown command" in run.stderr
