"""The port's serving path (dmcnet_tpu_torch/serving.py) against the JAX
package's `DMCPredictor(pack=False)` on the CPU, with the same weights
(flax init bridged by `state_dict_from_flax`) and the same encoded panning
clips: the GOP program's u8 outputs are bit-equal, and logits and video
scores agree at rtol=1e-4, atol=2e-4 (float32 convolutions summed in
different orders)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_train import _two_torch_threads  # noqa: F401
from test_torch_train import flax_init

from dmcnet_tpu.codec.mpeg4 import encode_mpeg4
from dmcnet_tpu.models import DMCNet as FlaxDMCNet
from dmcnet_tpu.serving import DMCPredictor as JaxPredictor
from dmcnet_tpu_torch.codec.mpeg4 import VideoReader
from dmcnet_tpu_torch.models.weights import state_dict_from_flax
from dmcnet_tpu_torch.ops.backtrace import cell_mv_from_blocks
from dmcnet_tpu_torch.serving import DMCPredictor

RTOL, ATOL = 1e-4, 2e-4
NUM_CLASS, HW = 7, 64


def _encode_panning(path, rng, n=26, h=64, w=96, gop=12):
    pad = 40
    canvas = (rng.integers(0, 256, size=(h + 2 * pad + 30,
                                         w + 2 * pad + 60, 3))
              // 8 * 8).astype(np.uint8)
    frames = np.stack([canvas[pad + i:pad + i + h,
                              pad + 2 * i:pad + 2 * i + w]
                       for i in range(n)])
    encode_mpeg4(path, frames, gop_size=gop, bit_rate=2_000_000)


@pytest.fixture(scope="module")
def predictors():
    """(JAX pack=False predictor, port pack=False predictor on the CPU),
    same weights."""
    model = FlaxDMCNet(num_class=NUM_CLASS, num_segments=1,
                       arch_estimator="DenseNetTiny", gen_flow_or_delta=1)
    variables = flax_init(
        model, jax.random.key(0), jnp.zeros((1, 1, HW, HW, 2)),
        jnp.zeros((1, 1, HW, HW, 3)), train=False)
    jp = JaxPredictor(variables["params"], variables["batch_stats"],
                      num_class=NUM_CLASS, input_size=HW, pack=False)
    sd = state_dict_from_flax(jax.tree.map(np.asarray, variables["params"]),
                              jax.tree.map(np.asarray,
                                           variables["batch_stats"]))
    tp = DMCPredictor(sd, num_class=NUM_CLASS, input_size=HW, pack=False,
                      device="cpu")
    return jp, tp


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    d = tmp_path_factory.mktemp("clips")
    paths = []
    for i, (n, h, w) in enumerate([(26, 64, 96), (14, 64, 96),
                                   (14, 48, 64)]):
        p = str(d / f"v{i}.avi")
        _encode_panning(p, np.random.default_rng(10 + i), n=n, h=h, w=w)
        paths.append(p)
    return paths


def test_gop_program_u8_bit_equal_to_jax(predictors, clips):
    jp, tp = predictors
    rows, h, w, cell = [], None, None, None
    with VideoReader(clips[0]) as reader:
        h, w = reader.height, reader.width
        for g in range(reader.num_gops):
            frames, _, blocks, n_blocks = reader.decode_gop_blocks(
                g, skip_dense=True)
            if len(frames) < 2:
                continue
            cm, cell = cell_mv_from_blocks(blocks, n_blocks, h, w)
            assert cm is not None
            pick = np.array([1, 6, len(frames) - 1])
            rows.append((cm, cell, frames[0],
                         tp._center_crop(frames[pick]), pick))
    assert len(rows) >= 2
    g, t, n_pick = 4, 12, 3
    logits_t, mv_t, res_t = tp._gop_program(g, t, h, w, cell, n_pick)(
        *tp._stage(rows, g, t, h, w, cell, n_pick, torch.device("cpu")))
    logits_j, mv_j, res_j = jp._gop_program(g, t, h, w, cell, n_pick)(
        jnp.asarray(jp._pack_rows(rows, g, t, h, w, cell, n_pick)))
    np.testing.assert_array_equal(mv_t.numpy(), np.asarray(mv_j))
    np.testing.assert_array_equal(res_t.numpy(), np.asarray(res_j))
    np.testing.assert_allclose(logits_t.numpy(), np.asarray(logits_j),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("backend", ["device", "host"])
def test_predict_videos_matches_jax(predictors, clips, backend):
    """Mixed geometries and a duplicate path; the duplicate is scored once
    and handed out as a fresh copy."""
    jp, tp = predictors
    paths = clips + [clips[0]]
    got = tp.predict_videos(paths, backend=backend, chunk_gops=4)
    want = jp.predict_videos(paths, backend=backend, chunk_gops=4)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
    assert got[-1] is not got[0]
    np.testing.assert_array_equal(got[-1], got[0])


def test_predict_video_segments_matches_jax(predictors, clips):
    jp, tp = predictors
    for backend in ("device", "host"):
        np.testing.assert_allclose(
            tp.predict_video(clips[0], backend=backend, segments=5),
            jp.predict_video(clips[0], backend=backend, segments=5),
            rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        tp.predict_videos(clips[:2], chunk_gops=4, segments=5)[1],
        jp.predict_videos(clips[:2], chunk_gops=4, segments=5)[1],
        rtol=RTOL, atol=ATOL)


def test_on_error_zero_keeps_batch_alive(predictors, clips, tmp_path):
    _, tp = predictors
    bad = tmp_path / "garbage.avi"
    bad.write_bytes(b"not a video" * 100)
    out = tp.predict_videos([str(bad), clips[1]], chunk_gops=4,
                            on_error="zero")
    np.testing.assert_array_equal(out[0], np.zeros(NUM_CLASS, np.float32))
    assert np.isfinite(out[1]).all() and np.abs(out[1]).max() > 0
    with pytest.raises(OSError):
        tp.predict_videos([str(bad)], chunk_gops=4)


def test_cli_serve_scores_and_saves(predictors, clips, tmp_path):
    from dmcnet_tpu_torch.cli import serve

    _, tp = predictors
    ckpt = tmp_path / "w.pth.tar"
    torch.save({"epoch": 0, "arch": "resnet18",
                "state_dict": {"module." + k: v for k, v in
                               tp.model.state_dict().items()}}, ckpt)
    out = tmp_path / "scores.npz"
    scores = serve.main(["--weights", str(ckpt), "--num-class",
                         str(NUM_CLASS), "--input_size", str(HW),
                         "--chunk-gops", "4", "--device", "cpu", "--no-pack",
                         "--save-scores", str(out), *clips[:2]])
    want = tp.predict_videos(clips[:2], chunk_gops=4)
    for a, b in zip(scores, want):
        np.testing.assert_array_equal(a, b)
    assert set(np.load(out, allow_pickle=True)) == {"scores", "labels",
                                                    "names"}


def test_cli_stdin_daemon_and_warmup(predictors, clips, tmp_path):
    """--stdin answers one JSON line per request, errors in-band; warmup
    runs every chunk-ladder shape."""
    import io
    import json

    from dmcnet_tpu_torch.cli import serve

    _, tp = predictors
    tp.warmup(geometries=((64, 96),), chunk_gops=8, host_buckets=(4,))
    args = serve.build_parser().parse_args(
        ["--weights", "unused", "--chunk-gops", "4", "--stdin"])
    req = io.StringIO(f"{clips[1]}\n"
                      + json.dumps({"path": str(tmp_path / "none.avi"),
                                    "id": "x"}) + "\n{bad json\n")
    out = io.StringIO()
    serve.serve_stdin(tp, args, inp=req, out=out)
    lines = [json.loads(line) for line in out.getvalue().splitlines()]
    assert [r["id"] for r in lines] == [0, "x", 2]
    want = tp.predict_videos([clips[1]], chunk_gops=4)[0]
    assert lines[0]["pred"] == int(np.argmax(want))
    assert "error" in lines[1] and "error" in lines[2]


def test_predictor_without_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        DMCPredictor(num_class=NUM_CLASS, input_size=HW)
    # a mesh of cards needs CUDA too: no fallback to the CPU
    with pytest.raises(RuntimeError, match="CUDA"):
        DMCPredictor(num_class=NUM_CLASS, input_size=HW,
                     mesh=["cuda:0", "cuda:1"])
