"""Serving over several devices (`DMCPredictor(mesh=[...])`, `serve
--mesh-devices`) against the JAX package's `DMCPredictor(mesh=make_mesh(),
pack=False)` on its 8-device CPU mesh (tests/conftest.py), following
tests/test_serving.py's `test_predict_mesh_sharded_matches_single`: the
JAX side back-traces with its XLA twin (`backtrace_warp_batch_xla`), the
port's wrapper runs its plain version on CPU tensors.  The port serves over
a list of 3 CPU devices, so an 8-GOP chunk splits 3 / 3 / 2 and a 4-GOP
tail chunk 2 / 1 / 1.  u8 batches are bit-equal and logits and video
scores agree at rtol 1e-4, atol 2e-4 (tests/test_torch_serving.py's:
float32 convolutions summed in different orders)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_serving import ATOL, HW, NUM_CLASS, RTOL, _encode_panning
from test_torch_train import _two_torch_threads  # noqa: F401
from test_torch_train import flax_init

from dmcnet_tpu_torch.codec.mpeg4 import VideoReader
from dmcnet_tpu_torch.ops import backtrace as tbacktrace
from dmcnet_tpu_torch.ops.backtrace import cell_mv_from_blocks
from dmcnet_tpu_torch.serving import DMCPredictor

MESH = ["cpu"] * 3


@pytest.fixture(scope="module")
def predictors():
    """(JAX predictor on the 8-device mesh, the port's over 3 CPU devices,
    the port's on one), the same weights."""
    from dmcnet_tpu.models import DMCNet as FlaxDMCNet
    from dmcnet_tpu.ops.pallas_backtrace import backtrace_warp_batch_xla
    from dmcnet_tpu.parallel import make_mesh
    from dmcnet_tpu.serving import DMCPredictor as JaxPredictor
    from dmcnet_tpu_torch.models.weights import state_dict_from_flax

    model = FlaxDMCNet(num_class=NUM_CLASS, num_segments=1,
                       arch_estimator="DenseNetTiny", gen_flow_or_delta=1)
    variables = flax_init(
        model, jax.random.key(0), jnp.zeros((1, 1, HW, HW, 2)),
        jnp.zeros((1, 1, HW, HW, 3)), train=False)
    jp = JaxPredictor(variables["params"], variables["batch_stats"],
                      num_class=NUM_CLASS, input_size=HW, pack=False,
                      mesh=make_mesh(),
                      backtrace_impl=backtrace_warp_batch_xla)
    sd = state_dict_from_flax(jax.tree.map(np.asarray, variables["params"]),
                              jax.tree.map(np.asarray,
                                           variables["batch_stats"]))
    tp = DMCPredictor(sd, num_class=NUM_CLASS, input_size=HW, pack=False,
                      mesh=MESH)
    single = DMCPredictor(sd, num_class=NUM_CLASS, input_size=HW,
                          pack=False, device="cpu")
    return jp, tp, single


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh_clips")
    paths = []
    for i, (n, h, w) in enumerate([(26, 64, 96), (14, 64, 96),
                                   (38, 48, 64)]):
        p = str(d / f"v{i}.avi")
        _encode_panning(p, np.random.default_rng(40 + i), n=n, h=h, w=w)
        paths.append(p)
    return paths


def _gop_rows(pred, path, picks=(1, 6)):
    rows = []
    with VideoReader(path) as reader:
        h, w = reader.height, reader.width
        for g in range(reader.num_gops):
            frames, _, blocks, n_blocks = reader.decode_gop_blocks(
                g, skip_dense=True)
            if len(frames) < 2:
                continue
            cm, cell = cell_mv_from_blocks(blocks, n_blocks, h, w)
            pick = np.minimum(list(picks) + [len(frames) - 1],
                              len(frames) - 1)
            rows.append((cm, cell, frames[0],
                         pred._center_crop(frames[pick]), pick))
    return rows, h, w


def test_mesh_gop_program_matches_jax(predictors, clips):
    """One 8-GOP chunk (3 real GOPs, 5 padded rows) over 3 devices in
    shares of 3, 3 and 2: the concatenated u8 outputs equal the JAX mesh
    program's bit for bit, the logits within the serving tolerance; the
    back-trace ran once per device."""
    jp, tp, _ = predictors
    rows, h, w = _gop_rows(tp, clips[0])
    cell = rows[0][1]
    g, t, n_pick = 8, 12, 3
    calls = []
    real = tp._backtrace
    tp._backtrace = lambda cm, *a, **kw: calls.append(cm.shape[0]) or \
        real(cm, *a, **kw)
    try:
        logits_t, mv_t, res_t = tp.gather_outputs(
            tp._launch(rows, g, t, h, w, cell, n_pick))
    finally:
        tp._backtrace = real
    assert calls == [3, 3, 2]
    logits_j, mv_j, res_j = jp._gop_program(g, t, h, w, cell, n_pick)(
        jnp.asarray(jp._pack_rows(rows, g, t, h, w, cell, n_pick)))
    np.testing.assert_array_equal(mv_t, np.asarray(mv_j))
    np.testing.assert_array_equal(res_t, np.asarray(res_j))
    np.testing.assert_allclose(logits_t, np.asarray(logits_j), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("backend", ["device", "host"])
def test_mesh_predict_videos_matches_jax(predictors, clips, backend):
    """Whole videos of two geometries in 4-GOP chunks (the 64x96 pair
    fills a chunk and leaves a ragged tail), a duplicate path: the port's
    mesh scores equal the port's single-device ones, in input order, and
    the JAX mesh predictor's: every video on the device path; on the host
    path (its clip batches split over the devices) one video, whose clips
    fill one clip bucket, so that the JAX mesh program compiles once."""
    jp, tp, single = predictors
    paths = clips + [clips[1]]
    got = tp.predict_videos(paths, backend=backend, chunk_gops=4)
    one = single.predict_videos(paths, backend=backend, chunk_gops=4)
    for a, c in zip(got, one):
        np.testing.assert_allclose(a, c, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got[-1], got[1])
    if backend == "host":
        np.testing.assert_allclose(
            got[1], jp.predict_video(clips[1], backend=backend),
            rtol=RTOL, atol=ATOL)
    else:
        want = jp.predict_videos(paths, backend=backend, chunk_gops=4)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
        # the TSN protocol's picks, one video
        np.testing.assert_allclose(
            tp.predict_video(clips[2], backend=backend, segments=5),
            jp.predict_video(clips[2], backend=backend, segments=5),
            rtol=RTOL, atol=ATOL)


def test_mesh_launches_every_device_before_reading(predictors, clips,
                                                   monkeypatch):
    """Every device's share of a chunk is enqueued before any result is
    read back: the outputs stay on their devices until `gather_outputs`."""
    _, tp, _ = predictors
    rows, h, w = _gop_rows(tp, clips[1])
    reads = []
    real_cpu = torch.Tensor.cpu
    monkeypatch.setattr(torch.Tensor, "cpu", lambda self: reads.append(
        self.shape) or real_cpu(self))
    parts = tp._launch(rows, 4, 12, h, w, rows[0][1], 3)
    assert len(parts) == 3 and reads == []
    tp.gather_outputs(parts)
    assert len(reads) == 9


def test_cli_serve_mesh_devices(predictors, clips, tmp_path, monkeypatch):
    """`serve --mesh-devices 3 --device cpu` scores as the single-device
    command; more cards than are visible raise, with no fallback."""
    from dmcnet_tpu_torch.cli import serve

    _, _, single = predictors
    ckpt = tmp_path / "w.pth.tar"
    torch.save({"state_dict": single.model.state_dict()}, ckpt)
    base = ["--weights", str(ckpt), "--num-class", str(NUM_CLASS),
            "--input_size", str(HW), "--chunk-gops", "4", "--device", "cpu",
            "--no-pack"]
    one = serve.main(base + clips[:2])
    three = serve.main(base + ["--mesh-devices", "3"] + clips[:2])
    for a, b in zip(three, one):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(SystemExit, match="only 1 CUDA devices"):
        serve.mesh_devices(2, "cuda")
    assert serve.mesh_devices(1, "cuda") == ["cuda:0"]
    assert serve.mesh_devices(2, "cpu") == ["cpu", "cpu"]


def test_mesh_kernel_route_on_cpu_tensors():
    """On CPU tensors the mesh path's back-trace is the wrapper's plain
    version (the kernel launches on CUDA tensors only): no launch is
    counted here."""
    before = tbacktrace.backtrace_warp_batch.launches
    cm = torch.zeros((2, 3, 4, 6, 2), dtype=torch.int32)
    ifr = torch.zeros((2, 3, 64, 96), dtype=torch.int32)
    accu, warped = tbacktrace.backtrace_warp_batch(cm, ifr, 64, 96, 16)
    assert accu.shape == (2, 3, 2, 64, 96)
    assert tbacktrace.backtrace_warp_batch.launches == before
