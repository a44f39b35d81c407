"""The serving path's chunk staging (`DMCPredictor._stage` through
`utils.staging.PinnedStaging`) and the chunk shapes it is staged at.

On the CPU, with unpinned buffers: the tensors `_stage` hands the GOP
program, packed by the JAX package's `_pack_gop_buffer`, equal byte for
byte the JAX package's own packing of the same rows, for a full chunk, a
ragged tail padded up the ladder, and rows short of frames and picks on a
coarser grid, each staged after larger chunks left non-zero bytes in both
buffers.  `warmup` launches every chunk shape that traffic
at its geometry then runs.  On the card (`cuda`): `predict_videos` through
the pinned staging gives the scores of the same predictor synchronised
after each chunk's launch, bit for bit; two requests of two chunks never
wait for a buffer, and chunks queued behind a busy stream do wait and
still arrive whole."""

import numpy as np
import pytest
import torch

from dmcnet_tpu_torch.serving import DMCPredictor

H, W, SIZE, T, PICKS = 64, 96, 32, 12, 3


def gop_rows(rng, n, t=T, cell=8, picks=PICKS, h=H, w=W, size=SIZE):
    """n GOP rows `(cm, cell, iframe, fp, pick)` of random content."""
    rows = []
    for _ in range(n):
        cm = rng.integers(-24, 25, (t, h // cell, w // cell, 2),
                          dtype=np.int32)
        iframe = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        fp = rng.integers(0, 256, (picks, size, size, 3), dtype=np.uint8)
        pick = np.sort(rng.choice(np.arange(1, t), picks, replace=False))
        rows.append((cm, cell, iframe, fp, pick))
    return rows


def dirty_rows(n):
    """Rows whose every byte is non-zero, at the cases' widest layout."""
    return [(np.full((T, H // 8, W // 8, 2), -1, np.int32), 8,
             np.full((H, W, 3), 255, np.uint8),
             np.full((PICKS, SIZE, SIZE, 3), 255, np.uint8),
             np.full(PICKS, T - 1, np.int64))] * n


def case_rows(case):
    """-> (rows, g, cell) of a chunk."""
    rng = np.random.default_rng(["chunk64", "ragged_tail",
                                 "short_rows"].index(case))
    if case == "chunk64":
        return gop_rows(rng, 64), 64, 8
    if case == "ragged_tail":
        return gop_rows(rng, 4), 8, 8
    # fewer frames than tmax, fewer picks than n_pick, 16-grids among 8s
    rows = (gop_rows(rng, 2, t=7, picks=2) + gop_rows(rng, 2, cell=16)
            + gop_rows(rng, 1, t=5, picks=1, cell=16) + gop_rows(rng, 1))
    return rows, 8, 8


@pytest.fixture(scope="module")
def pred():
    return DMCPredictor(num_class=5, input_size=SIZE, pack=False,
                        device="cpu")


@pytest.mark.parametrize("case", ["chunk64", "ragged_tail", "short_rows"])
def test_staged_chunk_equals_jax_pack(pred, case):
    from dmcnet_tpu.serving import DMCPredictor as JaxPredictor

    jp = JaxPredictor(None, None, num_class=5, input_size=SIZE, pack=False)
    rows, g, cell = case_rows(case)
    cpu = torch.device("cpu")
    # both buffers of the device hold a larger chunk's non-zero bytes
    for _ in range(2):
        pred._stage(dirty_rows(64), 64, T, H, W, 8, PICKS, cpu)
    got = pred._stage(rows, g, T, H, W, cell, PICKS, cpu)
    # the staged tensors are copies: refilling the buffers leaves them
    for _ in range(2):
        pred._stage(dirty_rows(64), 64, T, H, W, 8, PICKS, cpu)
    specs = pred._row_specs(T, H, W, cell, PICKS)
    assert [(a.dtype, a.shape) for a in got] == [(dt, (g,) + s)
                                                 for s, dt, _ in specs]
    cm, iframe, fp, pk = (a.numpy() for a in got)
    np.testing.assert_array_equal(
        jp._pack_gop_buffer(cm, iframe, fp, pk.astype(np.uint8)),
        jp._pack_rows(rows, g, T, H, W, cell, PICKS))


class Gathered(DMCPredictor):
    """A predictor whose `_gather_video_device` hands over
    `videos[path]`'s rows at `hw`, `t` frames a GOP."""

    def __init__(self, videos, hw, t, **kw):
        super().__init__(**kw)
        self.videos, self.hw, self.t = videos, hw, t

    def _gather_video_device(self, path, frames_per_gop, segments=None):
        rows = self.videos[path]
        return ([(cm, c) for cm, c, *_ in rows],
                [(iframe, fp, self.t) for _, _, iframe, fp, _ in rows],
                [pick for *_, pick in rows],
                [len(pick) for *_, pick in rows],
                [np.ones(len(pick), np.float32) for *_, pick in rows],
                *self.hw)


def test_warmup_launches_the_shapes_traffic_runs(monkeypatch):
    """GOPs of 16 frames: `warmup` at that geometry launches the chunk
    shapes `predict_videos` then runs (`tmax` rounded up to 24), the full
    chunk and the ragged tail alike."""
    t, cell = 16, 8
    rng = np.random.default_rng(7)
    videos = {f"v{i}": gop_rows(rng, n, t=t, cell=cell)
              for i, n in enumerate([5, 6])}
    pred = Gathered(videos, (H, W), t, num_class=5, input_size=SIZE,
                    pack=False, device="cpu")
    shapes, launch = [], pred._launch

    def recorded(rows, *shape):
        shapes.append(shape)
        return launch(rows, *shape)

    monkeypatch.setattr(pred, "_launch", recorded)
    pred.warmup(geometries=((H, W, t, cell),), frames_per_gop=PICKS,
                chunk_gops=8, host_buckets=())
    warmed = set(shapes)
    shapes.clear()
    pred.predict_videos(list(videos), frames_per_gop=PICKS, backend="device",
                        chunk_gops=8)
    assert [s[0] for s in shapes] == [8, 4]   # 11 GOPs: 8, then 3 in 4
    assert set(shapes) <= warmed, (shapes, warmed)


# --- on the card -----------------------------------------------------------

def cuda_predictor():
    """A `pack=True` predictor on the card whose `_gather_video_device`
    hands over its videos' rows at 256x320, 12 frames, cell 16."""
    h, w = 256, 320
    rng = np.random.default_rng(5)
    videos = {f"v{i}": gop_rows(rng, n, cell=16, h=h, w=w, size=224)
              for i, n in enumerate([16, 12, 8, 4, 16, 8, 12, 4, 16, 16, 16,
                                     16])}
    return Gathered(videos, (h, w), T, num_class=51, input_size=224,
                    device="cuda")


def serialised(pred, monkeypatch):
    """Synchronise the card after each of `pred`'s chunk launches: no
    buffer is refilled while its copies run."""
    launch = pred._launch

    def fn(*args):
        out = launch(*args)
        torch.cuda.synchronize()
        return out

    monkeypatch.setattr(pred, "_launch", fn)


@pytest.mark.cuda
def test_cuda_staged_requests_match_unstaged(monkeypatch):
    from torch.profiler import ProfilerActivity, profile

    from dmcnet_tpu_torch.utils.profiling import read_spans

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    pred = cuda_predictor()
    # 80 GOPs (64 + 16) and 108 GOPs (64 + 44 padded to 64)
    requests = [[f"v{i}" for i in range(8)],
                [f"v{i}" for i in (0, 4, 8, 9, 10, 11, 1)]]
    pred.predict_videos(requests[0], backend="device")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]):
        got = [pred.predict_videos(r, backend="device") for r in requests]
        spans = read_spans()
    packs = [e["counts"] for e in spans if e["name"] == "serving.pack"][-4:]
    h2d = [e["counts"] for e in spans if e["name"] == "serving.h2d"][-4:]
    assert [c["waited"] for c in packs] == [0, 0, 0, 0]
    assert all(c["pinned_bytes"] == c["bytes"] > 0 for c in h2d)
    assert [p["bytes"] for p in packs] == [c["bytes"] for c in h2d]
    slots = [s for ring in pred._staging._slots.values() for s in ring]
    assert len(slots) == 2 and all(s.buf.is_pinned() for s in slots)
    serialised(pred, monkeypatch)
    want = [pred.predict_videos(r, backend="device") for r in requests]
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)


@pytest.mark.cuda
def test_cuda_staged_chunks_behind_a_busy_stream(monkeypatch):
    """Chunks of 4 GOPs queued behind a sleeping stream: the third fill
    waits for the first chunk's copies, and every score equals the
    serialised route's."""
    from torch.profiler import ProfilerActivity, profile

    from dmcnet_tpu_torch.utils.profiling import read_spans

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    pred = cuda_predictor()
    paths = [f"v{i}" for i in range(4)]
    pred.predict_videos(paths, backend="device", chunk_gops=4)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]):
        torch.cuda._sleep(500_000_000)
        got = pred.predict_videos(paths, backend="device", chunk_gops=4)
        spans = read_spans()
    waited = [e["counts"]["waited"] for e in spans
              if e["name"] == "serving.pack"][-10:]
    assert waited[:2] == [0, 0] and 1 in waited[2:]
    serialised(pred, monkeypatch)
    want = pred.predict_videos(paths, backend="device", chunk_gops=4)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
