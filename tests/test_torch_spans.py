"""The port's spans (`utils/profiling.span`): nothing recorded without a
profiler; under one, the log's nesting, roots and counts, each entry
inside its own `dmc.*` kineto event; and the serving and I3D evaluation
paths, traced and untraced, giving the same outputs bit for bit while the
traced run records their stages in order.  CPU only; the CUDA events of
`span(device=...)` are read on the card by the benchmark's readers."""

import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from dmcnet_tpu_torch.utils import profiling
from dmcnet_tpu_torch.utils.profiling import read_spans, span

# how far an entry may stand outside its kineto event on the CPU
CLOCK_TOL_NS = 200_000
CHUNK = ["serving.pack", "serving.h2d", "serving.enqueue",
         "serving.generator", "serving.classifier"]
# the unfolded classifier's stages, inside `serving.classifier`
RESNET = ["resnet.layer1", "resnet.layer2", "resnet.layer3", "resnet.layer4"]


@pytest.fixture(autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def traced(fn):
    """-> (fn's result, the log entries it made, its `dmc.*` kineto events
    as [(name, start_ns, end_ns)] by start), fn run under a CPU
    profiler."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        t0 = time.time_ns()
        out = fn()
        t1 = time.time_ns()
    events = sorted((e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
                    for e in prof.profiler.kineto_results.events()
                    if e.name().startswith("dmc."))
    return out, read_spans(t0, t1), events


def test_no_profiler_records_nothing():
    before = len(read_spans())
    ctx = span("a", device="cpu", n=3)
    assert ctx is span("b") is profiling._OFF
    with ctx:
        with span("b"):
            pass
    assert len(read_spans()) == before


def test_spans_nest_with_parents_roots_and_counts():
    def work():
        with span("outer", rows=2):
            with span("mid"):
                with span("inner", bytes=10, kept=3):
                    torch.ones(8).sum()
            with span("mid"):
                pass
        with span("second"):
            pass

    _, log, _ = traced(work)
    assert [e["name"] for e in log] == ["outer", "mid", "inner", "mid",
                                        "second"]
    outer, mid, inner, mid2, second = log
    assert outer["parent"] is None and outer["root"] == outer["index"]
    assert mid["parent"] == mid2["parent"] == outer["index"]
    assert inner["parent"] == mid["index"]
    assert {e["root"] for e in log[:4]} == {outer["index"]}
    assert second["parent"] is None and second["root"] == second["index"]
    assert outer["counts"] == {"rows": 2}
    assert inner["counts"] == {"bytes": 10, "kept": 3}
    assert mid["counts"] == {}
    assert all(e["device_ms"] is None for e in log)
    assert all(a["start_ns"] <= b["start_ns"] and b["end_ns"] <= a["end_ns"]
               for a, b in [(outer, mid), (mid, inner), (outer, mid2)])


def test_another_thread_starts_its_own_root():
    def work():
        seen = {}

        def worker():
            with span("worker"):
                pass

        with span("main"):
            t = threading.Thread(target=worker)
            t.start()
            t.join(timeout=30)
            seen["alive"] = t.is_alive()
        return seen

    seen, log, _ = traced(work)
    assert not seen["alive"]
    by = {e["name"]: e for e in log}
    assert by["worker"]["parent"] is None
    assert by["worker"]["root"] == by["worker"]["index"]


def test_entries_lie_within_their_kineto_events():
    def work():
        for i in range(20):
            with span("outer"):
                with span("inner", i=i):
                    torch.ones(64, 64) @ torch.ones(64, 64)

    _, log, events = traced(work)
    assert len(log) == len(events) == 40
    by_name = {}
    for name, a, b in events:
        by_name.setdefault(name, []).append((a, b))
    for name in ("outer", "inner"):
        mine = [e for e in log if e["name"] == name]
        assert len(mine) == len(by_name["dmc." + name])
        for e, (a, b) in zip(mine, by_name["dmc." + name]):
            assert a - CLOCK_TOL_NS <= e["start_ns"] <= e["end_ns"] \
                <= b + CLOCK_TOL_NS, (name, e, a, b)


# --- the serving path ----------------------------------------------------

NUM_CLASS, HW = 5, 32


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    from dmcnet_tpu_torch.codec.mpeg4 import encode_mpeg4

    d = tmp_path_factory.mktemp("span_clips")
    paths = []
    for i, n in enumerate([50, 14]):
        rng = np.random.default_rng(40 + i)
        canvas = (rng.integers(0, 256, size=(160, 240, 3)) // 8 * 8) \
            .astype(np.uint8)
        frames = np.stack([canvas[20 + k:84 + k, 20 + 2 * k:116 + 2 * k]
                           for k in range(n)])
        p = str(d / f"v{i}.avi")
        encode_mpeg4(p, frames, gop_size=12, bit_rate=2_000_000)
        paths.append(p)
    return paths


def expected_device_path(paths, chunk_gops, unfolded=False):
    """The span names of one device-path `predict_videos` call: a gather a
    video, a chunk's five spans each time `chunk_gops` GOPs of two frames
    or more have gathered (and, `unfolded`, the ResNet's four stages
    inside the classifier), the ragged tail, then readback and reduce."""
    from dmcnet_tpu_torch.codec.mpeg4 import VideoReader

    chunk = CHUNK + (RESNET if unfolded else [])
    names, buffered = ["serving.request"], 0
    for p in paths:
        names.append("serving.gather")
        r = VideoReader(p)
        buffered += sum(r.gop_len(g) >= 2 for g in range(r.num_gops))
        while buffered >= chunk_gops:
            names += chunk
            buffered -= chunk_gops
    if buffered:
        names += chunk
    return names + ["serving.readback", "serving.reduce"]


def check_request_tree(log):
    """One root request; stages are its children; the generator and the
    classifier run inside an enqueue, the ResNet's stages inside the
    classifier."""
    request = log[0]
    assert request["name"] == "serving.request"
    assert request["parent"] is None
    by_index = {e["index"]: e for e in log}
    for e in log[1:]:
        assert e["root"] == request["index"], e
        if e["name"] in ("serving.generator", "serving.classifier"):
            assert by_index[e["parent"]]["name"] == "serving.enqueue", e
        elif e["name"] in RESNET:
            assert by_index[e["parent"]]["name"] == "serving.classifier", e
        else:
            assert e["parent"] == request["index"], e


def copied_bytes(pred):
    """-> a list that gathers the bytes of each `pred._to_device` call."""
    sent, to_device = [], pred._to_device

    def counted(arrays, device=None):
        sent.append(sum(a.nbytes for a in arrays))
        return to_device(arrays, device)

    pred._to_device = counted
    return sent


def staged_bytes(pred):
    """-> a list that gathers the bytes of each `pred._stage` call's real
    rows, as they reach the device."""
    sent, stage = [], pred._stage

    def counted(rows, *args):
        out = stage(rows, *args)
        sent.append(sum(t[:len(rows)].nbytes for t in out))
        return out

    pred._stage = counted
    return sent


@pytest.mark.parametrize("pack", [True, False], ids=["pack", "no-pack"])
def test_predict_videos_traced_is_bit_identical(clips, pack):
    from dmcnet_tpu_torch.serving import DMCPredictor

    pred = DMCPredictor(num_class=NUM_CLASS, input_size=HW, pack=pack,
                        device="cpu")
    paths = clips + clips[:1]

    def run():
        return pred.predict_videos(paths, chunk_gops=4, backend="device")

    plain = run()
    sent = staged_bytes(pred)
    got, log, events = traced(run)
    for a, b in zip(plain, got):
        np.testing.assert_array_equal(a, b)
    want = expected_device_path(clips, 4, unfolded=not pack)
    assert want.count("serving.pack") == 2
    assert [e["name"] for e in log] == want
    check_request_tree(log)
    assert len(events) == len(log)
    # the CPU's staging buffers are not pinned, and its copies have
    # completed before the next fill
    counts = {k: [e["counts"] for e in log if e["name"] == k]
              for k in ("serving.pack", "serving.h2d")}
    assert counts["serving.pack"] == [{"bytes": n, "waited": 0}
                                      for n in sent]
    assert counts["serving.h2d"] == [{"bytes": n, "pinned_bytes": 0}
                                     for n in sent]


def test_predict_videos_host_path_spans(clips):
    from dmcnet_tpu_torch.serving import DMCPredictor

    pred = DMCPredictor(num_class=NUM_CLASS, input_size=HW, device="cpu")

    def run():
        return pred.predict_videos(clips, backend="host")

    plain = run()
    sent = copied_bytes(pred)
    got, log, _ = traced(run)
    for a, b in zip(plain, got):
        np.testing.assert_array_equal(a, b)
    video = ["serving.gather", "serving.h2d", "serving.enqueue",
             "serving.generator", "serving.classifier", "serving.readback",
             "serving.reduce"]
    assert [e["name"] for e in log] == ["serving.request"] \
        + video * len(clips) + ["serving.readback", "serving.reduce"]
    check_request_tree(log)
    assert [e["counts"] for e in log if e["name"] == "serving.h2d"] == \
        [{"bytes": n, "pinned_bytes": 0} for n in sent]


# --- the I3D evaluation step ---------------------------------------------

def _i3d(remat=False):
    from dmcnet_tpu_torch.models.i3d import I3D

    torch.manual_seed(0)
    return I3D(num_classes=NUM_CLASS, modality="flow+mp4",
               arch_estimator="DenseNetTiny", input_size=HW, remat=remat)


def test_i3d_eval_step_traced_is_bit_identical():
    from dmcnet_tpu_torch.data import transforms as T
    from dmcnet_tpu_torch.data.video_iter import i3d_augment_batch
    from dmcnet_tpu_torch.train.engine_i3d import make_i3d_eval_step

    b, t, h, w, c = 1, 4, 40, 48, 7
    frames = np.random.default_rng(3).integers(
        0, 256, (b, t, h, w, c)).astype(np.uint8)
    sh, sw, th, tw = T.crop_spec_to_scale_translate(
        (h - HW) // 2, (w - HW) // 2, HW, HW, HW)
    batch = {"frames": frames, "scales": np.asarray([[sh, sw]], np.float32),
             "translations": np.asarray([[th, tw]], np.float32),
             "flips": np.zeros(1, bool), "label": np.zeros(1, np.int32)}
    step = make_i3d_eval_step(_i3d())

    def run():
        return step(i3d_augment_batch(batch, ds_factor=16, input_size=HW,
                                      device="cpu"))["logits"].numpy()

    plain = run()
    got, log, events = traced(run)
    np.testing.assert_array_equal(plain, got)
    assert [e["name"] for e in log] == ["data.i3d_h2d", "i3d.generator",
                                        "i3d.backbone"]
    # the centre crop's box: the crop and one pixel more on each side
    assert log[0]["counts"] == {"bytes": b * t * (HW + 2) ** 2 * c,
                                "kept": b * t * HW * HW * c, "pinned": 0}
    assert all(e["parent"] is None for e in log)
    assert len(events) == 3


def test_i3d_remat_recompute_is_outside_the_spans():
    """Under `remat` the backward recomputes inside the generator and the
    Mixed blocks, not through `I3D.forward`: each span is logged once."""
    net = _i3d(remat=True).train()
    x = torch.randn(2, 5, 4, HW, HW, requires_grad=True)

    def run():
        net(x, "logit").sum().backward()

    _, log, _ = traced(run)
    assert [e["name"] for e in log] == ["i3d.generator", "i3d.backbone"]


# --- plain TSN scoring (`cli.test --plain 1`) -----------------------------

def test_plain_tsn_scoring_traced_is_bit_identical():
    """`cli.test.score_video` on a ResNet-152 `PlainTSN`, one video of 1
    segment x 10 crops: nothing logged without a profiler; under one the
    canvas's copy (`bytes`, its u8 size), then the backbone (`clips`)
    around the ResNet's four stages (`blocks` 3, 8, 36, 3, each block
    `fused`: eval mode, grad off)."""
    from dmcnet_tpu_torch.cli.test import score_video
    from dmcnet_tpu_torch.data import transforms as T
    from dmcnet_tpu_torch.models.tsn import PlainTSN

    s, h, w, c = 1, 40, 48, 8
    frames = np.random.default_rng(4).integers(
        0, 256, (1, s, h, w, c)).astype(np.uint8)
    specs = T.oversample_specs(h, w, HW * 256 // 224, HW)
    raw = {"frames": frames,
           "scales": np.asarray([[x[:2] for x in specs]], np.float32),
           "translations": np.asarray([[x[2:4] for x in specs]], np.float32),
           "flips": np.asarray([[x[4] for x in specs]]),
           "label": np.zeros(1, np.int32)}
    torch.manual_seed(0)
    net = PlainTSN(NUM_CLASS, arch="resnet152", in_channels=3).eval()
    aug = dict(representation="iframe", input_size=HW, negate_channels=(0,),
               device="cpu")

    def run():
        return score_video(net, raw, aug, "mv")["scores"].numpy()

    before = len(read_spans())
    plain = run()
    assert len(read_spans()) == before   # no profiler, no log
    got, log, events = traced(run)
    np.testing.assert_array_equal(plain, got)
    assert [e["name"] for e in log] == ["data.eval_h2d", "tsn.backbone"] \
        + RESNET
    assert log[0]["counts"] == {"bytes": frames.nbytes}
    assert log[1]["counts"] == {"clips": 10 * s}
    assert [e["counts"] for e in log[2:]] == [{"blocks": n, "fused": n}
                                              for n in (3, 8, 36, 3)]
    assert log[0]["parent"] is log[1]["parent"] is None
    assert all(e["parent"] == log[1]["index"] for e in log[2:])
    assert len(events) == 6


@pytest.mark.cuda
def test_device_span_reads_its_stream_time():
    """On a card: the span's two events time the work queued inside it,
    no longer than events recorded around the whole `with` block."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x = torch.randn(2048, 2048, device="cuda")
    outer = (torch.cuda.Event(enable_timing=True),
             torch.cuda.Event(enable_timing=True))

    def work():
        outer[0].record()
        with span("mm", device=x.device):
            for _ in range(20):
                y = x @ x
        outer[1].record()
        return y

    _, log, _ = traced(work)
    torch.cuda.synchronize()
    (e,) = log
    assert 0 < e["device_ms"] <= outer[0].elapsed_time(outer[1]) + 1e-3
