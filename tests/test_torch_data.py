"""The port's data layer (dmcnet_tpu_torch/data) against the JAX package's:
host samplers, lists and color jitter are equal given the same seed; the
dataset and batch assembler give the same uint8 batches on encoded clips;
crops, blockify and normalization on the CPU agree within float32
tolerances (atol 1e-3 in the 0..255 domain, 5e-5 after normalization: the
two frameworks sum the resampling products in different orders)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_train import _two_torch_threads  # noqa: F401

from dmcnet_tpu.data import color as jcolor
from dmcnet_tpu.data import dmc_dataset as jds
from dmcnet_tpu.data import lists as jlists
from dmcnet_tpu.data import loader as jloader
from dmcnet_tpu.data import sampling as jsamp
from dmcnet_tpu.data import transforms as JT
from dmcnet_tpu_torch.codec.mpeg4 import encode_mpeg4
from dmcnet_tpu_torch.data import color as tcolor
from dmcnet_tpu_torch.data import dmc_dataset as tds
from dmcnet_tpu_torch.data import lists as tlists
from dmcnet_tpu_torch.data import loader as tloader
from dmcnet_tpu_torch.data import sampling as tsamp
from dmcnet_tpu_torch.data import transforms as TT

ATOL_U8 = 1e-3      # 0..255 domain, float32
ATOL_NORM = 5e-5    # after /255 and normalization, float32


def _to_torch(x):
    """(B, S, H, W, C) numpy -> (B, S, C, H, W) tensor."""
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 1, 4, 2, 3)


def _to_jax_layout(t):
    return t.permute(0, 1, 3, 4, 2).numpy()


def test_crop_spec_samplers_match():
    for seed in range(40):
        for h, w, size in ((64, 96, 48), (256, 340, 224), (90, 60, 64)):
            for kwargs in ({}, {"fix_crop": True},
                           {"fix_crop": True, "more_fix_crop": False},
                           {"scales": (1, .875, .75, .66)}):
                a = TT.sample_multiscale_crop(np.random.default_rng(seed), h,
                                              w, size, **kwargs)
                b = JT.sample_multiscale_crop(np.random.default_rng(seed), h,
                                              w, size, **kwargs)
                assert a == b
                assert TT.crop_spec_to_scale_translate(*a, size) == \
                    JT.crop_spec_to_scale_translate(*b, size)
            assert TT.center_crop_spec(h, w, 74, 64) == \
                JT.center_crop_spec(h, w, 74, 64)
            assert TT.oversample_specs(h, w, 74, 64) == \
                JT.oversample_specs(h, w, 74, 64)


def test_frame_index_matches():
    for rep in ("mv", "residual", "iframe"):
        for n in (13, 36, 250):
            for segs in (1, 3, 5):
                for seg in range(segs):
                    assert tsamp.get_seg_range(n, segs, seg, rep) == \
                        jsamp.get_seg_range(n, segs, seg, rep)
                    assert tsamp.test_frame_index(n, segs, seg, rep) == \
                        jsamp.test_frame_index(n, segs, seg, rep)
                    for seed in range(5):
                        assert tsamp.train_frame_index(
                            n, segs, seg, rep, np.random.default_rng(seed)) \
                            == jsamp.train_frame_index(
                                n, segs, seg, rep,
                                np.random.default_rng(seed))


def test_load_video_list_matches(tmp_path):
    lst = tmp_path / "list.txt"
    lst.write_text("cls_a/v1.avi 0 3\n\ncls_b/v2.avi 0 7\n")
    flow = tmp_path / "flow" / "cls_a" / "v1"
    os.makedirs(flow)
    for i in range(9):  # 9 files -> 3 frames of flow
        (flow / f"f{i}").write_text("")
    counts = {"cls_a/v1.mp4": 40, "cls_b/v2.mp4": 20}

    def nf(path):
        return counts[os.path.relpath(path, tmp_path / "videos")]

    for flow_root in (None, str(tmp_path / "flow")):
        got = tlists.load_video_list(lst, str(tmp_path / "videos"),
                                     flow_root, num_frames_fn=nf)
        want = jlists.load_video_list(lst, str(tmp_path / "videos"),
                                      flow_root, num_frames_fn=nf)
        assert [vars(g) for g in got] == [vars(w) for w in want]
    assert got[0].num_frames == 3 and got[1].num_frames == 20
    assert tlists.video_path_to_flow_path("/f", "/d/c/v.mp4") == \
        jlists.video_path_to_flow_path("/f", "/d/c/v.mp4")


def test_color_aug_matches():
    img = np.random.default_rng(0).integers(0, 256, size=(24, 32, 3),
                                            dtype=np.uint8)
    np.testing.assert_array_equal(tcolor.bgr_to_hls(img),
                                  jcolor.bgr_to_hls(img))
    np.testing.assert_array_equal(tcolor.hls_to_bgr(tcolor.bgr_to_hls(img)),
                                  jcolor.hls_to_bgr(jcolor.bgr_to_hls(img)))
    for seed in range(4):
        np.testing.assert_array_equal(
            tcolor.color_aug(img, np.random.default_rng(seed)),
            jcolor.color_aug(img, np.random.default_rng(seed)))


def _specs(kind, b, h, w, size):
    """(scales (B, 2), translations (B, 2), flips (B,), vflips) of one kind
    of crop spec."""
    rng = np.random.default_rng(len(kind))
    if kind == "train":
        specs = [TT.crop_spec_to_scale_translate(
            *TT.sample_multiscale_crop(rng, h, w, size), size)
            for _ in range(b)]
        flips = rng.random(b) < 0.5
    elif kind == "center":
        specs = [TT.center_crop_spec(h, w, size + 10, size)] * b
        flips = np.zeros(b, bool)
    else:  # one crop of each GroupOverSample position per sample
        over = TT.oversample_specs(h, w, size + 10, size)
        specs = [over[(3 * i) % 10][:4] for i in range(b)]
        flips = np.array([over[(3 * i) % 10][4] for i in range(b)])
    scales = np.array([s[:2] for s in specs], np.float32)
    trans = np.array([s[2:] for s in specs], np.float32)
    vflips = rng.random(b) < 0.5 if kind == "train" else None
    return scales, trans, flips, vflips


@pytest.mark.parametrize("kind", ["train", "center", "oversample"])
def test_apply_crops_matches(kind):
    b, s, h, w, c, size = 4, 2, 40, 56, 7, 32
    frames = np.random.default_rng(1).integers(
        0, 256, size=(b, s, h, w, c)).astype(np.float32)
    scales, trans, flips, vflips = _specs(kind, b, h, w, size)
    for neg in ((0, 2), (0,)):
        want = JT.apply_crops(
            jnp.asarray(frames), jnp.asarray(scales), jnp.asarray(trans),
            jnp.asarray(flips), out_size=size, negate_channels=neg,
            vflips=None if vflips is None else jnp.asarray(vflips))
        got = TT.apply_crops(_to_torch(frames), scales, trans, flips,
                             out_size=size, negate_channels=neg,
                             vflips=vflips)
        assert tuple(got.shape) == (b, s, c, size, size)
        np.testing.assert_allclose(_to_jax_layout(got), np.asarray(want),
                                   rtol=0, atol=ATOL_U8)


@pytest.mark.parametrize("upsample_interp", [False, True])
def test_blockify_flow_matches(upsample_interp):
    flow = np.random.default_rng(2).normal(
        size=(2, 3, 16, 24, 2)).astype(np.float32)
    for factor in (0, 2, 4, 8):
        want = JT.blockify_flow(jnp.asarray(flow), factor, upsample_interp)
        got = TT.blockify_flow(_to_torch(flow), factor, upsample_interp)
        np.testing.assert_allclose(_to_jax_layout(got), np.asarray(want),
                                   rtol=0, atol=ATOL_NORM)


@pytest.mark.parametrize("rep,factor,interp", [
    ("mv", 0, False), ("mv", 4, True), ("iframe", 2, False)])
def test_normalize_group_matches(rep, factor, interp):
    c = 8 if rep == "iframe" else 7
    frames = np.random.default_rng(3).integers(
        0, 256, size=(2, 3, 16, 16, c)).astype(np.float32)
    want = JT.normalize_group(jnp.asarray(frames), rep, factor, interp)
    got = TT.normalize_group(_to_torch(frames), rep, factor, interp)
    for k in ("flow", "mv", "residual"):
        np.testing.assert_allclose(_to_jax_layout(got[k]),
                                   np.asarray(want[k]), rtol=0,
                                   atol=ATOL_NORM)
    np.testing.assert_allclose(TT.clip_and_scale(np.arange(-3, 4)),
                               JT.clip_and_scale(np.arange(-3, 4)))


H, W, NF = 64, 96, 26


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    from PIL import Image

    root = tmp_path_factory.mktemp("torch_corpus")
    rng = np.random.default_rng(4)
    items_t, items_j = [], []
    for v in range(2):
        path = root / f"vid{v}.avi"
        canvas = (rng.integers(0, 256, size=(H + 120, W + 120, 3))
                  // 8 * 8).astype(np.uint8)
        encode_mpeg4(path, np.stack([canvas[30 + i:30 + i + H,
                                            30 + 2 * i:30 + 2 * i + W]
                                     for i in range(NF)]),
                     gop_size=12, bit_rate=2_000_000)
        flow_dir = None
        if v == 0:
            flow_dir = root / "flow0"
            os.makedirs(flow_dir)
            for i in range(1, NF + 1):
                for ax in "xy":
                    Image.fromarray(rng.integers(0, 256, size=(H, W),
                                                 dtype=np.uint8),
                                    mode="L").save(
                        flow_dir / f"flow_{ax}_{i:05d}.jpg")
            flow_dir = str(flow_dir)
        items_t.append(tlists.VideoItem(str(path), v, NF, flow_dir))
        items_j.append(jlists.VideoItem(str(path), v, NF, flow_dir))
    return items_t, items_j


def _datasets(corpus, rep, is_train, segs=3):
    kw = dict(num_segments=segs, is_train=is_train, accumulate=True,
              mv_minmaxnorm=1, seed=5)
    return (tds.CoviarDataset(None, None, None, rep, items=corpus[0], **kw),
            jds.CoviarDataset(None, None, None, rep, items=corpus[1], **kw))


def _assert_batches_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in got:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("rep", ["mv", "iframe"])
def test_train_batches_match(corpus, rep):
    ours, ref = _datasets(corpus, rep, True)
    a_t = tds.BatchAssembler(ours, input_size=48, scale_size=56, seed=2)
    a_j = jds.BatchAssembler(ref, input_size=48, scale_size=56, seed=2)
    neg = a_t.negate_channels
    assert neg == a_j.negate_channels and a_t.scales == a_j.scales
    for _ in range(2):
        got, want = a_t.train_batch(range(4)), a_j.train_batch(range(4))
        _assert_batches_equal(got, want)
    parts_t = tds.augment_train_batch(got, rep, input_size=48,
                                      negate_channels=neg, device="cpu")
    parts_j = jds.augment_train_batch(want, rep, input_size=48,
                                      negate_channels=neg)
    c_mv = 3 if rep == "iframe" else 2
    assert tuple(parts_t["mv"].shape) == (4, 3, c_mv, 48, 48)
    for k in ("flow", "mv", "residual"):
        np.testing.assert_allclose(_to_jax_layout(parts_t[k]),
                                   np.asarray(parts_j[k]), rtol=0,
                                   atol=ATOL_NORM, err_msg=k)
    np.testing.assert_array_equal(parts_t["label"].numpy(),
                                  np.asarray(parts_j["label"]))


@pytest.mark.parametrize("crops", [1, 10])
def test_eval_batches_match(corpus, crops):
    ours, ref = _datasets(corpus, "mv", False, segs=2)
    got = tds.BatchAssembler(ours, input_size=48, scale_size=56,
                             test_crops=crops).eval_batch([0, 1, 1])
    want = jds.BatchAssembler(ref, input_size=48, scale_size=56,
                              test_crops=crops).eval_batch([0, 1, 1])
    _assert_batches_equal(got, want)
    parts_t = tds.augment_eval_batch(got, "mv", input_size=48, device="cpu")
    parts_j = jds.augment_eval_batch(want, "mv", input_size=48)
    assert tuple(parts_t["mv"].shape) == (3, 2 * crops, 2, 48, 48)
    for k in ("flow", "mv", "residual"):
        np.testing.assert_allclose(_to_jax_layout(parts_t[k]),
                                   np.asarray(parts_j[k]), rtol=0,
                                   atol=ATOL_NORM, err_msg=k)


def test_garbage_file_zero_fills_like_jax(tmp_path, capsys):
    bad = tmp_path / "garbage.avi"
    bad.write_bytes(b"not a video" * 100)
    ours = tds.CoviarDataset(None, None, None, "mv", num_segments=2,
                             is_train=False,
                             items=[tlists.VideoItem(str(bad), 4, 30)])
    ref = jds.CoviarDataset(None, None, None, "mv", num_segments=2,
                            is_train=False,
                            items=[jlists.VideoItem(str(bad), 4, 30)])
    got, want = ours[0], ref[0]
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:] == (4, (256, 256))
    assert (got[0][..., 2:] == 128).all() and (got[0][..., :2] == 128).all()
    assert capsys.readouterr().out.count("zero-filling") == 2  # once each


def test_encode_u8_and_loader_match():
    arr = np.random.default_rng(6).integers(-300, 300, size=(5, 7))
    for bound in (None, 20):
        np.testing.assert_array_equal(tds._encode_u8(arr, bound),
                                      jds._encode_u8(arr, bound))
    assert tloader.pad_indices(3, 6, 5) == jloader.pad_indices(3, 6, 5)
    with pytest.raises(ValueError):
        tloader.pad_indices(2, 2, 4)
    for ordered in (True, False):
        got = list(tloader.PrefetchLoader(lambda i: i * i, 12, workers=3,
                                          prefetch=2, ordered=ordered))
        assert sorted(got) == [i * i for i in range(12)]
        if ordered:
            assert got == [i * i for i in range(12)]

    def boom(i):
        if i == 3:
            raise KeyError(i)
        return i

    with pytest.raises(KeyError):
        list(tloader.PrefetchLoader(boom, 6, workers=2))
