"""The port's I3D data layer (dmcnet_tpu_torch/data: `load_i3d_list`, the
clip samplers, `random_rgb` / `random_hls`, video_iter.py,
iterator_factory.py) against the JAX package's on the CPU: host samplers,
jitters, uint8 clips and batch specs are equal given the same seeds; crops
and normalization agree within float32 tolerances (atol 1e-3 in the 0..255
domain, 5e-5 after normalization: the two frameworks sum the resampling
products in different orders).

The JAX package reads the MV and residual of its res and flow+mp4 clips at
GOP position 0 (the I-frame's zeros) and repeats each GOP's I-frame in its
rgb clips, a fault the port fixes (`VideoClipDataset.gop_position`); the
comparisons give the JAX dataset the reference's positions through
`fix_jax_gop_positions`, and `test_port_reads_motion_where_jax_reads_the_
iframe` pins the fault.

The JAX package is imported inside the helpers: the `cuda`-marked twin at
the end needs neither it nor flax.
"""

import os
import types

import numpy as np
import pytest
import torch
from PIL import Image
from test_torch_train import _two_torch_threads  # noqa: F401

from dmcnet_tpu_torch.codec.mpeg4 import NativeCodecUnavailable, encode_mpeg4
from dmcnet_tpu_torch.data import color as tcolor
from dmcnet_tpu_torch.data import iterator_factory as tfactory
from dmcnet_tpu_torch.data import lists as tlists
from dmcnet_tpu_torch.data import sampling as tsamp
from dmcnet_tpu_torch.data import transforms as TT
from dmcnet_tpu_torch.data import video_iter as tvi

ATOL_U8 = 1e-3
ATOL_NORM = 5e-5
NF, H, W, SIZE = 26, 64, 80, 48
MODALITY_CASES = [("rgb", 1), ("I", 1), ("flow", 1), ("mv", 0), ("mv", 1),
                  ("res", 0), ("res", 1), ("flow+mp4", 0), ("flow+mp4", 1)]


@pytest.fixture(scope="module")
def J():
    """The JAX package's data modules."""
    from dmcnet_tpu.data import color, iterator_factory, lists, sampling
    from dmcnet_tpu.data import transforms, video_iter
    return types.SimpleNamespace(color=color, factory=iterator_factory,
                                 lists=lists, samp=sampling, T=transforms,
                                 vi=video_iter)


def panning_canvas(rng, h, w):
    """A canvas of random 8x8 blocks: panned across, it encodes as P-frames
    with motion (pixel noise makes the encoder code every frame as an
    I-frame, whose MV and residual are zero)."""
    small = rng.integers(0, 256, size=(h // 8 + 1, w // 8 + 1, 3))
    return np.kron(small, np.ones((8, 8, 1)))[:h, :w].astype(np.uint8)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Three panning 26-frame 64x80 MPEG-4 clips (GOP 12) under
    videos/cls/, flow JPEGs for the first, and the I3D list files."""
    root = tmp_path_factory.mktemp("i3d_data")
    os.makedirs(root / "videos" / "cls")
    os.makedirs(root / "raw" / "list_cvt")
    rng = np.random.default_rng(11)
    lines = []
    for v in range(3):
        canvas = panning_canvas(rng, H + 60, W + 80)
        encode_mpeg4(root / "videos" / "cls" / f"v{v}.mp4",
                     np.stack([canvas[20 + i:20 + i + H,
                                      20 + 2 * i:20 + 2 * i + W]
                               for i in range(NF)]),
                     gop_size=12, bit_rate=2_000_000)
        lines.append(f"{v} {v + 2} cls/v{v}.avi")
    flow = root / "flow" / "cls" / "v0"
    os.makedirs(flow)
    for i in range(1, NF + 1):
        for ax in "xy":
            Image.fromarray(rng.integers(0, 256, size=(H, W), dtype=np.uint8),
                            mode="L").save(flow / f"flow_{ax}_{i:05d}.jpg")
    for subset in ("train", "test"):
        (root / "raw" / "list_cvt" / f"hmdb51_split1_{subset}.txt") \
            .write_text("\n".join(lines) + "\n")
    return root


def fix_jax_gop_positions(monkeypatch, jax_video_iter):
    """The JAX dataset's `get_gop_pos_i3d`, given the flavour of the frames
    each modality reads (as `VideoClipDataset.gop_position` of the port)
    instead of the modality's name."""
    orig = jax_video_iter.get_gop_pos_i3d

    def positions(frame_idx, modality, gop_size=12):
        if modality == "rgb":
            return divmod(frame_idx, gop_size)
        flavour = {"res": "residual", "flow+mp4": "mv"}.get(modality,
                                                             modality)
        return orig(frame_idx, flavour, gop_size)

    monkeypatch.setattr(jax_video_iter, "get_gop_pos_i3d", positions)


def _items(J, corpus, flow=True):
    mk = dict(video_prefix=str(corpus / "videos"),
              flow_prefix=str(corpus / "flow") if flow else None,
              num_frames_fn=lambda path: NF)
    path = tfactory.list_path(str(corpus), "HMDB51", 1, "test")
    got = tfactory._items_from_list(path, **mk)
    want = J.factory._items_from_list(path, **mk)
    assert [tuple(vars(i).values()) for i in got] == \
        [tuple(vars(i).values()) for i in want]
    # the flow directory exists for v0 only: the others fall back to 128
    return ([tlists.VideoItem(i.path, i.label, i.num_frames,
                              i.flow_path if "v0" in i.path else None)
             for i in got],
            [J.lists.VideoItem(i.path, i.label, i.num_frames,
                               i.flow_path if "v0" in i.path else None)
             for i in want])


def _datasets(J, corpus, modality, accumulate, seed=3, num=8):
    items_t, items_j = _items(J, corpus)
    kw = dict(modality=modality, accumulate=bool(accumulate),
              mv_minmaxnorm=True, seed=seed)
    return (tvi.VideoClipDataset(items_t, tsamp.RandomSampling(num, seed=seed),
                                 **kw),
            J.vi.VideoClipDataset(items_j,
                                  J.samp.RandomSampling(num, seed=seed), **kw))


# --- host samplers, lists, jitters ------------------------------------------

def test_gop_pos_and_samplers_match(J):
    for rep in ("mv", "residual", "flow", "rgb", "I", "flow+mp4"):
        for f in range(40):
            assert tsamp.get_gop_pos_i3d(f, rep) == \
                J.samp.get_gop_pos_i3d(f, rep)
    for seed in range(6):
        for num, interval, speed in ((8, 1, (1.0, 1.0)),
                                     (16, [1, 2], (0.5, 2.0)),
                                     (1, 2, (1.0, 1.0)), (250, 1, (1.0, 1.0))):
            a = tsamp.RandomSampling(num, interval, speed, seed=seed)
            b = J.samp.RandomSampling(num, interval, speed, seed=seed)
            for range_max in (24, 250, 300, 5):
                assert a.sampling(range_max) == b.sampling(range_max)
        for shuffle, fix in ((False, False), (True, True), (True, False)):
            a = tsamp.SequentialSampling(8, 2, shuffle, fix, seed=seed)
            b = J.samp.SequentialSampling(8, 2, shuffle, fix, seed=seed)
            for call in range(6):
                for range_max in (60, 10):
                    assert a.sampling(range_max, v_id=call % 3) == \
                        b.sampling(range_max, v_id=call % 3)


def test_load_i3d_list_matches(J, tmp_path):
    lst = tmp_path / "list.txt"
    lst.write_text("1 4 cls_a/v1.avi\n\n22 0 cls_b/v2.avi\n")
    assert tlists.load_i3d_list(str(lst)) == J.lists.load_i3d_list(str(lst)) \
        == [(1, 4, "cls_a/v1.avi"), (22, 0, "cls_b/v2.avi")]


def test_random_hls_and_rgb_match(J):
    img = np.random.default_rng(2).integers(0, 256, size=(24, 20, 3),
                                            dtype=np.uint8)
    for seed in range(8):
        for fn in ("random_hls", "random_rgb"):
            got = getattr(tcolor, fn)(img, np.random.default_rng(seed))
            want = getattr(J.color, fn)(img, np.random.default_rng(seed))
            np.testing.assert_array_equal(got, want, err_msg=fn)


# --- clips and batches -----------------------------------------------------

@pytest.mark.parametrize("modality,accumulate", MODALITY_CASES)
def test_clips_match(J, corpus, modality, accumulate, monkeypatch):
    """uint8 clips bit-equal, in every modality, from the same seeds."""
    fix_jax_gop_positions(monkeypatch, J.vi)
    ours, ref = _datasets(J, corpus, modality, accumulate)
    for index in (0, 1, 2, 0):
        (got, gl), (want, wl) = ours[index], ref[index]
        assert got.dtype == np.uint8 and got.shape == want.shape == \
            (8, H, W, tvi._CHANNELS[modality])
        np.testing.assert_array_equal(got, want)
        assert gl == wl == index + 2
        if modality in ("mv", "res", "flow+mp4"):  # motion, not zeros
            assert got[..., -1].std() > 1


def test_port_reads_motion_where_jax_reads_the_iframe(J, corpus):
    """Unpatched, the JAX package's flow+mp4 clips carry the I-frame's zero
    MV and residual (128 after encoding) in every frame; the port's carry
    each frame's own (position 0 read at 1)."""
    ours, ref = _datasets(J, corpus, "flow+mp4", 0)
    got, want = ours[1][0], ref[1][0]
    assert (want[..., 2:] == 128).all()
    assert (got[..., 2:4] != 128).any() and (got[..., 4:] != 128).any()
    np.testing.assert_array_equal(got[..., :2], want[..., :2])


@pytest.mark.parametrize("modality,is_train", [
    ("flow+mp4", False), ("flow+mp4", True), ("rgb", True)])
def test_batch_specs_match(J, corpus, modality, is_train, monkeypatch):
    """I3DBatchAssembler: the same canvases and crop/flip specs at one seed
    (train: random crops and flips; rgb adds the random scale and the HLS
    jitter).  The port leaves out the vertical flip, which no caller of
    either package turns on."""
    fix_jax_gop_positions(monkeypatch, J.vi)
    ours, ref = _datasets(J, corpus, modality, 0)
    kw = dict(input_size=SIZE, is_train=is_train, seed=4)
    a_t, a_j = tvi.I3DBatchAssembler(ours, **kw), \
        J.vi.I3DBatchAssembler(ref, **kw)
    flips = []
    for _ in range(3):
        got, want = a_t.batch([0, 2, 1]), a_j.batch([0, 2, 1])
        assert sorted(got) == sorted(set(want) - {"vflips"})
        assert not want["vflips"].any()
        for k in got:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        flips += list(got["flips"])
    if is_train:
        assert any(flips) and not all(flips)


@pytest.mark.parametrize("modality,ds_factor", [
    ("flow+mp4", 16), ("flow+mp4", 0), ("mv", 0)])
def test_augment_matches(J, corpus, modality, ds_factor, monkeypatch):
    import jax.numpy as jnp

    fix_jax_gop_positions(monkeypatch, J.vi)
    ours, ref = _datasets(J, corpus, modality, 1)
    batch = tvi.I3DBatchAssembler(ours, input_size=SIZE, is_train=True,
                                  seed=6).batch([0, 1, 2])
    neg = (0, 2) if modality == "flow+mp4" else (0,)
    # the crops in the 0..255 domain
    frames = batch["frames"].astype(np.float32)
    crops_t = TT.apply_crops(torch.from_numpy(frames).permute(0, 1, 4, 2, 3),
                             batch["scales"], batch["translations"],
                             batch["flips"], SIZE, neg)
    crops_j = J.T.apply_crops(jnp.asarray(frames), batch["scales"],
                              batch["translations"], batch["flips"], SIZE,
                              neg)
    np.testing.assert_allclose(crops_t.permute(0, 1, 3, 4, 2).numpy(),
                               np.asarray(crops_j), rtol=0, atol=ATOL_U8)
    got = tvi.i3d_augment_batch(batch, modality, ds_factor, input_size=SIZE,
                                device="cpu")
    want = J.vi.i3d_augment_batch(batch, modality, ds_factor,
                                  input_size=SIZE)
    keys = ("flow", "mv", "residual") if modality == "flow+mp4" else ("x",)
    assert sorted(got) == sorted(want) == sorted(keys + ("label",))
    for k in keys:
        assert got[k].shape[2] == 8  # (B, C, T, H, W)
        np.testing.assert_allclose(got[k].permute(0, 2, 3, 4, 1).numpy(),
                                   np.asarray(want[k]), rtol=0,
                                   atol=ATOL_NORM, err_msg=k)
    np.testing.assert_array_equal(got["label"].numpy(), want["label"])


def whole_frame_augment(batch, ds_factor, size, device="cpu"):
    """`i3d_augment_batch`'s flow+mp4 outputs computed over the whole
    frames, the box left out: `apply_crops` on every pixel."""
    frames = torch.from_numpy(batch["frames"]).to(device)
    out = TT.apply_crops(frames.permute(0, 1, 4, 2, 3).float(),
                         batch["scales"], batch["translations"],
                         batch["flips"], size, (0, 2))
    x = (out / 255.0 - 0.5) / 0.5
    flow = x[:, :, 0:2]
    if ds_factor:
        flow = TT.blockify_flow(flow, ds_factor)
    return {k: v.permute(0, 2, 1, 3, 4) for k, v in (
        ("flow", flow), ("mv", x[:, :, 2:4]), ("residual", x[:, :, 4:7]))}


def crop_batch(rng, t, h, w, size, crops):
    """A flow+mp4 batch of random u8 clips (t, h, w) with one crop spec
    (row, col, crop_h, crop_w, flip) a clip, resized to `size`."""
    specs = [TT.crop_spec_to_scale_translate(oh, ow, ch, cw, size)
             for oh, ow, ch, cw, _ in crops]
    return {"frames": rng.integers(0, 256, (len(crops), t, h, w, 7),
                                   dtype=np.uint8),
            "scales": np.asarray([s[:2] for s in specs], np.float32),
            "translations": np.asarray([s[2:] for s in specs], np.float32),
            "flips": np.asarray([c[4] for c in crops]),
            "label": np.zeros(len(crops), np.int32)}


# (frame h, w, size, crops, bit-equal): centre crops at scale 1 weigh one
# pixel by exactly 1, so the box changes no bit; fractional crops sum their
# products over another length
BOX_CASES = {
    "centre-360x480": (360, 480, 224, [(68, 128, 224, 224, False)], True),
    "centre-odd": (61, 77, 48, [(6, 14, 48, 48, False)], True),
    "train-scales": (64, 80, 48, [(3, 7, 40, 40, True),
                                  (1, 2, 60, 62, False)], False),
    "edge-top": (64, 80, 48, [(0, 12, 56, 52, True)], False),
    "edge-bottom": (64, 80, 48, [(8, 12, 56, 52, False)], False),
    "edge-left": (64, 80, 48, [(4, 0, 56, 52, True)], False),
    "edge-right": (64, 80, 48, [(4, 28, 56, 52, False)], False),
    "three-clips": (64, 80, 48, [(2, 3, 40, 44, False),
                                 (20, 30, 44, 40, True),
                                 (10, 5, 48, 48, False)], False),
}


@pytest.mark.parametrize("case", sorted(BOX_CASES))
def test_boxed_augment_matches_whole_frame(case):
    """Only the box the crops read is copied: the outputs equal the
    whole-frame computation, the box covers every pixel with a non-zero
    weight and at most one more on each side, and the `data.i3d_h2d` span
    counts the box's bytes, unpinned on the CPU."""
    from test_torch_spans import traced

    h, w, size, crops, exact = BOX_CASES[case]
    batch = crop_batch(np.random.default_rng(len(case)), 2, h, w, size,
                       crops)
    got, log, _ = traced(lambda: tvi.i3d_augment_batch(
        batch, "flow+mp4", 16, input_size=size, device="cpu"))
    want = whole_frame_augment(batch, 16, size)
    for k in ("flow", "mv", "residual"):
        if exact:
            torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)
        else:
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                       rtol=0, atol=ATOL_NORM, err_msg=k)
    box = TT.crop_box(batch["scales"], batch["translations"], size, h, w)
    for axis, (lo, hi) in enumerate((box[:2], box[2:])):
        weights = TT._weight_mat(
            (h, w)[axis], size, torch.from_numpy(batch["scales"][:, axis]),
            torch.from_numpy(batch["translations"][:, axis]))
        rows = torch.nonzero(weights.sum(dim=(0, 2))).flatten()
        first, last = int(rows.min()), int(rows.max())
        assert max(first - 1, 0) <= lo <= first
        assert last < hi <= min(last + 2, (h, w)[axis])
    b, t, c = len(crops), 2, 7
    assert [e["counts"] for e in log if e["name"] == "data.i3d_h2d"] == [
        {"bytes": b * t * (box[1] - box[0]) * (box[3] - box[2]) * c,
         "kept": b * t * size * size * c, "pinned": 0}]
    if case == "centre-360x480":
        assert box[1] - box[0] == box[3] - box[2] == size + 2


def test_creat_matches(J, corpus, monkeypatch):
    fix_jax_gop_positions(monkeypatch, J.vi)
    kw = dict(video_prefix=str(corpus / "videos"), clip_length=4,
              modality="mv", accumulate=False, seed=5,
              num_frames_fn=lambda path: NF)
    ours = tfactory.creat("HMDB51", str(corpus), **kw)
    ref = J.factory.creat("HMDB51", str(corpus), **kw)
    assert tfactory.dataset_num_classes("UCF101") == \
        J.factory.dataset_num_classes("UCF101") == 101
    for o, r in zip(ours, ref):
        assert [vars(i) for i in o.items] == [vars(i) for i in r.items]
        assert type(o.sampler).__name__ == type(r.sampler).__name__
        for index in (1, 0, 1):
            np.testing.assert_array_equal(o[index][0], r[index][0])


def test_info_cache_matches(J, corpus, tmp_path):
    """The frame-count info file: written with the same check key and
    counts, and read back by either package (a stale key is rewritten)."""
    items_t, items_j = _items(J, corpus)
    path_t, path_j = tmp_path / "t.json", tmp_path / "j.json"
    sampler = tsamp.RandomSampling(4, seed=0)
    tvi.VideoClipDataset(items_t, sampler, cached_info_path=str(path_t))
    J.vi.VideoClipDataset(items_j, J.samp.RandomSampling(4, seed=0),
                          cached_info_path=str(path_j))
    assert path_t.read_text() == path_j.read_text()
    payload = path_t.read_text().replace(f'": {NF}', '": 13')
    path_t.write_text(payload)
    path_j.write_text(payload)
    got = tvi.VideoClipDataset(items_t, sampler, cached_info_path=str(path_t))
    want = J.vi.VideoClipDataset(items_j, J.samp.RandomSampling(4, seed=0),
                                 cached_info_path=str(path_j))
    assert [i.num_frames for i in got.items] == \
        [i.num_frames for i in want.items] == [13, 13, 13]
    stale = tvi.VideoClipDataset(items_t[1:], sampler,
                                 cached_info_path=str(path_t))
    assert [i.num_frames for i in stale.items] == [NF, NF]


def test_decode_errors_resample_other_errors_raise(J, corpus, tmp_path):
    """A garbage file is a decode error: both packages resample it into
    the same good clip.  A fault outside the decode errors (a missing
    native decoder) raises in the port, where the JAX package resamples
    until its retries end and then serves its backup item."""
    bad = tmp_path / "garbage.mp4"
    bad.write_bytes(b"not a video" * 100)
    items_t, items_j = _items(J, corpus, flow=False)
    items_t = [tlists.VideoItem(str(bad), 9, NF)] + items_t
    items_j = [J.lists.VideoItem(str(bad), 9, NF)] + items_j
    sampler_t, sampler_j = tsamp.RandomSampling(4, seed=1), \
        J.samp.RandomSampling(4, seed=1)
    ours = tvi.VideoClipDataset(items_t, sampler_t, "mv", seed=2)
    ref = J.vi.VideoClipDataset(items_j, sampler_j, "mv", seed=2)
    (got, gl), (want, wl) = ours[0], ref[0]
    np.testing.assert_array_equal(got, want)
    assert gl == wl != 9

    def no_decoder(path):
        raise NativeCodecUnavailable("no native decoder")

    ours._reader = no_decoder
    ref._reader = no_decoder
    with pytest.raises(NativeCodecUnavailable):
        ours[1]
    assert ref[1][1] == wl  # JAX: 20 resamples, then the backup item


# --- on the card -----------------------------------------------------------

@pytest.mark.cuda
def test_cuda_augment_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    rng = np.random.default_rng(7)
    batch = {"frames": rng.integers(0, 256, size=(2, 8, H, W, 7),
                                    dtype=np.uint8),
             "scales": np.asarray([[1.0, 1.0], [1.2, 0.9]], np.float32),
             "translations": np.asarray([[-3.0, -5.0], [-2.5, -1.0]],
                                        np.float32),
             "flips": np.asarray([False, True]),
             "label": np.asarray([1, 4], np.int32)}
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        got = tvi.i3d_augment_batch(batch, "flow+mp4", 16, input_size=SIZE,
                                    device="cuda")
        want = tvi.i3d_augment_batch(batch, "flow+mp4", 16, input_size=SIZE,
                                     device="cpu")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    for k in ("flow", "mv", "residual"):
        np.testing.assert_allclose(got[k].cpu().numpy(), want[k].numpy(),
                                   rtol=0, atol=ATOL_NORM, err_msg=k)


@pytest.mark.cuda
def test_cuda_pinned_staging_waits_and_grows():
    """`PinnedStaging` on the card: two copies back to back of different
    arrays, the first held behind a busy stream, each arrives whole (the
    second refills the buffer only after the first's copy has run); a
    larger, strided array after them grows the buffer."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    rng = np.random.default_rng(12)
    arrays = [rng.integers(0, 256, (16, 226, 226, 7), dtype=np.uint8)
              for _ in range(2)]
    larger = rng.integers(0, 256, (16, 360, 480, 7),
                          dtype=np.uint8)[:, 20:340, 30:450]
    dev = torch.device("cuda", torch.cuda.current_device())
    staging = tvi.PinnedStaging()
    staging.to_device(arrays[1], dev)   # allocates the buffer
    torch.cuda.synchronize()
    torch.cuda._sleep(500_000_000)   # the next copy waits behind
    got = [staging.to_device(a, dev) for a in arrays]
    small = staging._slots[dev][0].buf.numel()
    got.append(staging.to_device(larger, dev))
    assert staging._slots[dev][0].buf.numel() > small
    for a, g in zip(arrays + [larger], got):
        np.testing.assert_array_equal(g.cpu().numpy(), a)


@pytest.mark.cuda
def test_cuda_boxed_augment_matches():
    """`i3d_augment_batch` on the card: two calls back to back on
    different clips, then a larger box, each equal to its CPU result (the
    flow blockify's sums differ from the CPU's in the last bits); centre
    crops bit-equal to the whole-frame computation on the card under TF32;
    every copy through the pinned buffer."""
    from torch.profiler import ProfilerActivity, profile

    from dmcnet_tpu_torch.utils.profiling import read_spans

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    rng = np.random.default_rng(11)
    centre = [crop_batch(rng, 32, 360, 480, 224, [(68, 128, 224, 224, False)])
              for _ in range(2)]
    larger = crop_batch(rng, 16, 360, 480, 224, [(0, 0, 300, 280, True),
                                                 (40, 180, 320, 300, False),
                                                 (100, 60, 224, 224, True)])
    aug = dict(modality="flow+mp4", ds_factor=16, input_size=224)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        with profile(activities=[ProfilerActivity.CPU]):
            got = [tvi.i3d_augment_batch(b, device="cuda", **aug)
                   for b in centre]
            torch.backends.cuda.matmul.allow_tf32 = False
            got_larger = tvi.i3d_augment_batch(larger, device="cuda", **aug)
            torch.cuda.synchronize()
            spans = [e for e in read_spans() if e["name"] == "data.i3d_h2d"]
        assert [e["counts"]["pinned"] for e in spans[-3:]] == [1, 1, 1]
        for b, g in zip(centre, got):
            want = tvi.i3d_augment_batch(b, device="cpu", **aug)
            torch.backends.cuda.matmul.allow_tf32 = True
            whole = whole_frame_augment(b, 16, 224, device="cuda")
            for k in ("flow", "mv", "residual"):
                np.testing.assert_allclose(g[k].cpu().numpy(),
                                           want[k].numpy(), rtol=0,
                                           atol=ATOL_NORM, err_msg=k)
                torch.testing.assert_close(g[k], whole[k], rtol=0, atol=0)
        want = tvi.i3d_augment_batch(larger, device="cpu", **aug)
        for k in ("flow", "mv", "residual"):
            np.testing.assert_allclose(got_larger[k].cpu().numpy(),
                                       want[k].numpy(), rtol=0,
                                       atol=ATOL_NORM, err_msg=k)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
