"""The port's codec binding (dmcnet_tpu_torch/codec) against the JAX
package's: the same encoded clip decodes to the same frames, dense MV maps
and block lists through both libraries, the host accumulation is
bit-equal, and both transcoders give the same MPEG-4 stream."""

import os

import numpy as np
import pytest

from dmcnet_tpu.codec import convert as jax_convert
from dmcnet_tpu.codec import host_accumulate as jax_host
from dmcnet_tpu.codec import mpeg4 as jax_mpeg4
from dmcnet_tpu_torch.codec import convert as torch_convert
from dmcnet_tpu_torch.codec import host_accumulate as torch_host
from dmcnet_tpu_torch.codec import mpeg4 as torch_mpeg4


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    rng = np.random.default_rng(5)
    h, w, pad = 64, 96, 40
    canvas = (rng.integers(0, 256, size=(h + 2 * pad + 30,
                                         w + 2 * pad + 60, 3))
              // 8 * 8).astype(np.uint8)
    frames = np.stack([canvas[pad + i:pad + i + h,
                              pad + 2 * i:pad + 2 * i + w]
                       for i in range(20)])
    path = str(tmp_path_factory.mktemp("codec") / "pan.avi")
    torch_mpeg4.encode_mpeg4(path, frames, gop_size=12, bit_rate=2_000_000)
    return path


def test_reader_matches_jax_package(clip):
    with torch_mpeg4.VideoReader(clip) as ours, \
            jax_mpeg4.VideoReader(clip) as ref:
        assert (ours.width, ours.height, ours.num_frames, ours.num_gops,
                ours.is_mpeg4) == (ref.width, ref.height, ref.num_frames,
                                   ref.num_gops, ref.is_mpeg4)
        for g in range(ours.num_gops):
            assert ours.gop_len(g) == ref.gop_len(g)
            for a, b in zip(ours.decode_gop(g), ref.decode_gop(g)):
                np.testing.assert_array_equal(a, b)
            keep = np.zeros(ours.gop_len(g), bool)
            keep[[0, -1]] = True
            got = ours.decode_gop_blocks(g, skip_dense=True, keep=keep)
            want = ref.decode_gop_blocks(g, skip_dense=True, keep=keep)
            assert got[1] is None and want[1] is None
            for i in (0, 2, 3):
                np.testing.assert_array_equal(got[i], want[i])
            frames, mv_maps = ours.decode_gop(g)
            for bound in (20, None):
                for a, b in zip(
                        torch_host.gop_mv_residual_u8(mv_maps, frames, True,
                                                      bound),
                        jax_host.gop_mv_residual_u8(mv_maps, frames, True,
                                                    bound)):
                    np.testing.assert_array_equal(a, b)


def test_reader_cache_reuses_and_evicts(clip, tmp_path):
    cache = torch_mpeg4.ReaderCache(max_readers=1)
    r = cache.get(clip)
    assert cache.get(clip) is r and len(cache) == 1
    other = str(tmp_path / "copy.avi")
    with open(clip, "rb") as src, open(other, "wb") as dst:
        dst.write(src.read())
    assert cache.get(other) is not r and len(cache) == 1
    assert torch_mpeg4.shared_reader_cache() is \
        torch_mpeg4.shared_reader_cache()
    with pytest.raises(OSError):
        torch_mpeg4.VideoReader(str(tmp_path / "missing.avi"))


def test_build_without_ffmpeg_raises_clearly(monkeypatch):
    monkeypatch.setattr(torch_mpeg4, "_FFMPEG_PKGS", ("libnosuchpkg",))
    with pytest.raises(torch_mpeg4.NativeCodecUnavailable,
                       match="pkg-config"):
        torch_mpeg4._build_native()


def test_convert_tree_matches_jax_package(clip, tmp_path):
    src = tmp_path / "src"
    os.makedirs(src / "cls")
    with open(clip, "rb") as f:
        (src / "cls" / "v.avi").write_bytes(f.read())
    (src / "cls" / "notes.txt").write_text("not a video")
    (src / "cls" / "broken.mp4").write_bytes(b"not a video either")
    ok, failures = torch_convert.convert_tree(str(src), str(tmp_path / "t"),
                                              height=32, workers=2)
    assert ok == 1 and [os.path.basename(f[0]) for f in failures] == \
        ["broken.mp4"]
    jax_convert.convert_tree(str(src), str(tmp_path / "j"), height=32,
                             workers=2)
    with torch_mpeg4.VideoReader(tmp_path / "t" / "cls" / "v.mp4") as ours, \
            jax_mpeg4.VideoReader(tmp_path / "j" / "cls" / "v.mp4") as ref:
        assert ours.is_mpeg4 and (ours.height, ours.width) == (32, 48)
        assert ours.num_frames == ref.num_frames == 20
        for g in range(ours.num_gops):
            for a, b in zip(ours.decode_gop(g), ref.decode_gop(g)):
                np.testing.assert_array_equal(a, b)
    assert torch_convert.main([str(src), str(tmp_path / "m")]) == 1


@pytest.mark.parametrize("width", [72, 88])
def test_decoder_handles_widths_not_multiple_of_16(tmp_path, width):
    """The BGR conversion writes into a padded row buffer: on such widths
    the JAX package's copy of the decoder corrupts the heap."""
    rng = np.random.default_rng(width)
    h = 48
    base = rng.integers(0, 256, size=((h + 80) // 16 + 1,
                                      (width + 80) // 16 + 1, 3))
    canvas = np.kron(base, np.ones((16, 16, 1)))[:h + 80, :width + 80]
    frames = np.stack([canvas[20 + i:20 + i + h, 20 + 2 * i:20 + 2 * i + width]
                       for i in range(14)]).astype(np.uint8)
    path = tmp_path / "odd.avi"
    torch_mpeg4.encode_mpeg4(path, frames, bit_rate=4_000_000)
    with torch_mpeg4.VideoReader(path) as r:
        assert (r.height, r.width) == (h, width)
        got = np.concatenate([r.decode_gop(g)[0] for g in range(r.num_gops)])
    assert got.shape == frames.shape
    err = np.abs(got.astype(np.int32) - frames).mean()
    assert err < 8, err  # MPEG-4 loss on this content: ~4.7
