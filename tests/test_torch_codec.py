"""The port's codec binding (dmcnet_tpu_torch/codec) against the JAX
package's: the same encoded clip decodes to the same frames, dense MV maps
and block lists through both libraries, and the host accumulation is
bit-equal."""

import numpy as np
import pytest

from dmcnet_tpu.codec import host_accumulate as jax_host
from dmcnet_tpu.codec import mpeg4 as jax_mpeg4
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
