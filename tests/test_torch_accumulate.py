"""The port's GOP accumulation against the JAX package's, bit for bit:
`codec.accumulate` (accumulate on and off), `ops.backtrace.
gop_mv_residual_cuda` on the CPU with each of its three routes counted, the
host accumulation, and `coviar_compat.load` on an encoded clip."""

import numpy as np
import pytest
import torch
from test_torch_train import _two_torch_threads  # noqa: F401

from dmcnet_tpu.codec import accumulate as jacc
from dmcnet_tpu.codec import coviar_compat as jcompat
from dmcnet_tpu.codec import host_accumulate as jhost
from dmcnet_tpu.ops import pallas_backtrace as pb
from dmcnet_tpu_torch.codec import accumulate as tacc
from dmcnet_tpu_torch.codec import coviar_compat as tcompat
from dmcnet_tpu_torch.codec import host_accumulate as thost
from dmcnet_tpu_torch.codec import mpeg4 as tmpeg4
from dmcnet_tpu_torch.codec import semantics as tsem
from dmcnet_tpu_torch.codec import synthetic as tsyn
from dmcnet_tpu_torch.ops import backtrace as tb


def _gop(seed, t, h, w, block, max_motion=12):
    block_lists, frames = tsyn.synthetic_gop(
        np.random.default_rng(seed), num_frames=t, height=h, width=w,
        block_size=block, max_motion=max_motion)
    return block_lists, tsyn.dense_mv_maps(block_lists, h, w), frames


@pytest.mark.parametrize("accumulate", [True, False])
def test_accumulate_matches_jax_package(accumulate):
    _, dense, frames = _gop(1, 6, 48, 64, 8, max_motion=20)
    want = jacc.gop_mv_residual(dense, frames, accumulate=accumulate)
    got = tacc.gop_mv_residual(dense, frames, accumulate, device="cpu")
    for g, w_ in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w_))
    np.testing.assert_array_equal(
        tacc.backtrace_gop(torch.from_numpy(dense)).numpy(),
        np.asarray(jacc.backtrace_gop(dense)))


def test_load_like_coviar_matches_golden_model():
    block_lists, dense, frames = _gop(2, 5, 32, 48, 16, max_motion=20)
    for rep in ("iframe", "mv", "residual"):
        for acc in (True, False):
            for pos in (0, 2, 4):
                want = tsem.load_like_coviar_numpy(block_lists, frames, pos,
                                                   rep, acc)
                got = tacc.load_like_coviar_torch(dense, frames, pos, rep,
                                                  acc, device="cpu")
                np.testing.assert_array_equal(got.numpy(), want)


# (route, motion block size, width kept): 16x16 motion takes B2 at cell 16,
# 8x8 motion at cell 8; 4x4 motion mixes motions within an 8x8 cell, and a
# width of 28 is not a multiple of 8, so both take the dense scan.
_ROUTES = [("cell16", 16, 32), ("cell8", 8, 32), ("dense", 4, 32),
           ("dense", 16, 28)]


@pytest.mark.parametrize("route,block,w", _ROUTES)
def test_gop_mv_residual_cuda_on_cpu_matches_jax_pallas_path(route, block,
                                                            w):
    from jax.experimental.pallas import tpu as pltpu

    _, dense, frames = _gop(3, 3, 32, 32, block, max_motion=20)
    dense = np.ascontiguousarray(dense[:, :, :w])
    frames = np.ascontiguousarray(frames[:, :, :w])
    with pltpu.force_tpu_interpret_mode():
        want = pb.gop_mv_residual_pallas(dense, frames)
    before = dict(tb.backtrace_gop_cuda.routes)
    launches = tb.backtrace_gop_cells.launches
    got = tb.gop_mv_residual_cuda(dense, frames, device="cpu")
    after = tb.backtrace_gop_cuda.routes
    assert {k: after[k] - before[k] for k in after} == {
        k: int(k == route) for k in after}
    assert tb.backtrace_gop_cells.launches == launches  # CPU: plain version
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w_))
    ref = tacc.gop_mv_residual(dense, frames, device="cpu")
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


@pytest.mark.parametrize("accumulate", [True, False])
def test_host_accumulation_matches_jax_package(accumulate):
    _, dense, frames = _gop(4, 5, 32, 48, 8, max_motion=20)
    want = jhost.gop_mv_residual_numpy(dense, frames, accumulate)
    got = thost.gop_mv_residual_numpy(dense, frames, accumulate)
    native = thost.gop_mv_residual_native(dense.astype(np.int16), frames,
                                          accumulate)
    for g, n, w_ in zip(got, native, want):
        np.testing.assert_array_equal(g, w_)
        np.testing.assert_array_equal(n, w_)


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    rng = np.random.default_rng(6)
    h, w, pad = 64, 96, 40
    canvas = (rng.integers(0, 256, size=(h + 2 * pad + 30,
                                         w + 2 * pad + 60, 3))
              // 8 * 8).astype(np.uint8)
    frames = np.stack([canvas[pad + i:pad + i + h,
                              pad + 2 * i:pad + 2 * i + w]
                       for i in range(16)])
    path = str(tmp_path_factory.mktemp("compat") / "pan.avi")
    tmpeg4.encode_mpeg4(path, frames, gop_size=12, bit_rate=2_000_000)
    return path


def test_coviar_compat_matches_jax_package(clip):
    assert tcompat.get_num_frames(clip) == jcompat.get_num_frames(clip)
    assert tcompat.get_num_gops(clip) == jcompat.get_num_gops(clip)
    for rep in (tcompat.IFRAME, tcompat.MV, tcompat.RESIDUAL):
        for acc in (True, False):
            for gop, pos in ((0, 0), (0, 5), (1, 3), (1, 99)):
                got = tcompat.load(clip, gop, pos, rep, acc, device="cpu")
                want = jcompat.load(clip, gop, pos, rep, acc)
                assert got.dtype == want.dtype
                np.testing.assert_array_equal(got, want)
