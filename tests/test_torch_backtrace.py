"""The port's GOP back-trace (dmcnet_tpu_torch/ops/backtrace.py) against the
JAX package: the plain PyTorch version is bit-equal to the exact XLA twin
and to the Pallas kernel (interpret mode), the cell-grid builder matches,
and on a card the CUDA kernel is bit-equal to the plain version."""

import numpy as np
import pytest
import torch

from dmcnet_tpu.codec.semantics import accumulate_gop_numpy
from dmcnet_tpu.codec.synthetic import synthetic_gop
from dmcnet_tpu.ops import pallas_backtrace as pb
from dmcnet_tpu_torch.codec import semantics as tsem
from dmcnet_tpu_torch.codec import synthetic as tsyn
from dmcnet_tpu_torch.ops import backtrace as tb


def _random_cells(rng, g, t, h, w, cell, bound=None):
    m = tb.max_mv(cell) if bound is None else bound
    cm = rng.integers(-m, m + 1, size=(g, t, h // cell, w // cell, 2))
    ifr = rng.integers(0, 256, size=(g, 3, h, w))
    return cm.astype(np.int32), ifr.astype(np.int32)


def _border_cells(g, t, h, w, cell):
    """Every cell moves by +-max_mv(cell), so sources of the cells nearest
    each edge fall outside the frame."""
    m = tb.max_mv(cell)
    ncy, ncx = h // cell, w // cell
    cm = np.zeros((g, t, ncy, ncx, 2), np.int32)
    for s in range(t):
        sign = 1 if s % 2 else -1
        cm[:, s, :, :, 0] = sign * m
        cm[:, s, :, :, 1] = -sign * m
        cm[:, s, :, : ncx // 2, 0] *= -1
    ifr = np.random.default_rng(1).integers(0, 256, size=(g, 3, h, w))
    return cm, ifr.astype(np.int32)


@pytest.mark.parametrize("cell", [8, 16])
@pytest.mark.parametrize("case", ["random", "border"])
def test_ref_matches_xla_twin(cell, case):
    g, t, h, w = 2, 6, 64, 96
    if case == "random":
        cm, ifr = _random_cells(np.random.default_rng(cell), g, t, h, w,
                                cell)
    else:
        cm, ifr = _border_cells(g, t, h, w, cell)
    accu_x, warp_x = pb.backtrace_warp_batch_xla(cm, ifr, h, w, cell=cell)
    accu_t, warp_t = tb.backtrace_warp_batch_ref(
        torch.from_numpy(cm), torch.from_numpy(ifr), h, w, cell)
    np.testing.assert_array_equal(accu_t.numpy(), np.asarray(accu_x))
    np.testing.assert_array_equal(warp_t.numpy(), np.asarray(warp_x))


def test_ref_matches_pallas_kernel_interpret():
    from jax.experimental.pallas import tpu as pltpu

    cm, ifr = _random_cells(np.random.default_rng(5), 2, 3, 32, 32, 8)
    with pltpu.force_tpu_interpret_mode():
        accu_k, warp_k = pb.backtrace_warp_batch(cm, ifr, 32, 32, cell=8)
    accu_t, warp_t = tb.backtrace_warp_batch_ref(
        torch.from_numpy(cm), torch.from_numpy(ifr), 32, 32, 8)
    np.testing.assert_array_equal(accu_t.numpy(), np.asarray(accu_k))
    np.testing.assert_array_equal(warp_t.numpy(), np.asarray(warp_k))


def test_ref_matches_golden_on_synthetic_gop():
    """Block lists -> cell grid -> plain back-trace == the port's numpy
    golden model, which equals the JAX package's."""
    rng = np.random.default_rng(7)
    h, w, t = 48, 64, 5
    block_lists, frames = tsyn.synthetic_gop(rng, num_frames=t, height=h,
                                             width=w, max_motion=20)
    blocks, n_blocks = tsyn.block_arrays(block_lists)
    cm, cell = tb.cell_mv_from_blocks_np(blocks, n_blocks, h, w)
    assert cell == 16
    ifr = frames[0].transpose(2, 0, 1).astype(np.int32)
    accu, warped = tb.backtrace_warp_batch_ref(
        torch.from_numpy(cm[None]), torch.from_numpy(ifr[None]), h, w, cell)
    for s in range(t):
        golden = tsem.accumulate_gop_numpy(block_lists, h, w, s)
        np.testing.assert_array_equal(golden,
                                      accumulate_gop_numpy(block_lists, h,
                                                           w, s))
        np.testing.assert_array_equal(
            accu[0, s].numpy().transpose(1, 2, 0), golden)
        np.testing.assert_array_equal(
            warped[0, s].numpy().transpose(1, 2, 0),
            frames[0][golden[..., 1], golden[..., 0]])


def test_synthetic_copies_match_jax_package():
    a = tsyn.synthetic_gop(np.random.default_rng(3), num_frames=4)
    b = synthetic_gop(np.random.default_rng(3), num_frames=4)
    assert [[vars(x) for x in bl] for bl in a[0]] == \
        [[vars(x) for x in bl] for bl in b[0]]
    np.testing.assert_array_equal(a[1], b[1])


def test_cells_from_blocks_match_jax_package():
    """Same acceptance rule and grids as the JAX package, native and numpy,
    on valid and disqualifying block lists (misaligned origins, motion
    beyond max_mv, 16- and 8-cell mixes)."""
    rng = np.random.default_rng(11)
    h, w = 128, 192
    for trial in range(60):
        nb = rng.integers(0, 6, size=(3,)).astype(np.int32)
        bl = np.zeros((3, 8, 6), np.int32)
        for ti in range(3):
            for i in range(nb[ti]):
                cell = int(rng.choice([8, 16]))
                x0 = int(rng.integers(-1, w // cell)) * cell
                y0 = int(rng.integers(0, h // cell)) * cell
                if rng.random() < 0.25:
                    x0 += int(rng.integers(1, 8))
                vx = int(rng.integers(-60, 61))
                vy = int(rng.integers(-12, 13))
                bl[ti, i] = [x0 + cell // 2 - vx, y0 + cell // 2 - vy,
                             x0 + cell // 2, y0 + cell // 2, cell, cell]
        want, cw = pb.cell_mv_from_blocks_np(bl, nb, h, w)
        for fn in (tb.cell_mv_from_blocks, tb.cell_mv_from_blocks_np):
            got, cg = fn(bl, nb, h, w)
            assert cg == cw, (trial, fn.__name__, cg, cw)
            if want is None:
                assert got is None
            else:
                np.testing.assert_array_equal(got, want)


def test_wrapper_on_cpu_runs_plain_version_and_checks_args():
    cm, ifr = _random_cells(np.random.default_rng(2), 1, 3, 32, 48, 16)
    before = tb.backtrace_warp_batch.launches
    a, w_ = tb.backtrace_warp_batch(torch.from_numpy(cm),
                                    torch.from_numpy(ifr), 32, 48, 16)
    r, rw = tb.backtrace_warp_batch_ref(torch.from_numpy(cm),
                                        torch.from_numpy(ifr), 32, 48, 16)
    assert torch.equal(a, r) and torch.equal(w_, rw)
    assert tb.backtrace_warp_batch.launches == before
    with pytest.raises(TypeError):
        tb.backtrace_warp_batch(torch.from_numpy(cm).long(),
                                torch.from_numpy(ifr), 32, 48, 16)
    with pytest.raises(ValueError):
        tb.backtrace_warp_batch(torch.from_numpy(cm), torch.from_numpy(ifr),
                                32, 48, 8)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [8, 16])
def test_cuda_kernel_matches_plain_version(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    g, t, h, w = 4, 12, 256, 320
    cm, ifr = _random_cells(np.random.default_rng(cell), g, t, h, w, cell)
    cm_d, ifr_d = torch.from_numpy(cm).cuda(), torch.from_numpy(ifr).cuda()
    before = tb.backtrace_warp_batch.launches
    accu, warped = tb.backtrace_warp_batch(cm_d, ifr_d, h, w, cell)
    torch.cuda.synchronize()
    assert tb.backtrace_warp_batch.launches == before + 1
    ra, rw = tb.backtrace_warp_batch_ref(cm_d, ifr_d, h, w, cell)
    assert torch.equal(accu, ra)
    assert torch.equal(warped, rw)
