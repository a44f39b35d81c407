"""The port's GOP back-trace (dmcnet_tpu_torch/ops/backtrace.py) against the
JAX package: the plain PyTorch versions of B1 (`backtrace_warp_batch`) and
B2 (`backtrace_gop_cells`) are bit-equal to the exact XLA twin, to the
Pallas kernels (interpret mode) and to the numpy golden model, the
cell-grid builders match with their acceptance flags, and on a card the
CUDA kernels are bit-equal to the plain versions."""

import numpy as np
import pytest
import torch

from dmcnet_tpu.codec.semantics import accumulate_gop_numpy
from dmcnet_tpu.codec.synthetic import dense_mv_maps, synthetic_gop
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


def _gop_cells_with_border(rng, t, h, w, cell):
    """One GOP's cells: random motion up to max_mv(cell) in the first
    frames, then a frame where every cell moves by +-max_mv(cell), so the
    sources of the cells nearest each edge fall outside the frame."""
    cm, _ = _random_cells(rng, 1, t, h, w, cell)
    border, _ = _border_cells(1, t, h, w, cell)
    cm[0, t - 1] = border[0, 1]
    return cm[0]


@pytest.mark.parametrize("cell", [8, 16])
def test_gop_cells_ref_matches_pallas_kernel_interpret(cell):
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    cm = _gop_cells_with_border(np.random.default_rng(cell), 4, 32, 32, cell)
    with pltpu.force_tpu_interpret_mode():
        want = pb.backtrace_gop_cells(jnp.asarray(cm), 32, 32, cell=cell)
    got = tb.backtrace_gop_cells_ref(torch.from_numpy(cm), 32, 32, cell)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("cell", [8, 16])
def test_gop_cells_ref_is_b1_without_the_warp(cell):
    g, t, h, w = 2, 5, 64, 96
    cm, ifr = _random_cells(np.random.default_rng(20 + cell), g, t, h, w,
                            cell)
    cm[1] = _gop_cells_with_border(np.random.default_rng(cell), t, h, w,
                                   cell)
    accu, _ = tb.backtrace_warp_batch_ref(torch.from_numpy(cm),
                                          torch.from_numpy(ifr), h, w, cell)
    for gi in range(g):
        got = tb.backtrace_gop_cells(torch.from_numpy(cm[gi]), h, w, cell)
        assert torch.equal(got, accu[gi])


@pytest.mark.parametrize("block", [8, 16])
def test_gop_cells_ref_matches_golden(block):
    """Dense rasterized maps -> cell grid (coarsened where 16x16-uniform)
    -> plain B2 == accumulate_gop_numpy, with strong motion at the edges."""
    rng = np.random.default_rng(30 + block)
    h, w, t = 48, 64, 5
    block_lists, _ = tsyn.synthetic_gop(rng, num_frames=t, height=h,
                                        width=w, block_size=block,
                                        max_motion=20)
    dense = tsyn.dense_mv_maps(block_lists, h, w)
    cm, ok = tb.cell_mv_from_dense(dense)
    assert ok
    coarse, ok16 = tb.coarsen_cell_mv(cm, h, w)
    assert ok16 == (block == 16)
    cells, cell = (coarse, 16) if ok16 else (cm, 8)
    accu = tb.accu_to_hwc(tb.backtrace_gop_cells_ref(
        torch.from_numpy(cells), h, w, cell)).numpy()
    for s in range(t):
        np.testing.assert_array_equal(
            accu[s], tsem.accumulate_gop_numpy(block_lists, h, w, s))


def _dense_cases():
    """(name, dense maps) covering every acceptance outcome: 16x16-uniform,
    8x8-uniform, mixed within a cell, motion beyond max_mv, a static 8x8
    sub-cell inside a moving 16x16 group, and a fully clipped one."""
    rng = np.random.default_rng(40)
    h, w = 64, 96
    cases = []
    for block in (16, 8, 4):
        bl, _ = synthetic_gop(rng, num_frames=4, height=h, width=w,
                              block_size=block, max_motion=12)
        cases.append((f"block{block}", dense_mv_maps(bl, h, w)))
    big = np.zeros((3, h, w, 2), np.int32)
    big[1, 16:32, 16:32] = (57, 0)
    cases.append(("beyond_max_mv8", big))
    big16 = np.zeros((3, h, w, 2), np.int32)
    big16[1, 16:32, 16:32] = (50, 0)
    cases.append(("beyond_max_mv16", big16))
    static = np.zeros((3, h, w, 2), np.int32)
    static[1, 16:32, 16:32] = (3, -2)
    static[1, 16:24, 16:24] = 0
    cases.append(("static_subcell", static))
    clipped = np.zeros((3, h, w, 2), np.int32)
    clipped[1, 8:16, 0:8] = (0, 0)
    clipped[1, 0:16, 8:16] = (9, 0)
    clipped[1, 0:8, 0:8] = (9, 0)
    cases.append(("clipped_subcell", clipped))
    return cases


def test_cells_from_dense_and_coarsen_match_jax_package():
    for name, dense in _dense_cases():
        want, ok = pb.cell_mv_from_dense(dense)
        got, tok = tb.cell_mv_from_dense(dense)
        assert tok == ok, name
        np.testing.assert_array_equal(got, want)
        h, w = dense.shape[1:3]
        want16, ok16 = pb.coarsen_cell_mv(want, h, w)
        got16, tok16 = tb.coarsen_cell_mv(got, h, w)
        assert tok16 == ok16, name
        np.testing.assert_array_equal(got16, want16)
    outcomes = {name: (tb.cell_mv_from_dense(d)[1],
                       tb.coarsen_cell_mv(tb.cell_mv_from_dense(d)[0],
                                          *d.shape[1:3])[1])
                for name, d in _dense_cases()}
    assert outcomes["block16"] == (True, True)
    assert outcomes["block8"] == (True, False)
    assert not outcomes["block4"][0]
    assert not outcomes["beyond_max_mv8"][0]
    assert outcomes["beyond_max_mv16"] == (True, False)
    assert outcomes["static_subcell"] == (True, False)
    assert outcomes["clipped_subcell"] == (True, True)
    with pytest.raises(ValueError):
        tb.cell_mv_from_dense(np.zeros((2, 20, 24, 2), np.int32))


def test_gop_wrapper_on_cpu_runs_plain_version_and_checks_args():
    cm = _gop_cells_with_border(np.random.default_rng(3), 3, 32, 48, 16)
    before = tb.backtrace_gop_cells.launches
    got = tb.backtrace_gop_cells(torch.from_numpy(cm), 32, 48, 16)
    assert torch.equal(got, tb.backtrace_gop_cells_ref(torch.from_numpy(cm),
                                                       32, 48, 16))
    assert tb.backtrace_gop_cells.launches == before
    with pytest.raises(TypeError):
        tb.backtrace_gop_cells(torch.from_numpy(cm).long(), 32, 48, 16)
    with pytest.raises(ValueError):
        tb.backtrace_gop_cells(torch.from_numpy(cm), 32, 48, 8)
    with pytest.raises(ValueError):
        tb.backtrace_gop_cells(torch.from_numpy(cm)[None], 32, 48, 16)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [8, 16])
def test_cuda_gop_kernel_matches_plain_version_and_b1(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    t, h, w = 12, 256, 320
    cm = _gop_cells_with_border(np.random.default_rng(cell), t, h, w, cell)
    cm_d = torch.from_numpy(cm).cuda()
    before = tb.backtrace_gop_cells.launches
    accu = tb.backtrace_gop_cells(cm_d, h, w, cell)
    torch.cuda.synchronize()
    assert tb.backtrace_gop_cells.launches == before + 1
    assert torch.equal(accu, tb.backtrace_gop_cells_ref(cm_d, h, w, cell))
    ifr = torch.zeros((3, h, w), dtype=torch.int32, device="cuda")
    b1, _ = tb.backtrace_warp_gop_cells(cm_d, ifr, h, w, cell)
    assert torch.equal(accu, b1)


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


# (cell, H, W, T): widths whose rows do not fill a block's run of pixels,
# heights of one and three cell rows, and T of one frame, one pair and an
# odd count (the middle frame walks alone), at cell 8 and 16.
RAGGED = [(8, h, w, t) for w in (72, 88, 96) for h in (8, 24)
          for t in (1, 2, 13)] + \
         [(16, h, w, t) for w in (80, 96, 112) for h in (16, 48)
          for t in (1, 2, 13)]
RAGGED_IDS = [f"c{c}-{h}x{w}-T{t}" for c, h, w, t in RAGGED]


@pytest.mark.parametrize("cell,h,w,t", RAGGED, ids=RAGGED_IDS)
def test_ragged_refs_match_xla_twin(cell, h, w, t):
    cm, ifr = _random_cells(np.random.default_rng(h * w + t), 2, t, h, w,
                            cell)
    accu_x, warp_x = pb.backtrace_warp_batch_xla(cm, ifr, h, w, cell=cell)
    accu_t, warp_t = tb.backtrace_warp_batch_ref(
        torch.from_numpy(cm), torch.from_numpy(ifr), h, w, cell)
    np.testing.assert_array_equal(accu_t.numpy(), np.asarray(accu_x))
    np.testing.assert_array_equal(warp_t.numpy(), np.asarray(warp_x))
    got = tb.backtrace_gop_cells_ref(torch.from_numpy(cm[1]), h, w, cell)
    np.testing.assert_array_equal(got.numpy(), np.asarray(accu_x)[1])


@pytest.mark.parametrize("cell,h,w", [(8, 8, 72), (16, 16, 80)])
@pytest.mark.parametrize("t", [1, 2, 13])
def test_ragged_refs_match_pallas_kernels_interpret(cell, h, w, t):
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    cm, ifr = _random_cells(np.random.default_rng(t), 1, t, h, w, cell)
    with pltpu.force_tpu_interpret_mode():
        accu_k, warp_k = pb.backtrace_warp_batch(cm, ifr, h, w, cell=cell)
        gop_k = pb.backtrace_gop_cells(jnp.asarray(cm[0]), h, w, cell=cell)
    accu_t, warp_t = tb.backtrace_warp_batch_ref(
        torch.from_numpy(cm), torch.from_numpy(ifr), h, w, cell)
    np.testing.assert_array_equal(accu_t.numpy(), np.asarray(accu_k))
    np.testing.assert_array_equal(warp_t.numpy(), np.asarray(warp_k))
    got = tb.backtrace_gop_cells_ref(torch.from_numpy(cm[0]), h, w, cell)
    np.testing.assert_array_equal(got.numpy(), np.asarray(gop_k))


@pytest.mark.cuda
@pytest.mark.parametrize("cell,h,w,t", RAGGED, ids=RAGGED_IDS)
def test_cuda_ragged_kernels_match_plain_versions(cell, h, w, t):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    cm, ifr = _random_cells(np.random.default_rng(h * w + t), 3, t, h, w,
                            cell)
    cm_d, ifr_d = torch.from_numpy(cm).cuda(), torch.from_numpy(ifr).cuda()
    accu, warped = tb.backtrace_warp_batch(cm_d, ifr_d, h, w, cell)
    gop = tb.backtrace_gop_cells(cm_d[1].contiguous(), h, w, cell)
    torch.cuda.synchronize()
    ra, rw = tb.backtrace_warp_batch_ref(cm_d, ifr_d, h, w, cell)
    assert torch.equal(accu, ra)
    assert torch.equal(warped, rw)
    assert torch.equal(gop, ra[1])
    assert torch.equal(gop, tb.backtrace_gop_cells_ref(cm_d[1], h, w, cell))


@pytest.mark.cuda
def test_cuda_kernel_past_the_first_designs_grid_limit():
    """The first design put G*T on the grid's z axis (at most 65535); the
    flat grid has no such limit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    t = 12
    g = 65535 // t + 1
    rng = np.random.default_rng(9)
    cm = rng.integers(-7, 8, size=(g, t, 1, 1, 2)).astype(np.int32)
    ifr = rng.integers(0, 256, size=(g, 3, 8, 8)).astype(np.int32)
    cm_d, ifr_d = torch.from_numpy(cm).cuda(), torch.from_numpy(ifr).cuda()
    accu, warped = tb.backtrace_warp_batch(cm_d, ifr_d, 8, 8, 8)
    torch.cuda.synchronize()
    ra, rw = tb.backtrace_warp_batch_ref(cm_d, ifr_d, 8, 8, 8)
    assert g * t > 65535
    assert torch.equal(accu, ra)
    assert torch.equal(warped, rw)
