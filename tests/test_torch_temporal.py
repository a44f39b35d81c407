"""Time-sharded I3D evaluation (`dmcnet_tpu_torch/parallel/temporal.py`,
`evaluate_video_i3d --shard-time`) on the CPU.

  * Each windowed op alone (TF-SAME `Unit3D`s, the max pools, the VALID
    (2, 7, 7) average), given a `TimeShard`, on each rank's frames of an input split over 2 to 5
    ranks, in this process: the exchange is simulated by slicing the whole
    input, so the ops' global output ranges, their padding from the global
    T and their empty ranks are held against the unsharded op, float64.
  * The whole forward with 3 gloo processes (this file run as a script, as
    tests/test_torch_parallel.py does), over all 3 ranks and over a group
    of 2: T = 24 at 32x32, 8 frames a rank over 3, 4 after the stem, 2
    after `mixed_3c`'s pool, 1 after `mixed_4f`'s, and 2 outputs of the
    final average over 3 ranks, so rank 2 holds none.  Float64 against the
    port's unsharded forward at rtol 1e-10, and float32 against the JAX
    package's `make_time_sharded_apply` on a 2- and a 3-device CPU mesh at
    atol 1e-4 (tests/test_temporal_parallel.py's tolerance); the most
    frames one exchange brought in stays within the widest window (7), so
    no rank gathered a whole activation along T.

Weights are the flax initialisation's shapes drawn with numpy
(tests/test_torch_i3d.py `draw_variables`), with running statistics drawn
too, bridged by `state_dict_from_flax`.
"""

import functools
import os
import sys

import numpy as np
import pytest
import torch
from test_torch_i3d import draw_variables
from test_torch_parallel import free_port, run_ranks

from dmcnet_tpu_torch.models.i3d import MaxPool3dSame, Unit3D
from dmcnet_tpu_torch.models.layers import same_pad_3d, window3d
from dmcnet_tpu_torch.parallel import temporal

B, T, HW, NUM_CLASS = 2, 24, 32, 7
WORLD = 3
JAX_ATOL = 1e-4
F64_RTOL = 1e-10


class _Simulated(temporal.TimeShard):
    """Rank `rank` of `size` whose exchange slices the whole input `full`
    (what the point-to-point sends would bring)."""

    def __init__(self, rank, size, full):
        self.group, self.rank, self.size = None, rank, size
        self.full, self.max_halo = full, 0

    def exchange(self, fr, need):
        lo, hi = need[self.rank]
        return self.full[:, :, lo:hi]


def _sharded_op(fn, x, n):
    """`fn(shard, frames)` on each of `n` simulated ranks' frames of `x`:
    [(its output Frames)]."""
    ranges = temporal.split_frames(x.shape[2], n)
    return [fn(_Simulated(r, n, x), temporal.Frames(x[:, :, a:b], ranges))
            for r, (a, b) in enumerate(ranges)]


def _assert_matches(outs, want, what):
    """Each rank's output equals its range of the unsharded output; the
    ranges cover it in order."""
    assert outs[-1].ranges[-1][1] == want.shape[2], what
    for r, out in enumerate(outs):
        a, b = out.ranges[r]
        assert out.x.shape == want[:, :, a:b].shape, (what, r)
        np.testing.assert_allclose(out.x.numpy(), want[:, :, a:b].numpy(),
                                   rtol=1e-12, atol=1e-12,
                                   err_msg=f"{what}: rank {r}")


def _unit(kernel, stride, seed=0):
    torch.manual_seed(seed)
    unit = Unit3D(4, 6, kernel, stride).double().eval()
    unit.batch3d.running_mean.normal_()
    unit.batch3d.running_var.uniform_(0.5, 2.0)
    return unit


OPS = {
    "stem 7/2": lambda: _unit((7, 7, 7), (2, 2, 2)),
    "unit 3/1": lambda: _unit((3, 3, 3), (1, 1, 1)),
    "unit 1/1": lambda: _unit((1, 1, 1), (1, 1, 1)),
    "pool 3/2": lambda: MaxPool3dSame((3, 3, 3), (2, 2, 2)),
    "pool 1,3/1,2": lambda: MaxPool3dSame((1, 3, 3), (1, 2, 2)),
    "pool 2/2": lambda: MaxPool3dSame((2, 2, 2), (2, 2, 2)),
    "pool 3/1": lambda: MaxPool3dSame((3, 3, 3), (1, 1, 1)),
}


@pytest.mark.parametrize("t,n", [(24, 3), (7, 2), (3, 5), (9, 4)])
@pytest.mark.parametrize("op", list(OPS))
def test_window_ops_match_unsharded(op, t, n):
    """Each windowed op on `n` ranks' frames of a `t`-frame input equals
    the unsharded op on the owner's range of outputs, empty ranges and
    reads across several ranks included."""
    module = OPS[op]()
    x = torch.from_numpy(np.random.default_rng(t * n).normal(
        size=(2, 4, t, 9, 8)))
    with torch.no_grad():
        want = module(x)
        outs = _sharded_op(lambda s, f: module(f, s), x, n)
    _assert_matches(outs, want, op)


@pytest.mark.parametrize("t,n", [(2, 3), (5, 2), (1, 2)])
def test_average_window_matches_unsharded(t, n):
    """The final (2, 7, 7) VALID average, its window clipped to the global
    T (1 frame: a window of 1), with empty ranks."""
    x = torch.from_numpy(np.random.default_rng(t).normal(
        size=(2, 4, t, 7, 7)))
    win = (min(2, t), 7, 7)
    pool = functools.partial(torch.nn.functional.avg_pool3d,
                             kernel_size=win, stride=1)
    want = window3d(x, win, (1, 1, 1), pool, same=False)
    _assert_matches(_sharded_op(lambda s, f: window3d(
        f, win, (1, 1, 1), pool, s, same=False), x, n), want, "avg")


def test_padding_reads_the_global_t():
    """T = 7 over 2 ranks (4 and 3 frames), a (3, 3, 3) / 2 Unit3D: the
    global T pads 1 frame in front, rank 0's 4 frames alone would pad
    none, so an op that read the local T (as `same_pad_3d(x.shape[2:])`
    does unsharded) would shift rank 0's outputs by one frame."""
    kernel, stride = (3, 3, 3), (2, 2, 2)
    assert same_pad_3d((7, 8, 8), kernel, stride)[4] == 1
    assert same_pad_3d((4, 8, 8), kernel, stride)[4] == 0
    unit = _unit(kernel, stride)
    x = torch.from_numpy(np.random.default_rng(7).normal(
        size=(1, 4, 7, 8, 8)))
    with torch.no_grad():
        outs = _sharded_op(lambda s, f: unit(f, s), x, 2)
        want = unit(x)
    assert [o.x.shape[2] for o in outs] == [2, 2]
    _assert_matches(outs, want, "unit 3/2")
    # what the local T would give: rank 0's own 4 frames padded as a clip
    local = unit(x[:, :, :4])
    assert not torch.allclose(local[:, :, :2], want[:, :, :2])


def test_split_and_output_ranges():
    """Contiguous splits, the first t % n ranks one frame longer; outputs
    owned by the owner of their first input frame, clipped to the global
    count, ranges emptied at depth."""
    assert temporal.split_frames(24, 3) == [(0, 8), (8, 16), (16, 24)]
    assert temporal.split_frames(7, 3) == [(0, 3), (3, 5), (5, 7)]
    assert temporal.split_frames(2, 3) == [(0, 1), (1, 2), (2, 2)]
    r = temporal.split_frames(24, 3)
    for stride, n_out, want in (
            (2, 12, [(0, 4), (4, 8), (8, 12)]),
            (1, 23, [(0, 8), (8, 16), (16, 23)])):
        assert temporal.output_ranges(r, stride, n_out) == want
    assert temporal.output_ranges([(0, 1), (1, 2), (2, 3)], 1, 2) == \
        [(0, 1), (1, 2), (2, 2)]


# --- the worker side ---------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _flax_i3d():
    """(flax I3D with the generator, variables), numpy-drawn, running
    statistics included."""
    import jax
    import jax.numpy as jnp

    from dmcnet_tpu.models.i3d import I3D, init_i3d_variables

    net = I3D(num_classes=NUM_CLASS, modality="flow+mp4",
              arch_estimator="DenseNetTiny")
    shapes = jax.eval_shape(lambda: init_i3d_variables(
        net, jax.random.key(0), jnp.zeros((1, T, HW, HW, 5))))
    v = draw_variables(shapes)
    v["batch_stats"] = jax.tree.map(np.abs, v["batch_stats"])
    return net, v


def _clip():
    return np.random.default_rng(1).normal(size=(B, T, HW, HW, 5)) \
        .astype(np.float32)


def _port_model(state_dict):
    from dmcnet_tpu_torch.models.i3d import get_symbol

    net, _ = get_symbol("I3D", modality="flow+mp4", num_classes=NUM_CLASS,
                        arch_estimator="DenseNetTiny", input_size=HW)
    net.load_state_dict(state_dict)
    return net.eval()


def _gather_frames(shard, fr):
    """The whole T axis of `fr` on every rank, for the check (the forward
    itself never gathers an activation)."""
    import torch.distributed as dist

    parts = [None] * shard.size
    dist.all_gather_object(parts, fr.x.cpu(), group=shard.group)
    return torch.cat(parts, dim=2)


def _worker(rank, world, port, out):
    import torch.distributed as dist

    from dmcnet_tpu_torch.parallel import multihost

    torch.set_num_threads(1)
    multihost.initialize_distributed(f"localhost:{port}", world, rank,
                                     device="cpu")
    net = _port_model(torch.load(os.path.join(out, "init.pt"),
                                 weights_only=True))
    clip = torch.from_numpy(_clip()).permute(0, 4, 1, 2, 3)
    net64 = _port_model(net.state_dict()).double()
    with torch.no_grad():
        want64 = net64(clip.double(), "flow+logit")
    pair = dist.new_group([0, 1])
    result = {"want64": want64}
    for name, group in (("3", None), ("2", pair)):
        if group is not None and rank >= 2:
            continue
        for dtype, model in (("f64", net64), ("f32", net)):
            shard = temporal.TimeShard(group)
            fr = shard.scatter(clip.to(model.conv3d_1a_7x7.conv3d.weight
                                       .dtype))
            logits, gen = temporal.time_sharded_forward(model, shard, fr)
            result[name, dtype] = {
                "logits": logits, "frames": fr.x.shape[2],
                "gen": _gather_frames(shard, temporal.Frames(gen,
                                                             fr.ranges)),
                "max_halo": shard.max_halo}
    torch.save(result, os.path.join(out, f"rank{rank}.pt"))
    multihost.shutdown()


# --- the JAX package's side ---------------------------------------------------


def _jax_reference():
    """`make_time_sharded_apply` of the flax I3D's `flow+logit` eval
    forward on a 2- and a 3-device CPU mesh: {n: (logits, gen NCTHW)}."""
    from concurrent.futures import ThreadPoolExecutor

    import jax

    from dmcnet_tpu.parallel import (
        make_time_mesh,
        make_time_sharded_apply,
        place_time_sharded,
    )

    net, variables = _flax_i3d()

    def run(n):
        mesh = make_time_mesh(jax.devices()[:n])
        apply_t = make_time_sharded_apply(
            lambda v, c: net.apply(v, c, "flow+logit", False, False), mesh)
        logits, gen = apply_t(*place_time_sharded(variables, _clip(), mesh))
        return n, (np.asarray(logits),
                   np.moveaxis(np.asarray(gen), -1, 1))

    with ThreadPoolExecutor(2) as pool:
        return dict(pool.map(run, (2, 3)))


# --- the test side -----------------------------------------------------------


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from dmcnet_tpu_torch.models.weights import state_dict_from_flax

    tmp = tmp_path_factory.mktemp("time_ranks")
    _, v = _flax_i3d()
    torch.save(state_dict_from_flax(v["params"], v["batch_stats"]),
               tmp / "init.pt")
    want = {}
    port = free_port()
    run_ranks([[sys.executable, os.path.abspath(__file__), str(r),
                str(WORLD), str(port), str(tmp)] for r in range(WORLD)],
              meanwhile=lambda: want.update(_jax_reference()))
    ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False)
             for r in range(WORLD)]
    return ranks, want


@pytest.mark.parametrize("n", ["3", "2"])
def test_time_sharded_forward_exact(runs, n):
    """The float64 forward over `n` ranks equals the unsharded forward at
    rtol 1e-10, logits on every rank and the generated flow gathered; each
    exchange brought in at most 7 frames (the stem's window), not a whole
    activation."""
    ranks, _ = runs
    for r, res in enumerate(ranks[:int(n)]):
        got = res[n, "f64"]
        want_logits, want_gen = res["want64"]
        np.testing.assert_allclose(got["logits"].numpy(),
                                   want_logits.numpy(), rtol=F64_RTOL,
                                   atol=1e-12, err_msg=f"rank {r}")
        np.testing.assert_allclose(got["gen"].numpy(), want_gen.numpy(),
                                   rtol=F64_RTOL, atol=1e-12)
        assert got["frames"] == T // int(n)
        assert 0 < got["max_halo"] <= 7


@pytest.mark.parametrize("n", ["3", "2"])
def test_time_sharded_forward_matches_jax(runs, n):
    """The float32 forward over `n` ranks against the JAX package's
    time-sharded program on `n` CPU devices, atol 1e-4."""
    ranks, want = runs
    logits, gen = want[int(n)]
    for r, res in enumerate(ranks[:int(n)]):
        got = res[n, "f32"]
        np.testing.assert_allclose(got["logits"].numpy(), logits,
                                   atol=JAX_ATOL, err_msg=f"rank {r}")
        np.testing.assert_allclose(got["gen"].numpy(), gen, atol=JAX_ATOL)
    assert float(np.abs(logits).max()) > 1e-2   # the check can fail


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]),
            sys.argv[4])
