"""The packed layer (dmcnet_tpu_torch/ops/packed_generator.py,
ops/packed_resnet.py, `_DenseEstimator(packed=s)`, `DMCPredictor(pack=True)`)
against the JAX package's on the CPU, with the same numpy-seeded inputs and
weights from flax init bridged by `state_dict_from_flax`.

Tolerances:
  * layouts, packed weights, the stem pack, BN folding, the folded weights
    and the bias planes: bit-equal (the same float32/float64 operations in
    the same order);
  * `PackedDenseEstimator(dtype=float32)`: atol 2e-4, the border ring
    included (the JAX package's own, tests/test_packed_generator.py);
    `PackedResNet18` in float32: rtol = atol = 2e-4
    (tests/test_packed_resnet.py);
  * the packed `_DenseEstimator` in float64 against the unpacked one,
    forward and parameter gradients: rtol 1e-10; odd shapes fall back and
    are equal;
  * `QuantizedPackedEstimator`: under 5% mean relative error against
    float32 (the JAX package's bound), and within 1% mean relative of the
    JAX package's quantized output (the calibration's float32 maxima differ
    in the last bits, which can move an activation across a rounding
    boundary of its int8 grid);
  * `DMCPredictor(pack=True)` in bfloat16: u8 outputs bit-equal; logits and
    video scores within atol 2e-2 (bfloat16 has 8 significant bits and the
    two packages round the folded-normalize bias plane at different
    points; the JAX package's own packed mesh test allows 1e-2 between two
    XLA programs).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmcnet_tpu.models import DMCNet as FlaxDMCNet
from dmcnet_tpu.ops import packed_generator as jpg
from dmcnet_tpu.ops import packed_resnet as jpr
from dmcnet_tpu.serving import DMCPredictor as JaxPredictor
from dmcnet_tpu_torch.codec.mpeg4 import VideoReader
from dmcnet_tpu_torch.models.generators import make_estimator
from dmcnet_tpu_torch.models.resnet import resnet18
from dmcnet_tpu_torch.models.weights import state_dict_from_flax
from dmcnet_tpu_torch.ops import packed_generator as tpg
from dmcnet_tpu_torch.ops import packed_resnet as tpr
from dmcnet_tpu_torch.ops.backtrace import cell_mv_from_blocks
from dmcnet_tpu_torch.serving import DMCPredictor
from test_torch_serving import _encode_panning
from test_torch_train import _two_torch_threads  # noqa: F401 (autouse)

GEN_ATOL = 2e-4
RES_RTOL = RES_ATOL = 2e-4
F64_RTOL = 1e-10
QUANT_REL, QUANT_JAX_REL = 0.05, 0.01
BF16_ATOL = 2e-2
NUM_CLASS, HW = 7, 64
# the serving normalize as an affine, the way the JAX predictor builds it
STD = np.array([0.229, 0.224, 0.225], np.float32)
AFFINE = (np.concatenate([[1.0 / (255.0 * float(STD.mean()))] * 2,
                          1.0 / (255.0 * STD)]),
          np.concatenate([[-0.5 / float(STD.mean())] * 2, -0.5 / STD]))


def nhwc(t):
    return t.permute(0, 2, 3, 1).detach().numpy()


def nchw(a):
    return torch.from_numpy(np.array(a)).permute(0, 3, 1, 2)


@pytest.fixture(scope="module")
def flax_variables():
    """One flax DMCNet (DenseNetTiny + ResNet-18) initialisation, shared by
    the module's tests: numpy trees and the port's state_dict."""
    model = FlaxDMCNet(num_class=NUM_CLASS, num_segments=1,
                       arch_estimator="DenseNetTiny", gen_flow_or_delta=1)
    variables = jax.jit(model.init, static_argnames="train")(
        jax.random.key(0), jnp.zeros((1, 1, HW, HW, 2)),
        jnp.zeros((1, 1, HW, HW, 3)), train=False)
    variables = jax.tree.map(np.asarray, variables)
    return variables, state_dict_from_flax(variables["params"],
                                           variables["batch_stats"])


def _sub(sd, prefix):
    return {k[len(prefix) + 1:]: v for k, v in sd.items()
            if k.startswith(prefix + ".")}


@pytest.fixture(scope="module")
def tiny(flax_variables):
    """(flax params, the port's estimator) with the same weights."""
    variables, sd = flax_variables
    est = make_estimator("DenseNetTiny")
    est.load_state_dict(_sub(sd, "gen_flow_model"))
    return variables["params"]["gen_flow_model"], est


@pytest.mark.parametrize("s", [2, 4])
def test_layouts_bit_equal(s):
    x = np.random.default_rng(s).normal(size=(2, 16, 24, 5)) \
        .astype(np.float32)
    packed = tpg.space_to_depth(nchw(x), s)
    want = np.asarray(jpg.space_to_depth(jnp.asarray(x), s))
    np.testing.assert_array_equal(nhwc(packed), want)
    np.testing.assert_array_equal(nhwc(tpg.depth_to_space(packed, s)), x)
    np.testing.assert_array_equal(
        nhwc(tpg.repack(tpg.space_to_depth(nchw(x), 4), 4, s, 5)),
        np.asarray(jpg.repack(jpg.space_to_depth(jnp.asarray(x), 4), 4, s,
                              5)))


@pytest.mark.parametrize("chain", [(5, (8, 8, 6, 4, 2)),
                                   (5, (32, 32, 24, 16, 8)),
                                   (16, (4, 6, 2))],
                         ids=["tiny", "small", "early_fusion"])
def test_pack_conv3x3_bit_equal(chain):
    """Each layer of a dense chain, s = 2 and 4: the numpy pack equals the
    JAX package's after HWIO -> OIHW, and `pack_conv3x3_torch` equals the
    numpy pack."""
    c0, widths = chain
    rng = np.random.default_rng(c0)
    segments = [c0]
    for c_out in list(widths) + [2]:
        w = rng.normal(size=(3, 3, sum(segments), c_out)).astype(np.float32)
        b = rng.normal(size=c_out).astype(np.float32)
        w_oihw = np.ascontiguousarray(w.transpose(3, 2, 0, 1))
        for s in (2, 4):
            wj, bj = jpg.pack_conv3x3(w, b, s, segments)
            wp, bp = tpg.pack_conv3x3(w_oihw, b, s, segments)
            np.testing.assert_array_equal(wp, wj.transpose(3, 2, 0, 1))
            np.testing.assert_array_equal(bp, bj)
            wt, bt = tpg.pack_conv3x3_torch(torch.from_numpy(w_oihw),
                                            torch.from_numpy(b), s, segments)
            np.testing.assert_array_equal(wt.numpy(), wp)
            np.testing.assert_array_equal(bt.numpy(), bp)
        segments = [c_out] + segments


def test_stem_pack_and_bn_fold_bit_equal():
    from dmcnet_tpu_torch.models.layers import batch_norm

    rng = np.random.default_rng(1)
    w = rng.normal(size=(7, 7, 2, 64)).astype(np.float32)
    np.testing.assert_array_equal(
        tpr.pack_stem_conv(np.ascontiguousarray(w.transpose(3, 2, 0, 1))),
        jpr.pack_stem_conv(w).transpose(3, 2, 0, 1))
    stats = {k: np.abs(rng.normal(0.5, 0.2, 64)).astype(np.float32) + 0.1
             for k in ("scale", "bias", "mean", "var")}
    bn = batch_norm(64)
    with torch.no_grad():
        for name, k in (("weight", "scale"), ("bias", "bias"),
                        ("running_mean", "mean"), ("running_var", "var")):
            getattr(bn, name).copy_(torch.from_numpy(stats[k]))
    wj, bj = jpr.fold_bn(w, {"scale": stats["scale"], "bias": stats["bias"]},
                         {"mean": stats["mean"], "var": stats["var"]})
    wt, bt = tpr.fold_bn(torch.from_numpy(w.transpose(3, 2, 0, 1)), bn)
    np.testing.assert_array_equal(wt, wj.transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(bt, bj)


@pytest.mark.parametrize("s", [2, 4])
def test_folded_weights_and_bias_planes_bit_equal(tiny, s):
    """Fused and folded packed weights, and every layer's bias plane at two
    shapes (the border ring included), equal the JAX package's."""
    params, est = tiny
    kw = dict(s=s, fuse_mv_delta=True, input_affine=AFFINE)
    want = jpg.PackedDenseEstimator(params, dtype=jnp.float32, **kw)
    got = tpg.PackedDenseEstimator(est, dtype=torch.float32, **kw)
    for i, (wj, bj) in enumerate(want.weights):
        wt, bt = got.layer(i)
        np.testing.assert_array_equal(wt.numpy(),
                                      np.asarray(wj).transpose(3, 2, 0, 1))
        np.testing.assert_array_equal(bt.numpy(), np.asarray(bj))
        for hh, ww in ((4, 6), (16 // s, 16 // s)):
            np.testing.assert_array_equal(
                got.bias_plane(i, hh, ww, "cpu").numpy(),
                want._bias_plane(i, bj, hh, ww).transpose(2, 0, 1))


@pytest.mark.parametrize("affine", [False, True], ids=["raw", "affine"])
@pytest.mark.parametrize("fuse", [False, True], ids=["nofuse", "fuse"])
@pytest.mark.parametrize("s", [2, 4])
def test_packed_estimator_matches_jax(tiny, s, fuse, affine):
    params, est = tiny
    rng = np.random.default_rng(s)
    x = rng.integers(0, 256, size=(2, 16, 16, 5)).astype(np.float32)
    if not affine:
        x = x / 128.0 - 1.0
    kw = dict(s=s, fuse_mv_delta=fuse,
              input_affine=AFFINE if affine else None)
    want = np.asarray(jpg.PackedDenseEstimator(params, dtype=jnp.float32,
                                               **kw)(jnp.asarray(x)))
    gen = tpg.PackedDenseEstimator(est, dtype=torch.float32, **kw)
    got = nhwc(gen(nchw(x)))
    np.testing.assert_allclose(got, want, atol=GEN_ATOL)
    ring = np.ones(want.shape[1:3], bool)
    ring[1:-1, 1:-1] = False
    np.testing.assert_allclose(got[:, ring], want[:, ring], atol=GEN_ATOL)
    # packed_output is the same result before depth_to_space
    gen.packed_output = True
    np.testing.assert_array_equal(
        nhwc(tpg.depth_to_space(gen(nchw(x)), s)), got)


def test_packed_resnet18_matches_jax(flax_variables):
    """BN statistics drawn so that the folding is not trivial and the
    activations stay alive: the logits must depend on the input."""
    variables, _ = flax_variables
    rng = np.random.default_rng(2)
    params = variables["params"]["base_model"]
    stats = jax.tree_util.tree_map_with_path(
        lambda path, v: (rng.uniform(0.5, 1.5, v.shape)
                         if path[-1].key == "var"
                         else rng.normal(0.0, 0.1, v.shape))
        .astype(np.float32), variables["batch_stats"]["base_model"])
    sd = state_dict_from_flax({"base_model": params}, {"base_model": stats})
    net = resnet18(NUM_CLASS)
    net.load_state_dict(_sub(sd, "base_model"))
    net.eval()
    x = rng.normal(size=(2, 32, 32, 2)).astype(np.float32)
    xp = jpg.space_to_depth(jnp.asarray(x), 2)
    want = np.asarray(jax.jit(jpr.PackedResNet18(
        {"params": params, "batch_stats": stats}, dtype=jnp.float32))(xp))
    got = tpr.PackedResNet18(net, dtype=torch.float32)(
        nchw(np.asarray(xp)))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=RES_RTOL,
                               atol=RES_ATOL)
    assert np.abs(want[0] - want[1]).max() > 100 * RES_ATOL
    # and the unfolded module on the unpacked input
    with torch.no_grad():
        np.testing.assert_allclose(got.numpy(), net(nchw(x)).numpy(),
                                   rtol=RES_RTOL, atol=RES_ATOL)


@pytest.mark.parametrize("arch,s", [("DenseNetTiny", 2), ("DenseNetTiny", 4),
                                    ("DenseNetSmall", 2)])
def test_packed_training_forward_and_grads_float64(arch, s):
    torch.manual_seed(0)
    plain = make_estimator(arch).double()
    packed = make_estimator(arch, packed=s).double()
    packed.load_state_dict(plain.state_dict())
    assert plain.state_dict().keys() == packed.state_dict().keys()
    x = torch.randn(2, 5, 16, 24, dtype=torch.float64)
    outs = []
    for m in (plain, packed):
        y = m(x)
        (y ** 2).mean().backward()
        outs.append((y.detach(), {k: p.grad for k, p in
                                  m.named_parameters()}))
    torch.testing.assert_close(outs[1][0], outs[0][0], rtol=F64_RTOL,
                               atol=0)
    for k, g in outs[0][1].items():
        torch.testing.assert_close(outs[1][1][k], g, rtol=F64_RTOL,
                                   atol=F64_RTOL * float(g.abs().max()),
                                   msg=k)
    # H or W not divisible by s: the unpacked path, exactly
    odd = torch.randn(1, 5, 15, 17, dtype=torch.float64)
    with torch.no_grad():
        assert torch.equal(packed(odd), plain(odd))


def test_quantized_estimator(tiny):
    """Within 5% of float32 and 1% of the JAX package's int8 output; the
    card's int8 GEMM route gives the float64 route's sums exactly (here on
    the CPU's `torch._int_mm`)."""
    params, est = tiny
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 16, 16, 5)).astype(np.float32)
    q = tpg.QuantizedPackedEstimator(est, nchw(x), s=2)
    with torch.no_grad():
        ref = nhwc(est(nchw(x)))
        got = nhwc(q(nchw(x)))
        gemm = nhwc(q(nchw(x), int_conv=tpg.int_conv3x3_gemm))
    np.testing.assert_array_equal(gemm, got)
    rel = np.abs(got - ref).mean() / np.abs(ref).mean()
    assert rel < QUANT_REL, rel
    want = np.asarray(jax.jit(jpg.QuantizedPackedEstimator(
        params, calib_x=x, s=2))(jnp.asarray(x)))
    rel_jax = np.abs(got - want).mean() / np.abs(want).mean()
    print(f"int8 vs float32 {rel:.4f}, vs the JAX package {rel_jax:.2e}")
    assert rel_jax < QUANT_JAX_REL, rel_jax
    h_q = torch.from_numpy(rng.integers(-127, 128, size=(2, 13, 6, 10))
                           .astype(np.int8))
    w_q = torch.from_numpy(rng.integers(-127, 128, size=(5, 13, 3, 3))
                           .astype(np.int8))
    assert torch.equal(tpg.int_conv3x3_gemm(h_q, w_q),
                       tpg.int_conv3x3_f64(h_q, w_q))


@pytest.fixture(scope="module")
def predictors(flax_variables):
    """(JAX pack=True predictor, the port's pack=True and pack=False
    predictors on the CPU), same weights."""
    variables, sd = flax_variables
    jp = JaxPredictor(variables["params"], variables["batch_stats"],
                      num_class=NUM_CLASS, input_size=HW)
    kw = dict(num_class=NUM_CLASS, input_size=HW, device="cpu")
    return jp, DMCPredictor(sd, **kw), DMCPredictor(sd, pack=False, **kw)


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    d = tmp_path_factory.mktemp("packed_clips")
    paths = []
    for i, (n, h, w) in enumerate([(26, 64, 96), (14, 64, 96)]):
        p = str(d / f"v{i}.avi")
        _encode_panning(p, np.random.default_rng(30 + i), n=n, h=h, w=w)
        paths.append(p)
    return paths


def test_predictor_pack_matches_jax(predictors, clips):
    """The folded bfloat16 chunk program against the JAX package's: u8
    outputs bit-equal, logits within BF16_ATOL, and so the video scores;
    the float32 forward within BF16_ATOL of the packed one."""
    jp, tp, unpacked = predictors
    assert tp.packed is not None and tp.packed_cls is not None
    assert unpacked.packed is None
    rows = []
    with VideoReader(clips[0]) as rd:
        h, w = rd.height, rd.width
        for g in range(rd.num_gops):
            frames, _, blocks, n_blocks = rd.decode_gop_blocks(
                g, skip_dense=True)
            if len(frames) < 2:
                continue
            cm, cell = cell_mv_from_blocks(blocks, n_blocks, h, w)
            pick = np.array([1, 6, len(frames) - 1])
            rows.append((cm, cell, frames[0],
                         tp._center_crop(frames[pick]), pick))
    arrays = tp._pack_rows(rows, 4, 12, h, w, cell, 3)
    logits_t, mv_t, res_t = tp._gop_program(4, 12, h, w, cell, 3)(
        *tp._to_device(arrays))
    buf = jp._pack_gop_buffer(*arrays[:3], arrays[3].astype(np.uint8))
    logits_j, mv_j, res_j = jp._gop_program(4, 12, h, w, cell, 3)(
        jnp.asarray(buf))
    np.testing.assert_array_equal(mv_t.numpy(), np.asarray(mv_j))
    np.testing.assert_array_equal(res_t.numpy(), np.asarray(res_j))
    want = np.asarray(logits_j, np.float32)
    err = float(np.abs(logits_t.numpy() - want).max())
    print(f"packed logits vs JAX: max |diff| {err:.3g}, max |logit| "
          f"{float(np.abs(want).max()):.3g} (atol {BF16_ATOL})")
    np.testing.assert_allclose(logits_t.numpy(), want, atol=BF16_ATOL)
    np.testing.assert_allclose(
        unpacked._gop_program(4, 12, h, w, cell, 3)(
            *unpacked._to_device(arrays))[0].numpy(), want, atol=BF16_ATOL)
    got = tp.predict_videos(clips, chunk_gops=4)
    for a, b in zip(got, jp.predict_videos(clips, chunk_gops=4)):
        np.testing.assert_allclose(a, np.asarray(b, np.float32),
                                   atol=BF16_ATOL)


def test_predictor_pack_over_a_mesh_and_serve(predictors, clips, tmp_path):
    """`pack=True` over a mesh of 2 CPU replicas (each with its packed
    modules) scores as one predictor; `serve` packs by default and
    `--no-pack` serves the float32 forward, each equal to its predictor."""
    from dmcnet_tpu_torch.cli import serve

    _, tp, unpacked = predictors
    mesh = DMCPredictor(tp.model.state_dict(), num_class=NUM_CLASS,
                        input_size=HW, mesh=["cpu", "cpu"])
    assert len(mesh.packed) == len(mesh.packed_cls) == 2
    assert mesh.packed[1] is not mesh.packed[0]
    want = tp.predict_videos(clips, chunk_gops=4)
    for a, b in zip(mesh.predict_videos(clips, chunk_gops=4), want):
        np.testing.assert_allclose(a, b, atol=BF16_ATOL)
    ckpt = tmp_path / "w.pth"
    torch.save(tp.model.state_dict(), ckpt)
    base = ["--weights", str(ckpt), "--num-class", str(NUM_CLASS),
            "--input_size", str(HW), "--chunk-gops", "4", "--device", "cpu"]
    for flags, pred in (([], tp), (["--no-pack"], unpacked)):
        for a, b in zip(serve.main(base + flags + clips),
                        pred.predict_videos(clips, chunk_gops=4)):
            np.testing.assert_array_equal(a, b)


def test_pack_branches():
    """JAX's branches: another classifier packs the generator alone (no
    fold, no fusion), another estimator packs nothing; the non-ResNet-18
    forward adds the float32 mv and runs the model's classifier."""
    kw = dict(num_class=NUM_CLASS, input_size=32, device="cpu")
    r34 = DMCPredictor(arch="resnet34", **kw)
    assert r34.packed_cls is None and not r34.packed[0].packed_output
    assert r34.packed[0].input_affine is None
    ctx = DMCPredictor(arch_estimator="ContextNetwork", **kw)
    assert ctx.packed is None
    mv = torch.randint(0, 256, (2, 32, 32, 2), dtype=torch.uint8)
    res = torch.randint(0, 256, (2, 32, 32, 3), dtype=torch.uint8)
    unpacked = DMCPredictor(r34.model.state_dict(), arch="resnet34",
                            pack=False, **kw)
    np.testing.assert_allclose(r34._forward_u8(mv, res).numpy(),
                               unpacked._forward_u8(mv, res).numpy(),
                               atol=BF16_ATOL)
