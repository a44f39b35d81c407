"""The port's models (dmcnet_tpu_torch/models) against the flax DMCNet:
weights initialised in flax from a seed (BN statistics and affine drawn
with numpy), bridged by `state_dict_from_flax`, then the same inputs through
both.  Eval logits and `generate` agree at rtol=1e-4, atol=2e-4 (float32 on
the CPU; the two frameworks sum convolutions in different orders)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_train import _two_torch_threads  # noqa: F401
from test_torch_train import flax_init

from dmcnet_tpu.models import DMCNet as FlaxDMCNet
from dmcnet_tpu_torch.models.tsn import DMCNet, segment_consensus
from dmcnet_tpu_torch.models.weights import state_dict_from_flax

RTOL, ATOL = 1e-4, 2e-4


def _randomise_bn(params, stats, rng):
    """Non-trivial BN: scale/bias/mean/var from numpy (flax inits them to
    1/0/0/1, which would hide a swapped or dropped BN leaf)."""
    out_p, out_s = {}, {}
    for k, v in params.items():
        if isinstance(v, dict):
            out_p[k], out_s[k] = _randomise_bn(v, stats.get(k, {}), rng)
        else:
            out_p[k] = np.asarray(v)
    for k, v in stats.items():
        if k in ("mean", "var"):
            shape = np.asarray(v).shape
            out_s[k] = (rng.uniform(0.5, 1.5, shape) if k == "var"
                        else rng.normal(0, 0.1, shape)).astype(np.float32)
            out_p["scale"] = rng.uniform(0.5, 1.5, shape).astype(np.float32)
            out_p["bias"] = rng.normal(0, 0.1, shape).astype(np.float32)
    return out_p, out_s


@pytest.mark.parametrize("arch_estimator", ["DenseNetTiny", "DenseNetSmall"])
def test_dmcnet_matches_flax(arch_estimator):
    hw, n, num_class = 64, 2, 7
    fmodel = FlaxDMCNet(num_class=num_class, num_segments=1,
                        arch_estimator=arch_estimator, gen_flow_or_delta=1)
    variables = flax_init(
        fmodel, jax.random.key(0), jnp.zeros((1, 1, hw, hw, 2)),
        jnp.zeros((1, 1, hw, hw, 3)), train=False)
    rng = np.random.default_rng(0)
    params, stats = _randomise_bn(jax.tree.map(np.asarray,
                                               variables["params"]),
                                  jax.tree.map(np.asarray,
                                               variables["batch_stats"]),
                                  rng)
    mv = rng.normal(0, 1, (n, hw, hw, 2)).astype(np.float32)
    res = rng.normal(0, 1, (n, hw, hw, 3)).astype(np.float32)
    logits_f, gen_f = jax.jit(fmodel.apply, static_argnames="train")(
        {"params": params, "batch_stats": stats}, mv[:, None], res[:, None],
        train=False)

    model = DMCNet(num_class, arch_estimator=arch_estimator,
                   gen_flow_or_delta=1)
    model.load_state_dict(state_dict_from_flax(params, stats))
    model.eval()
    with torch.no_grad():
        logits_t, gen_t = model(torch.from_numpy(mv).permute(0, 3, 1, 2),
                                torch.from_numpy(res).permute(0, 3, 1, 2))
    np.testing.assert_allclose(gen_t.permute(0, 2, 3, 1).numpy(),
                               np.asarray(gen_f), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(logits_t.numpy(), np.asarray(logits_f),
                               rtol=RTOL, atol=ATOL)
    assert np.abs(np.asarray(logits_f)).max() > 1e-2  # not a vacuous match


def test_segment_consensus_matches_flax():
    from dmcnet_tpu.models.tsn import segment_consensus as flax_consensus

    x = np.random.default_rng(1).normal(size=(6, 5)).astype(np.float32)
    np.testing.assert_allclose(
        segment_consensus(torch.from_numpy(x), 3).numpy(),
        np.asarray(flax_consensus(jnp.asarray(x), 3)), rtol=1e-6)
