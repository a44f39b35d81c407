"""I3D training resumed from the JAX package's checkpoint files
(`train/checkpoints.load_i3d_checkpoint` on `dmcnet_tpu/train/
checkpoints.save_checkpoint` files), in float64.

The JAX state holds `make_i3d_optimizers` states after two updates on
random gradients and a random `grad_acc` (the torch `.grad` carry); then
each JAX optimizer updates on grad_acc + a new gradient, and the port's
optimizers, loaded from the file, step on their loaded `.grad` plus the
same gradient.  Parameters agree at tests/test_torch_i3d_train.py's
tolerances (rtol 1e-6, atol 1e-9).  Cases: Adam in stage 1 (the base
layers' slots placeholders) and SGD in stage 2; the stage-1 file is also
read into stage-2 optimizers (a resume at `--epoch-thre`), which restores
only the discriminator's state and the gradients.  The I3D's variables are
at flax's shapes for T=4, 48x48 (tests/test_torch_i3d_train.py
`_flax_i3d`).
"""

import functools

import numpy as np
import pytest
import torch
from test_torch_gan import dropout_off
from test_torch_i3d_train import _bridge64 as _i3d_bridge64
from test_torch_i3d_train import _flax_i3d
from test_torch_train import LR, NUM_CLASS, WD  # noqa: F401
from test_torch_train import _two_torch_threads  # noqa: F401 (autouse)

from dmcnet_tpu_torch.models import i3d as ti3d
from dmcnet_tpu_torch.models.weights import param_tree_from_flax
from dmcnet_tpu_torch.train import checkpoints as tckpt
from dmcnet_tpu_torch.train import optimizers as topt

I3D_RTOL, I3D_ATOL = 1e-6, 1e-9


# Adam in stage 1, SGD in stage 2; the stage-1 file is also read at
# --epoch-thre (stage-2 optimizers)
I3D_CASES = {"adam-stage1": ("adam", False), "sgd-stage2": ("sgd", True)}


@functools.lru_cache(maxsize=None)
def _jax_i3d_state(optim, stage2):
    """A JAX I3D TrainState (float64): `make_i3d_optimizers` states after
    two updates on random gradients, a random `grad_acc`; then each
    optimizer's update on grad_acc + a third gradient: (state as numpy,
    params after as numpy, the third gradient).  The updates run in one
    jitted program (eager JAX compiles each op of each leaf shape)."""
    import jax
    import jax.numpy as jnp

    from dmcnet_tpu.train.engine import TrainState
    from dmcnet_tpu.train.engine_i3d import make_i3d_optimizers

    _, params, stats = _flax_i3d()
    to64 = functools.partial(jax.tree.map, lambda a: np.asarray(
        a, np.float64))
    p = to64(params)
    opts = make_i3d_optimizers(p, optim=optim, lr_mul=0.5, has_gan=True,
                               stage2=stage2, freeze_base=not stage2)
    states = {k: jax.tree.map(lambda s: np.zeros(s.shape, s.dtype),
                              jax.eval_shape(o.init, p))
              for k, o in opts.items()}
    rng = np.random.default_rng(5)

    def grads():
        return jax.tree.map(lambda x: 1e-2 * rng.standard_normal(x.shape), p)

    with jax.enable_x64(True):
        @jax.jit
        def update(p, states, g):
            for k, o in opts.items():
                p, states[k] = o.update(g, states[k], p, jnp.float64(LR),
                                        jnp.float64(WD))
            return p, states

        for _ in range(2):
            p, states = update(p, states, grads())
        acc = grads()
        state = jax.tree.map(np.asarray, TrainState(
            params=p, batch_stats=to64(stats), opt_cls=states["cls"],
            opt_gf=states["gf"], opt_d=states["d"], grad_acc=acc))
        g3 = grads()
        p, _ = update(p, states, jax.tree.map(np.add, acc, g3))
        return state, jax.tree.map(np.asarray, p), g3


def _port_i3d64():
    net, _ = ti3d.get_symbol("I3D", modality="flow+mp4",
                             num_classes=NUM_CLASS,
                             arch_estimator="DenseNetTiny",
                             arch_d="Discriminator", input_size=48)
    return dropout_off(net).double()


@pytest.mark.parametrize("case", list(I3D_CASES))
def test_i3d_resume_from_jax(case, tmp_path):
    """`load_i3d_checkpoint` of a JAX I3D file: the stage read from the
    placeholders, Adam moments and counts or SGD buffers for the owned
    parameters only, `grad_acc` as `.grad`; each optimizer's next update
    on the carried gradient plus a new one equals the JAX package's.  A
    stage-1 file read into stage-2 optimizers keeps them fresh but the
    discriminator's, and restores the gradients."""
    from dmcnet_tpu.train.checkpoints import save_checkpoint

    optim, stage2 = I3D_CASES[case]
    state, want_params, g3 = _jax_i3d_state(optim, stage2)
    path = str(tmp_path / "run_ep-0002.pth")
    save_checkpoint(state, {"epoch": 2, "top1": 50.0}, path)
    model = _port_i3d64()
    opts = topt.make_i3d_optimizers(model, optim=optim, lr_mul=0.5,
                                    has_gan=True, stage2=stage2,
                                    freeze_base=not stage2)
    meta = tckpt.load_i3d_checkpoint(path, model, opts, stage2=stage2)
    assert meta == {"epoch": 2, "top1": 50.0, "stage2": stage2}
    base = model.conv3d_1a_7x7.conv3d.weight
    assert (base in opts["cls"].state) == stage2
    new = param_tree_from_flax(g3, state.params)
    for k, p in model.named_parameters():
        p.grad = p.grad + new[k].to(p.dtype)
    for o in opts.values():
        topt.adjust_learning_rate([o], LR, WD)
        o.step()
    want = _i3d_bridge64(want_params, {})
    for k, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[k].numpy(),
                                   rtol=I3D_RTOL, atol=I3D_ATOL, err_msg=k)

    if not stage2:  # the file of the epoch at --epoch-thre
        model2 = _port_i3d64()
        opts2 = topt.make_i3d_optimizers(model2, optim=optim, lr_mul=0.5,
                                         has_gan=True, stage2=True)
        tckpt.load_i3d_checkpoint(path, model2, opts2, stage2=True)
        assert not opts2["cls"].state and not opts2["gf"].state
        assert len(opts2["d"].state) == sum(
            1 for _ in model2.discriminator.parameters())
        acc = param_tree_from_flax(state.grad_acc, state.params)
        for k, p in model2.named_parameters():
            assert torch.equal(p.grad, acc[k]), k
