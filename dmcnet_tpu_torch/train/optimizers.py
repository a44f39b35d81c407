"""The reference's optimizers: torch Adam over lr_mult / decay_mult
parameter groups (counterpart of `dmcnet_tpu/train/optimizers.py`, whose
`GroupAdam` reimplements exactly this).

Reference code/dmcnet/train.py:121-142 gives each top-level module two
groups, non-bias parameters with decay_mult 1 and biases with decay_mult 0
(a BN `weight` keeps decay 1), and builds one Adam(eps=1e-3) for
`base_model` (lr_mult = lr_cls_mult) and one for `gen_flow_model` (lr_mult =
lr_mse_mult); the GAN variant a third for `discriminator` (lr_mult =
lr_d_mult, dmcnet_GAN/train.py:124-153).  Every epoch `adjust_learning_rate` sets each group's lr to
base_lr * lr_mult and its weight decay to wd * decay_mult (train.py:
398-408); torch Adam adds the decay to the gradient (L2, not AdamW).

The I3D trainer groups differently (`make_i3d_optimizers`, reference
code/dmcnet_I3D/train_model.py:69-179): by top-level module of the `I3D`,
weight decay on every parameter, biases included, Adam (eps 1e-8, or 1e-3
for the stage-2 generator and the discriminator) or nesterov SGD
(momentum 0.9), the torch optimizers the JAX package's `GroupAdam` and
`GroupSGD` reimplement.

Adam keeps its default implementation, not `fused=True`: it computes the
bias corrections on the host in float64, which is the behaviour the JAX
package reproduces (`dmcnet_tpu/train/optimizers.py:138-143`).
"""

from __future__ import annotations

import torch

ADAM_EPS = 1e-3


def step_decay_lr(base_lr, epoch, lr_steps, lr_decay):
    """Stepwise decay: lr * decay^(#steps passed) (reference
    train.py:398-400)."""
    passed = sum(1 for s in lr_steps if epoch >= s)
    return base_lr * (lr_decay ** passed)


def param_groups(module, lr_mult):
    """Two groups over `module`'s parameters: non-bias (decay_mult 1) and
    bias (decay_mult 0), both with `lr_mult`."""
    nonbias, bias = [], []
    for name, p in module.named_parameters():
        (bias if name.rsplit(".", 1)[-1] == "bias" else nonbias).append(p)
    return [{"params": nonbias, "lr_mult": lr_mult, "decay_mult": 1.0},
            {"params": bias, "lr_mult": lr_mult, "decay_mult": 0.0}]


def make_optimizers(model, lr_cls_mult, lr_mse_mult, lr_d_mult=None):
    """(opt_cls, opt_gf[, opt_d]): Adam(eps=1e-3) over `model.base_model`,
    `model.gen_flow_model` and, when `lr_d_mult` is given,
    `model.discriminator`.  Their lr and weight decay are set by
    `adjust_learning_rate` before the first step."""
    groups = [(model.base_model, lr_cls_mult),
              (model.gen_flow_model, lr_mse_mult)]
    if lr_d_mult is not None:
        groups.append((model.discriminator, lr_d_mult))
    return tuple(torch.optim.Adam(param_groups(module, mult), lr=0.0,
                                  eps=ADAM_EPS) for module, mult in groups)


def adjust_learning_rate(optimizers, lr, weight_decay):
    """lr * lr_mult and weight_decay * decay_mult into every group
    (reference train.py:402-408)."""
    for opt in optimizers:
        for group in opt.param_groups:
            group["lr"] = lr * group["lr_mult"]
            group["weight_decay"] = weight_decay * group["decay_mult"]


# Top-level modules of an `I3D` outside the classifier's optimizer, and the
# new layers that train at lr_mult 1 whatever the base layers' mult.
_I3D_OWN_OPTIMIZER = ("gen_flow_model", "discriminator")
_I3D_NEW_LAYERS = ("conv3d_0c_1x1", "classifier")


def make_i3d_optimizers(model, optim="adam", lr_mul=0.2, has_gan=False,
                        stage2=False, freeze_base=False):
    """{"cls", "gf"[, "d"]}: the I3D trainer's optimizers over `model` (an
    `I3D` with a generator), as `dmcnet_tpu/train/engine_i3d.py:44-81`:

      * "cls": every top-level module but the generator and the
        discriminator; `conv3d_0c_1x1` and `classifier` at lr_mult 1, the
        base layers at `lr_mul`, which is 0 under `freeze_base` (stage 1 of
        flow+mp4, reference model.py:273-277) and 1.0 in stage 2 when it is
        0.5 (model.py:278-281);
      * "gf": the generator, Adam eps 1e-8, or 1e-3 in stage 2
        (train_model.py:162-166);
      * "d" (`has_gan`): the discriminator, always Adam eps 1e-3
        (train_model.py:146-152).

    Every group has decay_mult 1: the I3D trainer decays biases too.  With
    `optim="sgd"` the first two are SGD(momentum 0.9, nesterov).  Their lr
    and weight decay are set by `adjust_learning_rate` before each step.
    The base layers stay in "cls" at lr_mult 0 while frozen, so that its
    `zero_grad` clears their gradients as the reference's does."""
    if freeze_base:
        base_mult = 0.0
    elif stage2 and lr_mul == 0.5:
        base_mult = 1.0
    else:
        base_mult = lr_mul
    new, base = [], []
    for name, child in model.named_children():
        if name not in _I3D_OWN_OPTIMIZER:
            (new if name in _I3D_NEW_LAYERS else base).extend(
                child.parameters())

    def groups(*pairs):
        return [{"params": params, "lr_mult": mult, "decay_mult": 1.0}
                for params, mult in pairs if params]

    def make(param_groups, eps=1e-8):
        if optim == "adam":
            return torch.optim.Adam(param_groups, lr=0.0, eps=eps)
        return torch.optim.SGD(param_groups, lr=0.0, momentum=0.9,
                               nesterov=True)

    opts = {
        "cls": make(groups((base, base_mult), (new, 1.0))),
        "gf": make(groups((list(model.gen_flow_model.parameters()), 1.0)),
                   eps=1e-3 if stage2 else 1e-8),
    }
    if has_gan:
        opts["d"] = torch.optim.Adam(
            groups((list(model.discriminator.parameters()), 1.0)), lr=0.0,
            eps=1e-3)
    return opts
