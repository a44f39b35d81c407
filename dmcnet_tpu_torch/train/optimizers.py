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
