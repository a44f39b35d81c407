"""I3D train and eval steps (counterpart of `dmcnet_tpu/train/engine_i3d.py`),
after the reference MFNet-derived trainer
(code/dmcnet_I3D/train/model.py:286-491):

  * gradient accumulation over the microbatches of a macro step (the
    reference's `--iter-size`), one microbatch resident at a time: each
    backward adds its un-divided sum into `.grad`;
  * the D phase: loss = cls + adv * CE(validity, [0..0, 1..1]), validity
    from one discriminator forward over fake‖real, the generated cue and
    the flow flattened over B*T (model.py:354-408); the classifier's
    optimizer steps at `lr1` and the discriminator's at `lr_d`;
  * the G phase: loss = cls_w * cls + mse + adv * CE(validity, [0..0,
    1..1]), with cls_w = 0 in epoch 0 when a GAN is on (`drop_cls`,
    model.py:430-434) and the same D-style labels, a quirk of the
    reference kept on purpose (its G loss reuses the D phase's loss_adv);
    the generator's optimizer steps, and the classifier's too when there is
    no GAN (model.py:411-491);
  * the torch `.grad` carry (model.py:401-404,483-485): each optimizer's
    gradients are zeroed only right after that optimizer steps, so the
    generator's D-phase gradients reach the next G step, and the
    classifier's and the discriminator's G-phase gradients the next D step.
    At a step only the stepping optimizers' gradients (carry plus this
    phase's sums) are divided by the microbatch count; the others keep
    their un-divided sums.  Scaling the loss by 1/iter_size before the
    backward would give another result once a carry crosses a phase.

The whole model is in train mode in both phases, so BatchNorm statistics
thread across the microbatches and through the discriminator's forward.
The cue reaches the stem undetached (the reference's fit loop never passes
its `detach` flag to the network): the classifier loss trains the
generator.  `stop_gradient=True` cuts that path, the JAX package's opt-in,
non-reference fast mode.

The JAX package's `make_i3d_chunked_steps` and its `lax.scan` over a
stacked microbatch axis are not ported: they exist because the clip-64 x
batch-3 x iter-32 stack did not fit one TPU chip, and here accumulation is
sequential already.

Batches are dicts of NCTHW tensors `mv` (B, 2, T, H, W), `residual` (B, 3,
T, H, W), `flow` (B, 2, T, H, W) and (B,) `label`, as
`data.video_iter.i3d_augment_batch` returns them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from dmcnet_tpu_torch.train.engine import _autocast, topk_correct
from dmcnet_tpu_torch.train.optimizers import adjust_learning_rate


def _frames(x):
    """(B, C, T, H, W) -> (B*T, C, H, W), b-major as the JAX package's
    (B, T, H, W, C) reshape."""
    b, c, t, h, w = x.shape
    return x.permute(0, 2, 1, 3, 4).reshape(b * t, c, h, w)


def _fake_real_labels(n, device):
    return torch.cat([torch.zeros(n, dtype=torch.long),
                      torch.ones(n, dtype=torch.long)]).to(device)


def make_i3d_steps(model, opts, *, adv, train_backbone=True,
                   stop_gradient=False, bf16=False):
    """-> (d_step, g_step) over `model` (an `I3D` with a generator, and a
    discriminator when `opts` has "d") and `opts` of
    `make_i3d_optimizers`.  Each is

        step(microbatches, lr, lr1, lr_d, wd, drop_cls) -> metrics

    over an iterable of batches (one macro step): `lr` is the generator's
    lr, `lr1` the classifier's, `lr_d` the discriminator's, `wd` the
    weight decay; `drop_cls` zeroes the G loss's classification term when
    a GAN is on.  Metrics are the microbatches' means, 0-d tensors on the
    batch's device: {loss, loss_cls, loss_adv, top1, top5, acc_D_adv} for
    D, {loss, loss_cls, loss_mse[, loss_adv], top1, top5} for G.

    `train_backbone=False` is stage 1 under `--detach`: the classifier's
    parameters take no gradient during the step (activation gradients
    still flow through them into the generator) and its optimizer does not
    step.  Its parameters come out as the full step's at `lr1 = 0`.
    `bf16` runs the forwards under bfloat16 autocast; losses are float32."""
    has_gan = "d" in opts
    cls_params = [p for g in opts["cls"].param_groups for p in g["params"]]

    def set_lrs(lr, lr1, lr_d, wd):
        adjust_learning_rate([opts["cls"]], lr1, wd)
        adjust_learning_rate([opts["gf"]], lr, wd)
        if has_gan:
            adjust_learning_rate([opts["d"]], lr_d, wd)

    def forward(mb, with_adv):
        mv_res = torch.cat([mb["mv"], mb["residual"]], dim=1)
        flow = mb["flow"]
        with _autocast(flow.device, bf16):
            logits, gen = model(mv_res, "flow+logit", detach=stop_gradient)
            adv_logits = None
            if with_adv:
                adv_logits = model(torch.cat([_frames(gen), _frames(flow)]),
                                   "D").to(flow.dtype)
        return logits.to(flow.dtype), gen.to(flow.dtype), adv_logits

    def accumulate(microbatches, loss_fn):
        """Backward of every microbatch into `.grad`; the metrics' means
        and the microbatch count."""
        model.train()
        frozen = [] if train_backbone else [p for p in cls_params
                                            if p.requires_grad]
        for p in frozen:
            p.requires_grad_(False)
        sums, n = {}, 0
        try:
            for mb in microbatches:
                loss, metrics = loss_fn(mb)
                loss.backward()
                for k, v in metrics.items():
                    v = v.detach()
                    sums[k] = sums[k] + v if k in sums else v
                n += 1
        finally:
            for p in frozen:
                p.requires_grad_(True)
        if not n:
            raise ValueError("a macro step needs at least one microbatch")
        return {k: v / n for k, v in sums.items()}, n

    def apply(stepping, n):
        """Divide the stepping optimizers' gradients (carry + sums) by the
        microbatch count, step them, zero their gradients; every other
        gradient stays as it is for the next phase."""
        for opt in stepping:
            for group in opt.param_groups:
                for p in group["params"]:
                    if p.grad is not None:
                        p.grad.div_(n)
            opt.step()
            opt.zero_grad(set_to_none=False)

    def d_loss(mb):
        labels = mb["label"]
        logits, _, adv_logits = forward(mb, with_adv=True)
        adv_labels = _fake_real_labels(adv_logits.shape[0] // 2,
                                       labels.device)
        loss_cls = F.cross_entropy(logits, labels)
        loss_adv = F.cross_entropy(adv_logits, adv_labels)
        loss = loss_cls + adv * loss_adv
        top1, top5 = topk_correct(logits.detach(), labels)
        (acc,) = topk_correct(adv_logits.detach(), adv_labels, (1,))
        return loss, {"loss": loss, "loss_cls": loss_cls,
                      "loss_adv": loss_adv, "top1": top1, "top5": top5,
                      "acc_D_adv": acc}

    def g_loss(drop_cls):
        cls_w = 0.0 if (drop_cls and has_gan) else 1.0

        def fn(mb):
            labels = mb["label"]
            logits, gen, adv_logits = forward(mb, with_adv=has_gan)
            loss_cls = F.cross_entropy(logits, labels)
            loss_mse = F.mse_loss(gen, mb["flow"])
            loss = cls_w * loss_cls + loss_mse
            metrics = {"loss_cls": loss_cls, "loss_mse": loss_mse}
            if has_gan:
                adv_labels = _fake_real_labels(adv_logits.shape[0] // 2,
                                               labels.device)
                metrics["loss_adv"] = F.cross_entropy(adv_logits, adv_labels)
                loss = loss + adv * metrics["loss_adv"]
            top1, top5 = topk_correct(logits.detach(), labels)
            metrics.update({"loss": loss, "top1": top1, "top5": top5})
            return loss, metrics

        return fn

    def d_step(microbatches, lr, lr1, lr_d, wd, drop_cls):
        del drop_cls  # the D phase always keeps the cls term (model.py:389)
        if not has_gan:
            raise ValueError("the D step needs a discriminator optimizer")
        set_lrs(lr, lr1, lr_d, wd)
        metrics, n = accumulate(microbatches, d_loss)
        apply(([opts["cls"]] if train_backbone else []) + [opts["d"]], n)
        return metrics

    def g_step(microbatches, lr, lr1, lr_d, wd, drop_cls):
        set_lrs(lr, lr1, lr_d, wd)
        metrics, n = accumulate(microbatches, g_loss(drop_cls))
        stepping = [opts["gf"]]
        if not has_gan and train_backbone:
            stepping.insert(0, opts["cls"])
        apply(stepping, n)
        return metrics

    return d_step, g_step


def make_i3d_eval_step(model):
    """step(batch) -> {logits, label, top1, top5}: the `flow+logit`
    forward of `model` (an `I3D` with a generator) in eval mode on the
    batch's [mv, residual] channels (NCTHW), as
    `dmcnet_tpu/train/engine_i3d.py:413-426`."""

    @torch.no_grad()
    def step(batch):
        model.eval()
        mv_res = torch.cat([batch["mv"], batch["residual"]], dim=1)
        logits, _ = model(mv_res, "flow+logit")
        top1, top5 = topk_correct(logits, batch["label"], (1, 5))
        return {"logits": logits, "label": batch["label"], "top1": top1,
                "top5": top5}

    return step
