"""Alternating D/G train steps of the dmcnet_GAN variant (counterpart of
`dmcnet_tpu/train/engine_gan.py`).

Reference code/dmcnet_GAN/train.py:219-380, selected by batch parity:

  * even batches, `d_step`: the forward with the real flow, so that the
    discriminator scores fake‖real in one batch; loss = CE(consensus, y) *
    lr_cls_w + CE(validity, [0]*n ‖ [1]*n) * lr_adv_d, n = B*S (fakes
    first); the classifier's and the discriminator's optimizers step, the
    generator's does not, though gradient reaches it;
  * odd batches, `g_step`: the forward without flow; loss = CE * lr_cls_w +
    CE(validity, 1) * lr_adv_g + rec(gen_flow, flow) * lr_mse_w; only the
    generator's optimizer steps.

Every step zeroes all three optimizers' gradients first: the dmcnet and GAN
loops carry no gradient from one step to the next.  The model needs a
discriminator (`DMCNet(arch_d=...)`), which also keeps the cue attached to
the classifier.

The freeze phase is the caller's: it sets the classifier optimizer's lr to
0 (reference adjust_learning_rate(freeze=True)), so that Adam still
updates its moments and step count while the parameters stay put.  The
dmcnet step (`train/engine.py`) skips the classifier's step instead.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from dmcnet_tpu_torch.models.tsn import segment_consensus
from dmcnet_tpu_torch.train.engine import (
    _autocast,
    _flow_target,
    reconstruction_loss,
    topk_correct,
)


def make_gan_train_steps(model, opt_cls, opt_gf, opt_d, *, num_segments,
                         lr_cls_w, lr_adv_g, lr_adv_d, lr_mse_w,
                         loss_mse="MSELoss", bf16=False):
    """-> (d_step, g_step), each step(batch) -> metrics: {loss, loss_cls,
    loss_adv, top1, top5, acc_D_adv} for D, {loss, loss_cls, loss_adv,
    loss_mse, top1, top5, acc_G_adv} for G (0-d tensors on the batch's
    device)."""
    if not model.arch_d:
        raise ValueError("the GAN steps need a model with a discriminator")
    if model.att:
        raise ValueError("the GAN steps take no attention output (the JAX "
                         "package's do not either)")
    rec_loss = reconstruction_loss(loss_mse)

    def forward(batch, with_flow):
        model.train()
        flow = _flow_target(batch)
        with _autocast(flow.device, bf16):
            logits, gen_flow, validity = model(
                batch["mv"], batch["residual"], flow if with_flow else None)
        # losses in the batch's precision (bf16 outputs back to float32)
        consensus = segment_consensus(logits.to(flow.dtype), num_segments)
        return consensus, gen_flow.to(flow.dtype), validity.to(flow.dtype), \
            flow

    def backward(loss):
        for opt in (opt_cls, opt_gf, opt_d):
            opt.zero_grad(set_to_none=True)
        loss.backward()

    def d_step(batch):
        labels = batch["label"]
        consensus, _, validity, _ = forward(batch, with_flow=True)
        n = batch["mv"].shape[0] * num_segments
        adv = torch.cat([torch.zeros(n, dtype=torch.long),
                         torch.ones(n, dtype=torch.long)]).to(labels.device)
        loss_cls = F.cross_entropy(consensus, labels)
        loss_adv = F.cross_entropy(validity, adv)
        loss = loss_cls * lr_cls_w + loss_adv * lr_adv_d
        backward(loss)
        opt_cls.step()
        opt_d.step()
        top1, top5 = topk_correct(consensus.detach(), labels)
        (acc,) = topk_correct(validity.detach(), adv, (1,))
        return {"loss": loss.detach(), "loss_cls": loss_cls.detach(),
                "loss_adv": loss_adv.detach(), "top1": top1, "top5": top5,
                "acc_D_adv": acc}

    def g_step(batch):
        labels = batch["label"]
        consensus, gen_flow, validity, flow = forward(batch, with_flow=False)
        valid = torch.ones(validity.shape[0], dtype=torch.long,
                           device=labels.device)
        loss_cls = F.cross_entropy(consensus, labels)
        loss_adv = F.cross_entropy(validity, valid)
        loss_rec = rec_loss(gen_flow, flow)
        loss = loss_cls * lr_cls_w + loss_adv * lr_adv_g + loss_rec * lr_mse_w
        backward(loss)
        opt_gf.step()
        top1, top5 = topk_correct(consensus.detach(), labels)
        (acc,) = topk_correct(validity.detach(), valid, (1,))
        return {"loss": loss.detach(), "loss_cls": loss_cls.detach(),
                "loss_adv": loss_adv.detach(), "loss_mse": loss_rec.detach(),
                "top1": top1, "top5": top5, "acc_G_adv": acc}

    return d_step, g_step
