"""Train and eval steps of the dmcnet (no-GAN) variant (counterpart of
`dmcnet_tpu/train/engine.py:57-226`).

Reference loop semantics (code/dmcnet/train.py:205-369):

  * TSN consensus: per-segment logits averaged before cross-entropy;
  * total loss = loss_cls * lr_cls_w + loss_rec * lr_mse_w, one backward;
    the generator sees only the reconstruction gradient because the model
    detaches the cue before the classifier;
  * two Adam optimizers (`train/optimizers.py`), both zeroed every step;
    the generator's steps always, the classifier's only when `train_cls`:
    in the freeze phase (`epoch < epoch_thre`) its parameters and moments
    stay untouched, while BN running statistics update in both phases;
  * reconstruction loss MSELoss | SmoothL1Loss (beta 1) | L1, mean
    reduction.

Batches are dicts of (B, S, C, H, W) tensors `mv`, `residual`, `flow` and
(B,) `label`, as `data.dmc_dataset.augment_*_batch` returns them.  Metrics
are 0-d tensors left on the batch's device; the caller reads them when it
prints.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from dmcnet_tpu_torch.models.tsn import segment_consensus

_REC_LOSSES = {
    "MSELoss": F.mse_loss,
    "SmoothL1Loss": lambda p, t, reduction: F.smooth_l1_loss(
        p, t, reduction=reduction, beta=1.0),
    "L1": F.l1_loss,
}


def reconstruction_loss(kind, reduction="mean"):
    """fn(pred, target) for 'MSELoss' | 'SmoothL1Loss' | 'L1'."""
    try:
        fn = _REC_LOSSES[kind]
    except KeyError:
        raise ValueError(f"unknown reconstruction loss {kind!r}") from None
    return lambda pred, tgt: fn(pred, tgt, reduction=reduction)


def topk_correct(logits, labels, ks=(1, 5), weights=None):
    """Percent of rows whose label is in the top k, like reference
    accuracy() (train.py:411-424); ties rank by class index (a stable sort
    of -logits, as `jnp.argsort`).  Optional per-sample 0/1 `weights` mask
    rows out of the mean."""
    ranks = torch.argsort(-logits, dim=-1, stable=True)
    out = []
    for k in ks:
        hit = (ranks[:, :min(k, logits.shape[-1])] == labels[:, None]) \
            .any(dim=-1).float()
        if weights is None:
            out.append(100.0 * hit.mean())
        else:
            out.append(100.0 * (hit * weights).sum()
                       / weights.sum().clamp(min=1.0))
    return out


def _autocast(device, bf16):
    """Convolutions and matmuls in bfloat16 under `bf16`; parameters, BN
    statistics and losses stay float32."""
    if not bf16:
        return contextlib.nullcontext()
    return torch.autocast(device.type, dtype=torch.bfloat16)


def _flow_target(batch):
    flow = batch["flow"]
    return flow.reshape((-1,) + tuple(flow.shape[-3:]))


def make_train_step(model, opt_cls, opt_gf, *, num_segments, lr_cls_w,
                    lr_mse_w, loss_mse="MSELoss", bf16=False):
    """-> step(batch, train_cls) -> metrics {loss, loss_cls, loss_mse,
    top1, top5}; `train_cls` is False in the freeze phase."""
    rec_loss = reconstruction_loss(loss_mse)

    def step(batch, train_cls):
        model.train()
        flow = _flow_target(batch)
        labels = batch["label"]
        with _autocast(flow.device, bf16):
            outs = model(batch["mv"], batch["residual"])
        # losses in the batch's precision (bf16 outputs back to float32)
        logits, gen_flow = outs[0].to(flow.dtype), outs[1].to(flow.dtype)
        consensus = segment_consensus(logits, num_segments)
        loss_cls = F.cross_entropy(consensus, labels)
        loss_rec = rec_loss(gen_flow, flow)
        total = loss_cls * lr_cls_w + loss_rec * lr_mse_w
        opt_cls.zero_grad(set_to_none=True)
        opt_gf.zero_grad(set_to_none=True)
        total.backward()
        opt_gf.step()
        if train_cls:
            opt_cls.step()
        consensus = consensus.detach()
        top1, top5 = topk_correct(consensus, labels)
        return {"loss": total.detach(), "loss_cls": loss_cls.detach(),
                "loss_mse": loss_rec.detach(), "top1": top1, "top5": top5}

    return step


def make_eval_step(model, *, num_segments, lr_cls_w, lr_mse_w,
                   loss_mse="MSELoss", bf16=False):
    """Validation step (reference validate(), train.py:292-369) ->
    step(batch) -> metrics {loss, loss_cls, loss_mse, top1, top5, logits}.

    An optional per-sample 0/1 `batch['weight']` masks rows: the means are
    then exact over the rows of weight 1.  With attention the reconstruction
    compares att * gen_flow with att * flow (train.py:332-335)."""
    rec_mean = reconstruction_loss(loss_mse)
    rec_each = reconstruction_loss(loss_mse, reduction="none")

    @torch.no_grad()
    def step(batch):
        model.eval()
        flow = _flow_target(batch)
        labels = batch["label"]
        with _autocast(flow.device, bf16):
            outs = model(batch["mv"], batch["residual"])
        logits, gen_flow = outs[0].to(flow.dtype), outs[1].to(flow.dtype)
        consensus = segment_consensus(logits, num_segments)
        if model.att:
            att = outs[-1].to(flow.dtype)
            rec = (att * gen_flow, att * flow)
        else:
            rec = (gen_flow, flow)
        w = batch.get("weight")
        if w is None:
            loss_cls = F.cross_entropy(consensus, labels)
            loss_rec = rec_mean(*rec)
            top1, top5 = topk_correct(consensus, labels)
        else:
            w = w.to(flow.dtype)
            denom = w.sum().clamp(min=1.0)
            ce = F.cross_entropy(consensus, labels, reduction="none")
            loss_cls = (ce * w).sum() / denom
            # per-clip means, then per sample over its B*S / B clips
            per_clip = rec_each(*rec).flatten(1).mean(dim=1)
            per_sample = per_clip.reshape(w.shape[0], -1).mean(dim=1)
            loss_rec = (per_sample * w).sum() / denom
            top1, top5 = topk_correct(consensus, labels, weights=w)
        return {"loss": loss_cls * lr_cls_w + loss_rec * lr_mse_w,
                "loss_cls": loss_cls, "loss_mse": loss_rec,
                "top1": top1, "top5": top5, "logits": consensus}

    return step
