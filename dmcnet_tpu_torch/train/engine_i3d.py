"""I3D steps (counterpart of `dmcnet_tpu/train/engine_i3d.py`): the eval
step of whole-video evaluation.  The training steps (iter-size
accumulation, the D/G alternation, chunked steps) and their optimizers
belong to the I3D training slice.
"""

from __future__ import annotations

import torch

from dmcnet_tpu_torch.train.engine import topk_correct


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
