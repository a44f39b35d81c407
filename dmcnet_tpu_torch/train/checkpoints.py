"""Checkpoint save/load (counterpart of `dmcnet_tpu/train/checkpoints.py`
for the reference's torch format).

A checkpoint is a `torch.save` of the reference `.pth.tar` payload
(code/dmcnet/train.py:372-377) plus the optimizers:

    {epoch, arch, best_prec1, state_dict, optimizer_cls, optimizer_gf
     [, optimizer_d]}

`optimizer_d` is the GAN variant's discriminator optimizer.
`state_dict` carries the reference key names, so the reference stack, the
JAX package's `--weights` importer and `DMCPredictor.from_checkpoint`
(`weights_only=True`) all load it; the optimizer states make a resume
exact.  Every tensor is stored on the CPU.  Files are named
`<prefix>_<representation>_checkpoint.pth.tar`, the best copied to
`..._model_best.pth.tar`.  Reading the JAX package's msgpack and orbax
checkpoints is not ported yet.
"""

from __future__ import annotations

import os
import shutil

import torch

from dmcnet_tpu_torch.models.weights import state_dict_from_checkpoint


def checkpoint_name(model_prefix, representation):
    return f"{model_prefix}_{representation.lower()}_checkpoint.pth.tar"


def _cpu(obj):
    """Tensors of a nested dict/list payload moved to the CPU."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_cpu(v) for v in obj)
    return obj


_OPTIMIZER_KEYS = ("optimizer_cls", "optimizer_gf", "optimizer_d")


def save_checkpoint(model, meta, filename, optimizers=None, is_best=False):
    """Write {**meta, state_dict[, optimizer_cls, optimizer_gf
    [, optimizer_d]]} through a temporary file and `os.replace`; copy to
    *_model_best.* when `is_best` (reference save_checkpoint,
    train.py:372-377).  `meta` holds epoch, arch and best_prec1;
    `optimizers` is (opt_cls, opt_gf[, opt_d]) or None (the reference
    layout alone)."""
    payload = dict(meta)
    payload["state_dict"] = _cpu(model.state_dict())
    for key, opt in zip(_OPTIMIZER_KEYS, optimizers or ()):
        payload[key] = _cpu(opt.state_dict())
    parent = os.path.dirname(filename)
    if parent:
        os.makedirs(parent, exist_ok=True)
    tmp = filename + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, filename)
    if is_best:
        shutil.copyfile(filename, best_name(filename))
    return filename


def best_name(filename):
    """`..._checkpoint.pth.tar` -> `..._model_best.pth.tar` (the file name
    only, not its directories)."""
    parent, base = os.path.split(filename)
    return os.path.join(parent, base.replace("checkpoint", "model_best"))


def load_checkpoint(filename, model, optimizers=None):
    """Restore the model (strict) and, when given, (opt_cls, opt_gf
    [, opt_d]) from a checkpoint of `save_checkpoint`; returns its meta
    {epoch, arch, best_prec1}."""
    payload = torch.load(filename, map_location="cpu", weights_only=True)
    model.load_state_dict(payload["state_dict"])
    for key, opt in zip(_OPTIMIZER_KEYS, optimizers or ()):
        opt.load_state_dict(payload[key])
    return {k: payload.get(k) for k in ("epoch", "arch", "best_prec1")}


def load_reference_weights(model, path):
    """Partial init from a torch checkpoint, the `--weights` semantics of
    reference train.py:64-68: the DataParallel `module.` prefix stripped,
    loaded non-strict, keys whose shape differs from the model's skipped.
    Returns (skipped, missing): checkpoint keys not loaded (unknown or of
    another shape) and model keys the checkpoint lacks."""
    sd = state_dict_from_checkpoint(
        torch.load(path, map_location="cpu", weights_only=True))
    own = model.state_dict()
    keep = {k: v for k, v in sd.items()
            if k in own and tuple(own[k].shape) == tuple(v.shape)}
    skipped = sorted(set(sd) - set(keep))
    missing = sorted(set(own) - set(sd))
    model.load_state_dict(keep, strict=False)
    return skipped, missing
