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

The I3D trainer's checkpoints (`save_i3d_checkpoint`) are named
`{model_prefix}_ep-{epoch:04d}.pth` (the JAX package's
`cli/train_i3d.py:435-446`) and hold

    {epoch, top1, stage2, state_dict, optimizer_cls, optimizer_gf
     [, optimizer_d], grad}

`grad` holds the carried gradients (the torch `.grad` of every parameter
that has one), which the JAX package's state keeps as `grad_acc`; `stage2`
says which optimizers `optimizer_cls` and `optimizer_gf` are.
`evaluate_video_i3d --load-weights` reads such a file through its
`state_dict`.
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


def i3d_checkpoint_name(model_prefix, epoch):
    return f"{model_prefix}_ep-{epoch:04d}.pth"


_I3D_OPTIMIZERS = tuple(zip(("cls", "gf", "d"), _OPTIMIZER_KEYS))


def save_i3d_checkpoint(model, optimizers, meta, filename):
    """`save_checkpoint` of {**meta, state_dict, optimizer_* of each of
    `optimizers` ({"cls", "gf"[, "d"]}), grad}.  `meta` holds epoch, top1
    and stage2."""
    grad = {k: _cpu(p.grad) for k, p in model.named_parameters()
            if p.grad is not None}
    return save_checkpoint(model, dict(meta, grad=grad), filename,
                           [optimizers[k] for k, _ in _I3D_OPTIMIZERS
                            if k in optimizers])


def load_i3d_checkpoint(filename, model, optimizers, stage2):
    """Restore a checkpoint of `save_i3d_checkpoint` into `model` (strict),
    its carried gradients and `optimizers` ({"cls", "gf"[, "d"]}, built for
    `stage2`); returns its meta {epoch, top1, stage2}.

    A stage-1 file read into stage-2 optimizers is the stage-2 swap itself
    (the file of the epoch at `--epoch-thre`): "cls" and "gf" stay fresh
    and only "d" is restored, as an uninterrupted run swaps them."""
    payload = torch.load(filename, map_location="cpu", weights_only=True)
    model.load_state_dict(payload["state_dict"])
    device = next(model.parameters()).device
    for k, p in model.named_parameters():
        g = payload["grad"].get(k)
        p.grad = None if g is None else g.to(device, p.dtype)
    swap = stage2 and not payload["stage2"]
    for key, name in _I3D_OPTIMIZERS:
        if key in optimizers and not (swap and key != "d"):
            optimizers[key].load_state_dict(payload[name])
    return {k: payload.get(k) for k in ("epoch", "top1", "stage2")}
