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
`..._model_best.pth.tar`.

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

Three formats load (`checkpoint_format`):

  * "torch": the files above, and reference `.pth.tar` files;
  * "jax": the JAX package's files (`dmcnet_tpu/train/checkpoints.py:23-63`,
    read by `train.jax_checkpoint` without jax, flax or msgpack).  Their
    GroupAdam states {count, mu, nu} become torch Adam's {step, exp_avg,
    exp_avg_sq} for each parameter the optimizer owns, GroupSGD buffers
    `momentum_buffer`, `opt_d` the third Adam and `grad_acc` the `.grad`;
    a shape-() placeholder (a parameter the optimizer does not own) gives
    no state, and a count of 0 (the dmcnet classifier's `masked_update`
    in the freeze phase, `dmcnet_tpu/train/optimizers.py:166-173`) none
    either, as torch has none before its first step;
  * "dcp": the directory backend below, the port's `--ckpt-backend orbax |
    orbax-async`.  A JAX orbax directory (tensorstore OCDBT) is not read:
    it raises `SystemExit` naming the format.

The directory backend (`save_checkpoint_dcp`) is the counterpart of the
JAX package's orbax backend (`dmcnet_tpu/train/checkpoints.py:83-223`) on
`torch.distributed.checkpoint` (DCP), with its layout and guarantees:
`<directory>/<meta['epoch']>/meta.pkl`, written first and atomically by
rank 0, then `state/`, which every rank writes its shards of.  A step is
committed once DCP has written `state/.metadata`: DCP's coordinator writes
it last, after every rank's shards are written, through a temporary file
and a rename, so a step with `meta.pkl` and no `.metadata` is torn and
never read.  The newest `KEEP` committed steps are kept, pruned before a
new write starts, never the newest before the new one commits.  `wait=
False` saves in the background (`dcp.async_save`; the state is copied to
the host before the call returns): `wait_for_checkpoints()` drains every
save in flight, and each new save drains the one before.  The directory
holds flat keys: `state_dict/<name>`, `<optimizer_key>/<parameter
name>/<state key>` and, for I3D, `grad/<parameter name>`; sharded
(FSDP2) tensors are written shard by shard.
"""

from __future__ import annotations

import contextlib
import os
import pickle
import shutil
import warnings

import numpy as np
import torch

from dmcnet_tpu_torch.models.weights import (
    param_tree_from_flax,
    state_dict_from_checkpoint,
    state_dict_from_flax,
)
from dmcnet_tpu_torch.train.optimizers import (
    _I3D_NEW_LAYERS,
    _I3D_OWN_OPTIMIZER,
)
from dmcnet_tpu_torch.train.jax_checkpoint import (
    _RestrictedUnpickler,
    is_jax_checkpoint,
    read_jax_checkpoint,
)


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


def save_checkpoint(model, meta, filename, optimizers=None, is_best=False,
                    state_dict=None):
    """Write {**meta, state_dict[, optimizer_cls, optimizer_gf
    [, optimizer_d]]} through a temporary file and `os.replace`; copy to
    *_model_best.* when `is_best` (reference save_checkpoint,
    train.py:372-377).  `meta` holds epoch, arch and best_prec1;
    `optimizers` is (opt_cls, opt_gf[, opt_d]) or None (the reference
    layout alone); `state_dict`, when given, is written in place of the
    model's (a sharded model's, gathered)."""
    payload = dict(meta)
    payload["state_dict"] = _cpu(model.state_dict() if state_dict is None
                                 else state_dict)
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
    [, opt_d]) from a checkpoint of `save_checkpoint`, a JAX file or a
    directory of `save_checkpoint_dcp`; returns its meta {epoch, arch,
    best_prec1}."""
    fmt = checkpoint_format(filename)
    names = dict(zip(_OPTIMIZER_KEYS, optimizers or ()))
    if fmt == "dcp":
        meta = load_checkpoint_dcp(filename, model, names)
    elif fmt == "jax":
        meta = load_jax_checkpoint(filename, model, names)
    else:
        payload = torch.load(filename, map_location="cpu",
                             weights_only=True)
        model.load_state_dict(payload["state_dict"])
        for key, opt in names.items():
            opt.load_state_dict(payload[key])
        meta = payload
    return {k: meta.get(k) for k in ("epoch", "arch", "best_prec1")}


def read_model_state(path):
    """The model's state dict in any format: a torch file (`module.`
    prefix stripped), a JAX file (float32) or a DCP directory (its
    `state_dict/` entries, read whole)."""
    fmt = checkpoint_format(path)
    if fmt == "dcp":
        return read_dcp_model_state(path)
    if fmt == "jax":
        _, state = read_jax_checkpoint(path)
        return state_dict_from_flax(state["params"],
                                    state.get("batch_stats") or {})
    return state_dict_from_checkpoint(
        torch.load(path, map_location="cpu", weights_only=True))


def load_reference_weights(model, path):
    """Partial init from a checkpoint in any format (`read_model_state`),
    the `--weights` semantics of reference train.py:64-68: the
    DataParallel `module.` prefix stripped, loaded non-strict, keys whose
    shape differs from the model's skipped.  Returns (skipped, missing):
    checkpoint keys not loaded (unknown or of another shape) and model
    keys the checkpoint lacks."""
    sd = read_model_state(path)
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


def save_i3d_checkpoint_dcp(model, optimizers, meta, directory, wait=True):
    """`save_i3d_checkpoint` as a step directory of `save_checkpoint_dcp`,
    the carried gradients included."""
    return save_checkpoint_dcp(
        model, meta, directory, {name: optimizers[key] for key, name in
                                 _I3D_OPTIMIZERS if key in optimizers},
        grads=True, wait=wait)


def load_i3d_checkpoint(filename, model, optimizers, stage2):
    """Restore a checkpoint of `save_i3d_checkpoint`, a JAX file or a
    directory of `save_i3d_checkpoint_dcp` into `model` (strict), its
    carried gradients and `optimizers` ({"cls", "gf"[, "d"]}, built for
    `stage2`); returns its meta {epoch, top1, stage2}.  A JAX file's stage
    is read from its optimizers (`_jax_i3d_stage2`).

    A stage-1 file read into stage-2 optimizers is the stage-2 swap itself
    (the file of the epoch at `--epoch-thre`): "cls" and "gf" stay fresh
    and only "d" is restored, as an uninterrupted run swaps them."""
    fmt = checkpoint_format(filename)
    if fmt == "torch":
        payload = torch.load(filename, map_location="cpu",
                             weights_only=True)
        saved_stage2 = payload["stage2"]
    elif fmt == "jax":
        payload, state = read_jax_checkpoint(filename)
        saved_stage2 = _jax_i3d_stage2(state)
    else:
        payload = _read_meta(_newest_step(filename))
        saved_stage2 = payload["stage2"]
    swap = stage2 and not saved_stage2
    names = {name: optimizers[key] for key, name in _I3D_OPTIMIZERS
             if key in optimizers and not (swap and key != "d")}
    if fmt == "torch":
        model.load_state_dict(payload["state_dict"])
        device = next(model.parameters()).device
        for k, p in model.named_parameters():
            g = payload["grad"].get(k)
            p.grad = None if g is None else g.to(device, p.dtype)
        for name, opt in names.items():
            opt.load_state_dict(payload[name])
    elif fmt == "jax":
        load_jax_checkpoint(filename, model, names, grads=True)
    else:
        load_checkpoint_dcp(filename, model, names, grads=True)
    return {"epoch": payload.get("epoch"), "top1": payload.get("top1"),
            "stage2": saved_stage2}


# --- formats -----------------------------------------------------------------

# files of a JAX orbax step (tensorstore OCDBT), which the port does not read
_ORBAX_FILES = ("_CHECKPOINT_METADATA", "manifest.ocdbt", "_METADATA")


def _is_jax_orbax(directory):
    """Whether `directory` is the JAX package's orbax checkpoint: its
    `state/` (flat layout) or a step's `state/` holds orbax's files."""
    candidates = [directory, os.path.join(directory, "state")]
    if os.path.isdir(directory):
        candidates += [os.path.join(directory, n, "state")
                       for n in os.listdir(directory) if n.isdigit()]
    return any(os.path.exists(os.path.join(c, f)) and
               not os.path.exists(os.path.join(c, ".metadata"))
               for c in candidates for f in _ORBAX_FILES)


def checkpoint_format(path):
    """"dcp" for a directory of `save_checkpoint_dcp`, "jax" for a JAX
    package file, "torch" for any other file.  A JAX orbax directory
    raises `SystemExit`: it is tensorstore's OCDBT format, which needs
    tensorstore (absent on the card's machine), so the port does not read
    it."""
    if os.path.isdir(path):
        if _is_jax_orbax(path):
            raise SystemExit(
                f"{path} is a JAX orbax checkpoint directory (tensorstore "
                "OCDBT), which the port does not read; convert it with the "
                "JAX package (its msgpack --ckpt-backend) and pass the file")
        return "dcp"
    if not os.path.isfile(path):
        raise FileNotFoundError(path)
    return "jax" if is_jax_checkpoint(path) else "torch"


# --- JAX files ---------------------------------------------------------------


def _jax_optimizer_state(opt_state, params):
    """{parameter name: torch optimizer state} of one GroupAdam ({count,
    mu, nu}) or GroupSGD (a tree of buffers) state; parameters with a
    placeholder get none, and so does every parameter at count 0."""
    if isinstance(opt_state, dict) and set(opt_state) == {"count", "mu",
                                                          "nu"}:
        count = int(np.asarray(opt_state["count"]))
        if count == 0:
            return {}
        mu = param_tree_from_flax(opt_state["mu"], params)
        nu = param_tree_from_flax(opt_state["nu"], params)
        return {k: {"step": torch.tensor(float(count)), "exp_avg": m,
                    "exp_avg_sq": nu[k]}
                for k, m in mu.items() if m is not None}
    bufs = param_tree_from_flax(opt_state, params)
    return {k: {"momentum_buffer": b} for k, b in bufs.items()
            if b is not None}


def _jax_i3d_stage2(state):
    """Whether a JAX I3D state holds stage-2 optimizers: stage 1 freezes
    the base layers, whose slots in opt_cls are then placeholders (the
    JAX meta holds only {epoch, top1}, `dmcnet_tpu/cli/train_i3d.py:667`)."""
    opt = state["opt_cls"]
    tree = opt["mu"] if isinstance(opt, dict) and "mu" in opt else opt
    params = state["params"]
    base = [k for k in params
            if k not in _I3D_OWN_OPTIMIZER + _I3D_NEW_LAYERS]
    owned = param_tree_from_flax({k: tree[k] for k in base},
                                 {k: params[k] for k in base})
    return any(v is not None for v in owned.values())


def load_jax_checkpoint(filename, model, optimizers, grads=False):
    """Restore a JAX file into `model` (strict, at the file's precision)
    and the optimizers of `optimizers` ({"optimizer_cls" | "optimizer_gf"
    | "optimizer_d": optimizer}); with `grads`, `grad_acc` into `.grad`
    (None without one).  Returns the file's meta."""
    meta, state = read_jax_checkpoint(filename)
    params = state["params"]
    model.load_state_dict(state_dict_from_flax(
        params, state.get("batch_stats") or {}, keep_dtype=True))
    for name, opt in optimizers.items():
        jax_key = "opt_" + name.split("_", 1)[1]
        if state.get(jax_key) is None:
            raise ValueError(f"{filename} has no {jax_key} for {name}")
        set_optimizer_state(model, opt,
                            _jax_optimizer_state(state[jax_key], params))
    if grads:
        acc = state.get("grad_acc")
        tree = param_tree_from_flax(acc, params) if acc is not None else {}
        for k, p in model.named_parameters():
            g = tree.get(k)
            p.grad = None if g is None else g.to(p.device, p.dtype)
    return meta


def set_optimizer_state(model, opt, states):
    """Replace `opt`'s state by `states` ({parameter name: {key: tensor}}),
    each tensor moved to its parameter's device and dtype (a step counter
    stays a host scalar, as torch keeps it).  A name outside `opt` raises.
    The model is unsharded: a sharded one resumes from a directory."""
    by_name = dict(model.named_parameters())
    own = {id(p) for g in opt.param_groups for p in g["params"]}
    opt.state.clear()
    for name, entry in states.items():
        p = by_name.get(name)
        if p is None or id(p) not in own:
            raise KeyError(f"optimizer state for {name}, which the "
                           "optimizer does not hold")
        opt.state[p] = {k: (v if k == "step" else v.to(p.device, p.dtype))
                        for k, v in entry.items()}


# --- the directory backend (DCP) ---------------------------------------------

_PENDING = []   # saves in flight: futures of dcp.async_save
KEEP = 2        # committed steps kept (dmcnet_tpu/train/checkpoints.py)


def _dist():
    """(rank, process group for checkpoint I/O) under torch.distributed,
    (0, None) in a single process.  The group is gloo: DCP gathers its
    plans and `dcp.async_save` writes from a thread, off the training
    collectives' group."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        return 0, None
    from dmcnet_tpu_torch.parallel.multihost import checkpoint_group

    return dist.get_rank(), checkpoint_group()


def _committed_steps(path):
    """Sorted committed step numbers under `path`: a step directory with
    meta.pkl and DCP's `state/.metadata`."""
    steps = []
    if os.path.isdir(path):
        for name in os.listdir(path):
            step = os.path.join(path, name)
            if name.isdigit() and os.path.exists(
                    os.path.join(step, "meta.pkl")) and os.path.exists(
                    os.path.join(step, "state", ".metadata")):
                steps.append(int(name))
    return sorted(steps)


def dcp_checkpoint_committed(directory):
    """True iff `directory` holds at least one committed step (the JAX
    package's `orbax_checkpoint_committed`): `--auto-resume` skips a torn
    write with it."""
    return bool(_committed_steps(os.path.abspath(directory)))


def _newest_step(directory):
    path = os.path.abspath(directory)
    checkpoint_format(path)     # a JAX orbax directory raises here
    steps = _committed_steps(path)
    if not steps:
        raise FileNotFoundError(f"{directory} holds no committed checkpoint "
                                "step")
    return os.path.join(path, str(steps[-1]))


def _read_meta(step_dir):
    with open(os.path.join(step_dir, "meta.pkl"), "rb") as f:
        return _RestrictedUnpickler(f).load()


def _write_meta(step_dir, meta):
    """Atomic meta.pkl (temporary file and rename)."""
    os.makedirs(step_dir, exist_ok=True)
    tmp = os.path.join(step_dir, "meta.pkl.tmp")
    with open(tmp, "wb") as f:
        pickle.dump(dict(meta), f)
    os.replace(tmp, os.path.join(step_dir, "meta.pkl"))


@contextlib.contextmanager
def _quiet():
    """DCP warns that it runs in one process when there is no process
    group, which is what it is asked to do."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore",
                                message=".*assuming the intent is to")
        yield


def _dcp_state(model, optimizers, grads):
    """The flat keys the directory holds (see the module docstring)."""
    names = {id(p): k for k, p in model.named_parameters()}
    out = {f"state_dict/{k}": v for k, v in model.state_dict().items()}
    for key, opt in optimizers.items():
        for p, entry in opt.state.items():
            for sk, v in entry.items():
                if isinstance(v, torch.Tensor):
                    out[f"{key}/{names[id(p)]}/{sk}"] = v
    if grads:
        for k, p in model.named_parameters():
            if p.grad is not None:
                out[f"grad/{k}"] = p.grad
    return out


def save_checkpoint_dcp(model, meta, directory, optimizers=None,
                        grads=False, wait=True):
    """Write step `meta['epoch']` of `directory` (the JAX package's
    `save_checkpoint_orbax`): the model's state dict, the states of
    `optimizers` ({"optimizer_cls" | ...: optimizer}) and, with `grads`,
    the parameters' `.grad`.  Every rank calls it and writes its shards;
    rank 0 prunes, writes meta.pkl and DCP's commit.  `wait=False` returns
    once the state is copied to the host (`dcp.async_save`)."""
    import torch.distributed.checkpoint as dcp

    wait_for_checkpoints()
    path = os.path.abspath(directory)
    step_dir = os.path.join(path, str(int(meta.get("epoch", 0))))
    rank, group = _dist()
    if rank == 0:
        for old in _committed_steps(path)[:-(KEEP - 1)]:
            if os.path.join(path, str(old)) != step_dir:
                shutil.rmtree(os.path.join(path, str(old)))
        if os.path.isdir(step_dir):     # a torn or earlier write of it
            shutil.rmtree(step_dir)
        _write_meta(step_dir, meta)
    if group is not None:
        import torch.distributed as dist

        dist.barrier(group=group)
    state = _dcp_state(model, optimizers or {}, grads)
    writer = dcp.FileSystemWriter(os.path.join(step_dir, "state"))
    with _quiet():
        if wait:
            dcp.save(state, storage_writer=writer, process_group=group)
        else:
            _PENDING.append(dcp.async_save(
                state, storage_writer=writer, process_group=group))
    return path


def wait_for_checkpoints():
    """Block until every background `save_checkpoint_dcp(wait=False)` has
    committed; a failed write raises here."""
    while _PENDING:
        fut = _PENDING.pop(0)
        fut = getattr(fut, "upload_completion", fut)
        fut.result()


def _dcp_load(state, step_dir):
    import torch.distributed.checkpoint as dcp

    _, group = _dist()
    with _quiet():
        dcp.load(state, storage_reader=dcp.FileSystemReader(
            os.path.join(step_dir, "state")), process_group=group)


def _dcp_keys(step_dir):
    """{key: storage metadata} of a step's `state/`."""
    import torch.distributed.checkpoint as dcp

    return dcp.FileSystemReader(os.path.join(step_dir, "state")) \
        .read_metadata().state_dict_metadata


def load_checkpoint_dcp(directory, model, optimizers=None, grads=False):
    """Restore the newest committed step of `directory` into `model`
    (strict), the optimizers of `optimizers` ({"optimizer_cls" | ...:
    optimizer}; their states replaced) and, with `grads`, `.grad` (None
    where the step has none).  Every rank calls it and reads its shards.
    Returns the step's meta (`load_checkpoint_orbax`)."""
    step_dir = _newest_step(directory)
    keys = _dcp_keys(step_dir)
    params = dict(model.named_parameters())
    state = {f"state_dict/{k}": v for k, v in model.state_dict().items()}
    missing = [k for k in state if k not in keys]
    if missing:
        raise KeyError(f"{step_dir} lacks {len(missing)} model keys: "
                       f"{missing[:4]}")
    wanted = tuple(f"{k}/" for k in (optimizers or {})) + (
        ("grad/",) if grads else ())
    for key, md in keys.items():
        if not key.startswith(wanted):
            continue
        name = key.split("/")[1]
        p = params[name]
        if tuple(md.size) == tuple(p.shape):
            state[key] = torch.zeros_like(p)
        else:                       # a step counter
            state[key] = torch.zeros(tuple(md.size),
                                     dtype=md.properties.dtype)
    _dcp_load(state, step_dir)
    model.load_state_dict({k[len("state_dict/"):]: v for k, v in
                           state.items() if k.startswith("state_dict/")})
    for key, opt in (optimizers or {}).items():
        entries = {}
        for k, v in state.items():
            if k.startswith(key + "/"):
                _, name, sk = k.split("/")
                entries.setdefault(name, {})[sk] = v
        opt.state.clear()
        for name, entry in entries.items():
            opt.state[params[name]] = entry
    if grads:
        for k, p in params.items():
            p.grad = state.get(f"grad/{k}")
    return _read_meta(step_dir)


def read_dcp_model_state(directory):
    """The model's state dict of the newest committed step of `directory`
    as plain tensors on the CPU, whatever the shards it was written in
    (the JAX package's `load_checkpoint_params_orbax`)."""
    step_dir = _newest_step(directory)
    state = {k: torch.zeros(tuple(md.size), dtype=md.properties.dtype)
             for k, md in _dcp_keys(step_dir).items()
             if k.startswith("state_dict/")}
    if not state:
        raise KeyError(f"{step_dir} holds no model state")
    import torch.distributed.checkpoint as dcp

    with _quiet():
        dcp.load(state, storage_reader=dcp.FileSystemReader(
            os.path.join(step_dir, "state")), no_dist=True)
    return {k[len("state_dict/"):]: v for k, v in state.items()}
