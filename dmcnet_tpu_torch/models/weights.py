"""Weight bridge: JAX-package variables and reference checkpoints -> the
port's `state_dict`.

`state_dict_from_flax(params, batch_stats)` takes the JAX package's
variables as nested dicts of numpy arrays and returns the port's
`state_dict`, the counterpart of `dmcnet_tpu/models/export_torch.py:27-163`:
conv kernels (kh, kw, I, O) -> OIHW, dense kernels (I, O) -> (O, I), BN
scale/bias/mean/var -> weight/bias/running_mean/running_var.  The port's
module names are the reference torch keys, so the result, and a reference
`.pth.tar`, load with `load_state_dict` directly.  It covers DMCNet,
PlainTSN and I3D with its generator and discriminator: conv3d kernels (kt,
kh, kw, I, O) -> (O, I, kt, kh, kw), and the discriminator's `adv_layer`, a
Dense over the NHWC-flattened map in flax, reordered to torch's NCHW
flattening.

`load_reference_i3d` partially loads a reference I3D `.pth` into an `I3D`,
the counterpart of `dmcnet_tpu/models/import_torch_i3d.py:135-150`, and
`load_reference_i3d_2d` a 2D one through temporal inflation (`--pretrained_2d`,
`load_i3d_pth_2d`, :153-177).
"""

from __future__ import annotations

import re

import numpy as np
import torch

from dmcnet_tpu_torch.models.initializer import inflate_state_2d_to_3d


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def _t_same(a):
    """A leaf at its own precision: float64 stays float64."""
    a = np.asarray(a)
    return torch.from_numpy(np.array(
        a, dtype=np.float64 if a.dtype == np.float64 else np.float32,
        copy=True))


def _conv(out, key, node, t):
    out[key + ".weight"] = t(np.transpose(np.asarray(node["kernel"]),
                                          (3, 2, 0, 1)))
    if "bias" in node:
        out[key + ".bias"] = t(node["bias"])


def _bn(out, key, pnode, bnode, t):
    """BN scale/bias -> weight/bias; the running statistics when `bnode`
    has them (a tree of parameters alone has none)."""
    out[key + ".weight"] = t(pnode["scale"])
    out[key + ".bias"] = t(pnode["bias"])
    if bnode:
        out[key + ".running_mean"] = t(bnode["mean"])
        out[key + ".running_var"] = t(bnode["var"])
        out[key + ".num_batches_tracked"] = torch.tensor(0,
                                                         dtype=torch.long)


def _resnet(out, params, bstats, prefix, t):
    for name, node in params.items():
        bnode = bstats.get(name, {})
        if name == "conv1":
            _conv(out, f"{prefix}.conv1", node, t)
        elif name == "bn1":
            _bn(out, f"{prefix}.bn1", node, bnode, t)
        elif name == "fc":
            out[f"{prefix}.fc.weight"] = t(np.asarray(node["kernel"]).T)
            out[f"{prefix}.fc.bias"] = t(node["bias"])
        else:
            m = re.fullmatch(r"layer(\d)_(\d+)", name)
            if not m:
                raise KeyError(f"unknown base_model module {name!r}")
            block = f"{prefix}.layer{m.group(1)}.{m.group(2)}"
            for sub, snode in node.items():
                sb = bnode.get(sub, {})
                if sub in ("conv1", "conv2"):
                    _conv(out, f"{block}.{sub}", snode, t)
                elif sub in ("bn1", "bn2"):
                    _bn(out, f"{block}.{sub}", snode, sb, t)
                elif sub == "downsample_conv":
                    _conv(out, f"{block}.downsample.0", snode, t)
                elif sub == "downsample_bn":
                    _bn(out, f"{block}.downsample.1", snode, sb, t)
                else:
                    raise KeyError(f"unknown resnet leaf {name}.{sub}")


def _estimator(out, params, bstats, prefix, t):
    """Every estimator family, with the keys of
    `dmcnet_tpu/models/export_torch.py:91-112`."""
    for name, node in params.items():
        bnode = bstats.get(name, {})
        if re.fullmatch(r"conv_\d+(_mv|_r)?", name):
            # dense-family stage: Sequential(conv, LeakyReLU) -> .0
            _conv(out, f"{prefix}.{name}.0", node, t)
        elif name == "predict_flow" and "kernel" in node:
            _conv(out, f"{prefix}.predict_flow", node, t)
        elif name in ("predict_flow", "predict_att"):
            # ContextNetworkAtt heads: (conv, bn, LeakyReLU), the attention
            # one wrapped once more with its ReLU
            base = (f"{prefix}.{name}" if name == "predict_flow"
                    else f"{prefix}.{name}.0")
            _conv(out, f"{base}.0", node["conv"], t)
            _bn(out, f"{base}.1", node["bn"], bnode.get("bn", {}), t)
        elif re.fullmatch(r"stage_\d+", name):
            base = f"{prefix}.conv_context.{name.split('_')[1]}"
            _conv(out, f"{base}.0", node["conv"], t)
            _bn(out, f"{base}.1", node["bn"], bnode.get("bn", {}), t)
        else:
            raise KeyError(f"unknown gen_flow_model module {name!r}")


def _flattened_linear_w(kernel, c_last):
    """flax Dense over an NHWC-flattened (h, w, c) map -> torch Linear
    weight over the NCHW-flattened one (inverse of
    `dmcnet_tpu/models/import_torch.py:38-48`)."""
    kernel = np.asarray(kernel)
    flat, o = kernel.shape
    hw = int(round((flat // c_last) ** 0.5))
    if c_last * hw * hw != flat:
        raise ValueError(f"adv_layer kernel {kernel.shape} is not a square "
                         f"map of {c_last} channels")
    w = kernel.reshape(hw, hw, c_last, o).transpose(3, 2, 0, 1)
    return w.reshape(o, c_last * hw * hw)


def _discriminator(out, params, bstats, prefix, t):
    """`stage{s}_down` / `stage{s}_deep{i}` -> `discriminator_block_{s+1}`
    / `discriminator_block_{s+1}_{i+1}` (conv `.0`, BN `.3`), `adv_layer`."""
    blocks = {}
    for name in params:
        m = re.fullmatch(r"stage(\d+)_(?:down|deep(\d+))", name)
        if m:
            blocks[name] = (int(m.group(1)), int(m.group(2) or 0))
        elif name != "adv_layer":
            raise KeyError(f"unknown discriminator module {name!r}")
    last = max(blocks, key=blocks.get)
    c_last = np.asarray(params[last]["conv"]["kernel"]).shape[-1]
    for name, (stage, deep) in blocks.items():
        key = f"{prefix}.discriminator_block_{stage + 1}" + (
            f"_{deep + 1}" if deep else "")
        node = params[name]
        _conv(out, f"{key}.0", node["conv"], t)
        if "bn" in node:
            _bn(out, f"{key}.3", node["bn"],
                bstats.get(name, {}).get("bn", {}), t)
    adv = params["adv_layer"]
    out[f"{prefix}.adv_layer.weight"] = t(_flattened_linear_w(adv["kernel"],
                                                               c_last))
    out[f"{prefix}.adv_layer.bias"] = t(adv["bias"])


def _unit3d(out, key, pnode, bnode, t):
    conv = pnode["conv3d"]
    out[key + ".conv3d.weight"] = t(np.transpose(np.asarray(conv["kernel"]),
                                                  (4, 3, 0, 1, 2)))
    if "bias" in conv:
        out[key + ".conv3d.bias"] = t(conv["bias"])
    if "batch3d" in pnode:
        _bn(out, key + ".batch3d", pnode["batch3d"],
            bnode.get("batch3d", {}), t)


# flax Mixed branch names -> the reference's Sequential positions
_I3D_BRANCHES = {"branch_0": "branch_0", "branch_1a": "branch_1.0",
                 "branch_1b": "branch_1.1", "branch_2a": "branch_2.0",
                 "branch_2b": "branch_2.1", "branch_3b": "branch_3.1"}


def _i3d_module(out, top, node, bnode, t):
    if top.startswith("conv3d_"):
        _unit3d(out, top, node, bnode, t)
    elif top.startswith("mixed_"):
        for branch, sub in node.items():
            if branch not in _I3D_BRANCHES:
                raise KeyError(f"unknown I3D branch {top}.{branch}")
            _unit3d(out, f"{top}.{_I3D_BRANCHES[branch]}", sub,
                    bnode.get(branch, {}), t)
    elif top == "classifier":
        out["classifier.weight"] = t(np.asarray(node["kernel"]).T)
        out["classifier.bias"] = t(node["bias"])
    else:
        raise KeyError(f"module {top!r} is not ported")


def state_dict_from_flax(params, batch_stats, keep_dtype=False):
    """JAX-package {params, batch_stats} (nested dicts of arrays) of a
    DMCNet, PlainTSN or I3D -> the port's `state_dict` (float32 CPU
    tensors; float64 leaves stay float64 under `keep_dtype`)."""
    t = _t_same if keep_dtype else _t
    out = {}
    for top, node in params.items():
        bnode = batch_stats.get(top, {})
        if top == "base_model":
            _resnet(out, node, bnode, top, t)
        elif top == "gen_flow_model":
            _estimator(out, node, bnode, top, t)
        elif top == "discriminator":
            _discriminator(out, node, bnode, top, t)
        else:
            _i3d_module(out, top, node, bnode, t)
    return out


def _placeholder(leaf, param):
    """An optimizer's shape-() slot for a parameter it does not own
    (`dmcnet_tpu/train/optimizers.py:76-86,124-128`)."""
    return np.ndim(leaf) == 0 and np.ndim(param) > 0


def _zip_trees(tree, params, fn, path=""):
    """fn(leaf, param) over two nested dicts of one structure."""
    if isinstance(params, dict):
        if not isinstance(tree, dict) or set(tree) != set(params):
            raise ValueError(f"tree at {path or '/'} does not match the "
                             "parameters' structure")
        return {k: _zip_trees(tree[k], params[k], fn, f"{path}/{k}")
                for k in params}
    return fn(np.asarray(tree), np.asarray(params))


def param_tree_from_flax(tree, params):
    """A tree shaped like flax `params` (Adam `mu` / `nu`, SGD momentum
    buffers, `grad_acc`) -> {port parameter name: tensor, or None where the
    tree holds a shape-() placeholder}, through the transposes of
    `state_dict_from_flax` (HWIO -> OIHW, DHWIO -> OIDHW, the
    discriminator's flattened linear).  `params` gives the shapes: a
    placeholder means the optimizer keeps no state for that parameter,
    never a value to broadcast.  Each leaf keeps its precision."""
    full = _zip_trees(tree, params, lambda leaf, p: (
        np.zeros(p.shape, leaf.dtype) if _placeholder(leaf, p) else leaf))
    owned = _zip_trees(tree, params, lambda leaf, p: np.full(
        p.shape, 0.0 if _placeholder(leaf, p) else 1.0, np.float32))
    values = state_dict_from_flax(full, {}, keep_dtype=True)
    mask = state_dict_from_flax(owned, {})
    return {k: (v if bool(mask[k].all()) else None)
            for k, v in values.items()}


def state_dict_from_checkpoint(obj):
    """A loaded torch checkpoint (a bare state_dict, or the reference
    `.pth.tar` payload {epoch, arch, state_dict, best_prec1}) -> a
    state_dict with the DataParallel `module.` prefix stripped."""
    sd = obj.get("state_dict", obj) if isinstance(obj, dict) else obj
    return {(k[len("module."):] if k.startswith("module.") else k): v
            for k, v in sd.items()}


# Top-level modules of the reference I3D: a checkpoint key under one of them
# that the model lacks, or holds at another shape, is "shape-missed"; any
# other key is "skipped" (the counts of `load_i3d_pth`).
_I3D_TOPS = re.compile(r"(conv3d_\w+|mixed_\w+|classifier|gen_flow_model|"
                       r"discriminator)\.")


_STEM = "conv3d_1a_7x7.conv3d.weight"
_RUNNING = ("running_mean", "running_var")


def _reference_state(path_or_state_dict):
    """A reference checkpoint (a path or a loaded object) -> its state dict,
    `module.` prefixes and BN batch counters dropped."""
    obj = path_or_state_dict
    if not isinstance(obj, dict):
        obj = torch.load(obj, map_location="cpu", weights_only=True)
    return {k: v for k, v in state_dict_from_checkpoint(obj).items()
            if not k.endswith("num_batches_tracked")}


def _adapt_stem(sd, modality):
    """A stem of another input-channel count (3-channel RGB on a 2-channel
    flow model), 2D or 3D, channel-meaned and broadcast (reference
    train/model.py:55-58)."""
    in_ch = 2 if modality in ("flow", "mv", "flow+mp4") else 3
    w = sd.get(_STEM)
    if w is not None and w.ndim in (4, 5) and w.shape[1] != in_ch:
        shape = (-1, in_ch) + (-1,) * (w.ndim - 2)
        sd = dict(sd)
        sd[_STEM] = w.float().mean(dim=1, keepdim=True).expand(shape) \
            .contiguous()
    return sd


def load_matching(model, tensors):
    """Load the tensors of `tensors` whose key `model` has at the same
    shape, non-strictly.  Returns (loaded keys, unfilled): `unfilled` lists,
    sorted, the model's keys (BN batch counters aside) left at their
    initialisation."""
    own = model.state_dict()
    keep = {k: v for k, v in tensors.items()
            if k in own and tuple(own[k].shape) == tuple(v.shape)}
    model.load_state_dict(keep, strict=False)
    return set(keep), sorted(k for k in own if k not in keep
                             and not k.endswith("num_batches_tracked"))


def load_reference_i3d(path_or_state_dict, model, modality):
    """Partial load of a reference I3D checkpoint (a path to a torch file,
    or a state dict) into `model`, as `load_i3d_pth` does (reference
    train/model.py:41-65): the `module.` prefix stripped, a stem of another
    input-channel count (3-channel RGB on a 2-channel flow model)
    channel-meaned and broadcast, keys of another shape left out, loaded
    non-strictly.  Returns (report, unfilled).  The report is "imported=N
    skipped=N shape-missed=N": parameters (not BN statistics) the
    checkpoint names, keys of no reference module, keys the model lacks or
    holds at another shape.  `unfilled` lists, sorted, the model's keys
    (BN batch counters aside) that the checkpoint did not fill, so that
    they keep their initialisation."""
    sd = _adapt_stem(_reference_state(path_or_state_dict), modality)
    known = {k for k in sd if _I3D_TOPS.match(k)}
    loaded, unfilled = load_matching(model, sd)
    imported = sum(1 for k in known if not k.endswith(_RUNNING))
    return (f"imported={imported} skipped={len(sd) - len(known)} "
            f"shape-missed={len(known - loaded)}"), unfilled


def load_reference_i3d_2d(path_or_state_dict, model, modality,
                          mode="inflation", seed=None):
    """Partial load of a 2D reference checkpoint (the I3D module names with
    4D kernels) into `model` through temporal inflation, as
    `load_i3d_pth_2d` does (reference network/initializer.py:62-143): the
    stem channel-adapted, each 4D kernel inflated to its 3D target
    (`models.initializer.inflate_state_2d_to_3d`, `mode` "inflation" or
    "random" with numpy seed `seed`), other parameters of the model's shape
    copied and of another shape left out, BN statistics of the model's
    shape loaded.  Returns (report, unfilled) as `load_reference_i3d`; the
    report is "2d-inflated=N skipped=N shape-missed=N": parameters
    inflated or copied, keys of no reference module, inflated kernels and
    BN statistics the model lacks or holds at another shape."""
    sd = _adapt_stem(_reference_state(path_or_state_dict), modality)
    known = [k for k in sd if _I3D_TOPS.match(k)]
    inflated = inflate_state_2d_to_3d(
        {k: sd[k] for k in known if not k.endswith(_RUNNING)},
        model.state_dict(), mode, seed)
    candidates = dict(inflated)
    candidates.update((k, sd[k]) for k in known if k.endswith(_RUNNING))
    loaded, unfilled = load_matching(model, candidates)
    return (f"2d-inflated={len(inflated)} skipped={len(sd) - len(known)} "
            f"shape-missed={len(candidates) - len(loaded)}"), unfilled
