"""Weight bridge: JAX-package variables and reference checkpoints -> the
port's `state_dict`.

`state_dict_from_flax(params, batch_stats)` takes the JAX package's
variables as nested dicts of numpy arrays and returns the port's
`state_dict`, the counterpart of `dmcnet_tpu/models/export_torch.py:27-163`:
conv kernels (kh, kw, I, O) -> OIHW, dense kernels (I, O) -> (O, I), BN
scale/bias/mean/var -> weight/bias/running_mean/running_var.  The port's
module names are the reference torch keys, so the result, and a reference
`.pth.tar`, load with `load_state_dict` directly.  The GAN discriminator is
not ported yet.
"""

from __future__ import annotations

import re

import numpy as np
import torch


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def _conv(out, key, node):
    out[key + ".weight"] = _t(np.transpose(np.asarray(node["kernel"]),
                                           (3, 2, 0, 1)))
    if "bias" in node:
        out[key + ".bias"] = _t(node["bias"])


def _bn(out, key, pnode, bnode):
    out[key + ".weight"] = _t(pnode["scale"])
    out[key + ".bias"] = _t(pnode["bias"])
    out[key + ".running_mean"] = _t(bnode["mean"])
    out[key + ".running_var"] = _t(bnode["var"])
    out[key + ".num_batches_tracked"] = torch.tensor(0, dtype=torch.long)


def _resnet(out, params, bstats, prefix):
    for name, node in params.items():
        bnode = bstats.get(name, {})
        if name == "conv1":
            _conv(out, f"{prefix}.conv1", node)
        elif name == "bn1":
            _bn(out, f"{prefix}.bn1", node, bnode)
        elif name == "fc":
            out[f"{prefix}.fc.weight"] = _t(np.asarray(node["kernel"]).T)
            out[f"{prefix}.fc.bias"] = _t(node["bias"])
        else:
            m = re.fullmatch(r"layer(\d)_(\d+)", name)
            if not m:
                raise KeyError(f"unknown base_model module {name!r}")
            block = f"{prefix}.layer{m.group(1)}.{m.group(2)}"
            for sub, snode in node.items():
                sb = bnode.get(sub, {})
                if sub in ("conv1", "conv2"):
                    _conv(out, f"{block}.{sub}", snode)
                elif sub in ("bn1", "bn2"):
                    _bn(out, f"{block}.{sub}", snode, sb)
                elif sub == "downsample_conv":
                    _conv(out, f"{block}.downsample.0", snode)
                elif sub == "downsample_bn":
                    _bn(out, f"{block}.downsample.1", snode, sb)
                else:
                    raise KeyError(f"unknown resnet leaf {name}.{sub}")


def _estimator(out, params, bstats, prefix):
    """Every estimator family, with the keys of
    `dmcnet_tpu/models/export_torch.py:91-112`."""
    for name, node in params.items():
        bnode = bstats.get(name, {})
        if re.fullmatch(r"conv_\d+(_mv|_r)?", name):
            # dense-family stage: Sequential(conv, LeakyReLU) -> .0
            _conv(out, f"{prefix}.{name}.0", node)
        elif name == "predict_flow" and "kernel" in node:
            _conv(out, f"{prefix}.predict_flow", node)
        elif name in ("predict_flow", "predict_att"):
            # ContextNetworkAtt heads: (conv, bn, LeakyReLU), the attention
            # one wrapped once more with its ReLU
            base = (f"{prefix}.{name}" if name == "predict_flow"
                    else f"{prefix}.{name}.0")
            _conv(out, f"{base}.0", node["conv"])
            _bn(out, f"{base}.1", node["bn"], bnode.get("bn", {}))
        elif re.fullmatch(r"stage_\d+", name):
            base = f"{prefix}.conv_context.{name.split('_')[1]}"
            _conv(out, f"{base}.0", node["conv"])
            _bn(out, f"{base}.1", node["bn"], bnode.get("bn", {}))
        else:
            raise KeyError(f"unknown gen_flow_model module {name!r}")


def state_dict_from_flax(params, batch_stats):
    """JAX-package {params, batch_stats} (nested dicts of arrays) of a
    DMCNet or PlainTSN -> the port's `state_dict` (float32 CPU tensors)."""
    out = {}
    for top, node in params.items():
        if top == "base_model":
            _resnet(out, node, batch_stats.get(top, {}), top)
        elif top == "gen_flow_model":
            _estimator(out, node, batch_stats.get(top, {}), top)
        else:
            raise KeyError(f"module {top!r} is not ported")
    return out


def state_dict_from_checkpoint(obj):
    """A loaded torch checkpoint (a bare state_dict, or the reference
    `.pth.tar` payload {epoch, arch, state_dict, best_prec1}) -> a
    state_dict with the DataParallel `module.` prefix stripped."""
    sd = obj.get("state_dict", obj) if isinstance(obj, dict) else obj
    return {(k[len("module."):] if k.startswith("module.") else k): v
            for k, v in sd.items()}
