"""Weight initialisation and 2D -> 3D kernel inflation on torch state dicts
(counterpart of `dmcnet_tpu/models/initializer.py`, reference
code/dmcnet_I3D/network/initializer.py):

  * `xavier_init(state_dict, rng)`: xavier-uniform over every conv and
    linear weight, biases to 0 (:14-38);
  * `inflate_2d_kernel(w2d, t, mode, rng)`: a (C_out, C_in, kh, kw) kernel
    to (C_out, C_in, t, kh, kw): 'inflation' tiles it over time divided by
    t (activations kept on temporally constant inputs), 'random' puts it
    at one temporal slice drawn by numpy's `default_rng(rng)`, the draw the
    JAX package makes, zeros elsewhere (:62-143);
  * `inflate_state_2d_to_3d`: every 4D kernel of a 2D state dict inflated
    to its 5D target.

Fans follow the JAX package's kernels, whose layout puts the output
channels last: fan_in = C_in x the kernel's extent, fan_out = C_out.
"""

from __future__ import annotations

import numpy as np
import torch


def xavier_init(state_dict, rng=None):
    """A copy of `state_dict` with every `weight` of two or more dimensions
    (conv and linear) drawn xavier-uniform, U(-a, a) with a = sqrt(6 /
    (fan_in + fan_out)), every `bias` zeroed, and the rest kept."""
    rng = np.random.default_rng(rng)
    out = {}
    for k, v in state_dict.items():
        leaf = k.rsplit(".", 1)[-1]
        if leaf == "weight" and v.ndim >= 2:
            fan_in, fan_out = int(np.prod(v.shape[1:])), int(v.shape[0])
            limit = float(np.sqrt(6.0 / (fan_in + fan_out)))
            out[k] = torch.from_numpy(
                rng.uniform(-limit, limit, size=tuple(v.shape))).to(v.dtype)
        elif leaf == "bias":
            out[k] = torch.zeros_like(v)
        else:
            out[k] = v
    return out


def inflate_2d_kernel(w2d, t, mode="inflation", rng=None):
    """(C_out, C_in, kh, kw) -> (C_out, C_in, t, kh, kw)."""
    if mode == "inflation":
        return (w2d / t).unsqueeze(2).expand(-1, -1, t, -1, -1).clone()
    if mode == "random":
        out = w2d.new_zeros(w2d.shape[:2] + (t,) + w2d.shape[2:])
        out[:, :, int(np.random.default_rng(rng).integers(t))] = w2d
        return out
    raise ValueError(f"unknown inflation mode {mode!r}")


def inflate_state_2d_to_3d(state_2d, target, mode="inflation", rng=None):
    """The keys of `state_2d` that `target` (a 3D state dict) has: a 4D
    `weight` whose target is 5D inflated to the target's temporal extent,
    a tensor of the target's shape copied, anything else left out."""
    out = {}
    for k, v in state_2d.items():
        if k not in target:
            continue
        tgt = target[k]
        if k.endswith("weight") and v.ndim == 4 and tgt.ndim == 5:
            out[k] = inflate_2d_kernel(v, tgt.shape[2], mode, rng)
        elif tuple(v.shape) == tuple(tgt.shape):
            out[k] = v
    return out
