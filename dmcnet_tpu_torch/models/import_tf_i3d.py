"""Import Kinetics TF I3D checkpoints into the port's `I3D` (counterpart of
`dmcnet_tpu/models/import_tf_i3d.py`, reference `load_tf_weights`,
code/dmcnet_I3D/network/i3d.py:605-763).

The importer reads a mapping of TF variable names to numpy arrays, from
`np.load` of an exported .npz, so no TensorFlow is needed, and writes the
port's reference keys:

  * TF conv3d kernels (kt, kh, kw, C_in, C_out) -> `conv3d.weight`
    (C_out, C_in, kt, kh, kw), as the reference transposes them
    (i3d.py:719-722);
  * TF batch norm stores beta and the moving mean and variance, no gamma:
    `batch3d.weight` is ones (i3d.py:730-736);
  * the released checkpoint names mixed_5b's second Branch_2 conv
    `Conv3d_0a_3x3`, a typo the reference's `fix_typo` handles
    (i3d.py:737-746);
  * only the backbone through `Logits/Conv3d_0c_1x1` is in the file: the
    400 -> num_classes `classifier` keeps its initialisation;
  * a stem of another input-channel count is channel-meaned and broadcast
    (reference train/model.py:55-58).

A variable the mapping needs and the file lacks raises `KeyError`.
"""

from __future__ import annotations

import numpy as np
import torch

from dmcnet_tpu_torch.models.weights import load_matching

_CONVS = [("conv3d_1a_7x7", "Conv3d_1a_7x7"),
          ("conv3d_2b_1x1", "Conv3d_2b_1x1"),
          ("conv3d_2c_3x3", "Conv3d_2c_3x3")]

_MIXED = ["mixed_3b", "mixed_3c", "mixed_4b", "mixed_4c", "mixed_4d",
          "mixed_4e", "mixed_4f", "mixed_5b", "mixed_5c"]


def _mixed_branches(name):
    """The port's branch keys -> TF sub-scope, for one Mixed block."""
    fix_typo = name == "mixed_5b"
    return {
        "branch_0": "Branch_0/Conv3d_0a_1x1",
        "branch_1.0": "Branch_1/Conv3d_0a_1x1",
        "branch_1.1": "Branch_1/Conv3d_0b_3x3",
        "branch_2.0": "Branch_2/Conv3d_0a_1x1",
        "branch_2.1": ("Branch_2/Conv3d_0a_3x3" if fix_typo
                       else "Branch_2/Conv3d_0b_3x3"),
        "branch_3.1": "Branch_3/Conv3d_0b_1x1",
    }


def _get(tf_vars, name):
    if name in tf_vars:
        return np.asarray(tf_vars[name], np.float32)
    raise KeyError(f"TF variable {name!r} not in checkpoint "
                   f"({len(tf_vars)} vars)")


def _tensor(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _load_unit(out, key, tf_vars, scope, *, bias=False, bn=True,
               in_channels=None):
    """One Unit3D: conv_3d/w [+ conv_3d/b] [+ batch_norm/{beta,moving_*}]."""
    w = _get(tf_vars, f"{scope}/conv_3d/w")
    if in_channels and w.shape[3] != in_channels:
        w = np.broadcast_to(w.mean(axis=3, keepdims=True),
                            w.shape[:3] + (in_channels,) + w.shape[4:])
    out[f"{key}.conv3d.weight"] = _tensor(np.transpose(w, (4, 3, 0, 1, 2)))
    if bias:
        out[f"{key}.conv3d.bias"] = _tensor(_get(tf_vars,
                                                 f"{scope}/conv_3d/b"))
    if bn:
        beta = _get(tf_vars, f"{scope}/batch_norm/beta").reshape(-1)
        out[f"{key}.batch3d.weight"] = torch.ones(beta.shape)
        out[f"{key}.batch3d.bias"] = _tensor(beta)
        for stat, tf_stat in (("running_mean", "moving_mean"),
                              ("running_var", "moving_variance")):
            out[f"{key}.batch3d.{stat}"] = _tensor(_get(
                tf_vars, f"{scope}/batch_norm/{tf_stat}").reshape(-1))


def import_tf_i3d(tf_vars, modality="rgb", in_channels=None):
    """TF variable name -> array mapping -> the port's state dict of the
    backbone (float32).  `modality` "rgb" reads the 'RGB/inception_i3d'
    scope, any other the 'Flow/inception_i3d' one (reference
    i3d.py:607-611); the stem is adapted to `in_channels` when given."""
    prefix = ("RGB/inception_i3d" if modality == "rgb"
              else "Flow/inception_i3d")
    out = {}
    for key, tf_name in _CONVS:
        _load_unit(out, key, tf_vars, f"{prefix}/{tf_name}",
                   in_channels=(in_channels if key == "conv3d_1a_7x7"
                                else None))
    for name in _MIXED:
        tf_mixed = f"{prefix}/{name[0].upper() + name[1:]}"
        for branch, sub in _mixed_branches(name).items():
            _load_unit(out, f"{name}.{branch}", tf_vars,
                       f"{tf_mixed}/{sub}")
    _load_unit(out, "conv3d_0c_1x1", tf_vars,
               f"{prefix}/Logits/Conv3d_0c_1x1", bias=True, bn=False)
    return out


def load_tf_weights(path_or_vars, model, modality="rgb", in_channels=None):
    """Partial load of TF I3D weights into `model`: `path_or_vars` is an
    .npz path (keys with '/' separators) or a name -> array mapping.
    Tensors of another shape than the model's are left out.  Returns
    (report, unfilled): "tf-imported=N shape-missed=N", the parameters
    (not BN statistics) imported and the imported keys left out; the
    model's keys the file did not fill, sorted (the classifier among
    them)."""
    if isinstance(path_or_vars, (str, bytes)):
        with np.load(path_or_vars) as z:
            tf_vars = {k: z[k] for k in z.files}
    else:
        tf_vars = dict(path_or_vars)
    imported = import_tf_i3d(tf_vars, modality=modality,
                             in_channels=in_channels)
    loaded, unfilled = load_matching(model, imported)
    n = sum(1 for k in imported if not k.endswith(("running_mean",
                                                    "running_var")))
    return f"tf-imported={n} shape-missed={len(imported) - len(loaded)}", \
        unfilled
