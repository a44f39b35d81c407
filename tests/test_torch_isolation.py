"""`dmcnet_tpu_torch` imports neither JAX, flax and msgpack nor anything of
the JAX package.

Runs in a fresh interpreter: the test session itself has imported jax
(tests/conftest.py)."""

import os
import subprocess
import sys

import dmcnet_tpu_torch

_PROBE = r"""
import importlib, pkgutil, sys
import dmcnet_tpu_torch
names = [m.name for m in pkgutil.walk_packages(dmcnet_tpu_torch.__path__,
                                               "dmcnet_tpu_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "msgpack",
                                    "dmcnet_tpu"))
print(",".join(names))
print(",".join(bad))
"""

# Modules the walk must reach (each imports without a CUDA call, an nvcc
# build or a native-decoder load).
REQUIRED = {"dmcnet_tpu_torch.train.engine", "dmcnet_tpu_torch.train.metrics",
            "dmcnet_tpu_torch.train.optimizers",
            "dmcnet_tpu_torch.train.checkpoints",
            "dmcnet_tpu_torch.cli.train", "dmcnet_tpu_torch.cli.test",
            "dmcnet_tpu_torch.cli.combine", "dmcnet_tpu_torch.cli.common",
            "dmcnet_tpu_torch.cli.train_options",
            "dmcnet_tpu_torch.utils.metrics_log",
            "dmcnet_tpu_torch.models.i3d",
            "dmcnet_tpu_torch.models.discriminators",
            "dmcnet_tpu_torch.data.video_iter",
            "dmcnet_tpu_torch.data.iterator_factory",
            "dmcnet_tpu_torch.train.engine_i3d",
            "dmcnet_tpu_torch.cli.evaluate_video_i3d",
            "dmcnet_tpu_torch.train.engine_gan",
            "dmcnet_tpu_torch.cli.train_gan",
            "dmcnet_tpu_torch.train.lr_scheduler",
            "dmcnet_tpu_torch.train.callback",
            "dmcnet_tpu_torch.models.initializer",
            "dmcnet_tpu_torch.models.import_tf_i3d",
            "dmcnet_tpu_torch.data.image_iterator",
            "dmcnet_tpu_torch.cli.train_i3d",
            "dmcnet_tpu_torch.cli.train_hmdb51",
            "dmcnet_tpu_torch.cli.train_ucf101",
            "dmcnet_tpu_torch.train.jax_checkpoint",
            "dmcnet_tpu_torch.parallel",
            "dmcnet_tpu_torch.parallel.multihost",
            "dmcnet_tpu_torch.parallel.mesh",
            "dmcnet_tpu_torch.parallel.fsdp",
            "dmcnet_tpu_torch.parallel.tensor",
            "dmcnet_tpu_torch.parallel.temporal",
            "dmcnet_tpu_torch.parallel.pipeline",
            "dmcnet_tpu_torch.parallel.pp_resnet",
            "dmcnet_tpu_torch.ops.packed_generator",
            "dmcnet_tpu_torch.ops.packed_resnet",
            "dmcnet_tpu_torch.utils.viz",
            "dmcnet_tpu_torch.utils.profiling",
            "dmcnet_tpu_torch.codec.mpeg4",
            "dmcnet_tpu_torch.__main__"}


def test_port_imports_no_jax():
    root = os.path.dirname(os.path.dirname(dmcnet_tpu_torch.__file__))
    env = dict(os.environ, PYTHONPATH=root)
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env, cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    bad = lines[1] if len(lines) > 1 else ""
    names = set(lines[0].split(","))
    assert len(names) >= 15
    assert REQUIRED <= names, sorted(REQUIRED - names)
    assert bad == "", f"dmcnet_tpu_torch pulled in: {bad}"
