"""`dmcnet_tpu_torch` imports neither JAX nor anything of the JAX package.

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
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "dmcnet_tpu"))
print(len(names))
print(",".join(bad))
"""


def test_port_imports_no_jax():
    root = os.path.dirname(os.path.dirname(dmcnet_tpu_torch.__file__))
    env = dict(os.environ, PYTHONPATH=root)
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env, cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    bad = lines[1] if len(lines) > 1 else ""
    assert int(lines[0]) >= 15
    assert bad == "", f"dmcnet_tpu_torch pulled in: {bad}"
