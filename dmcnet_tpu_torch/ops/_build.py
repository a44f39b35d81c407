"""Build and load the port's hand-written CUDA kernels.

Each source under `ops/csrc/` exposes a plain C interface.  It is compiled
with `nvcc -O3 -gencode arch=compute_90a,code=sm_90a` into a shared library
at first use and loaded with ctypes; the wrappers pass tensor `data_ptr()`s
and the current stream's handle.  Only `nvcc` is needed: no ninja, and no
PyTorch headers.

Libraries land in `dmcnet_tpu_torch/_build/`, named by a hash of the source
and the flags, so an edited source is always rebuilt and a stale library is
never loaded.  Builds link under a temporary name and are renamed into
place, so concurrent processes never load a half-written file.  A failed
build raises `KernelBuildError` with the compiler's output; nothing falls
back to a plain version.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "ops", "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
NVCC_FLAGS = ("-O3", "-std=c++17", "-gencode", "arch=compute_90a,code=sm_90a",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded = {}
_lock = threading.Lock()


class KernelBuildError(RuntimeError):
    """A CUDA kernel source could not be compiled or loaded."""


class KernelLaunchError(RuntimeError):
    """A CUDA kernel launch was refused (cudaGetLastError() != 0)."""


def find_nvcc():
    """Path of nvcc: $CUDA_HOME/bin, then PATH, then /usr/local/cuda/bin."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    which = shutil.which("nvcc")
    if which:
        candidates.append(which)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise KernelBuildError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and "
        "/usr/local/cuda/bin): the CUDA toolkit is required to build the "
        "port's kernels")


def build(name):
    """Compile `ops/csrc/<name>.cu` (if not built yet) and return the path
    of its shared library plus the compiler's report (empty when the
    library was already built)."""
    src = os.path.join(CSRC_DIR, name + ".cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    out = os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")
    if os.path.exists(out):
        return out, ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.tmp.{os.getpid()}.{threading.get_ident()}"
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, src]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise KernelBuildError(
            f"nvcc failed for {src} (exit {proc.returncode}):\n"
            f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    return out, proc.stdout + proc.stderr


def load(name, declare):
    """Build if needed, then load `lib<name>` once per process.  `declare`
    sets argtypes/restype on the loaded ctypes library."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            path, _ = build(name)
            try:
                lib = ctypes.CDLL(path)
            except OSError as exc:
                raise KernelBuildError(f"cannot load {path}: {exc}") from exc
            declare(lib)
            _loaded[name] = lib
        return lib
