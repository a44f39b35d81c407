#!/usr/bin/env python3
"""Time builds of the GOP back-trace kernels (B1, B2) on one NVIDIA GPU.

    python3 tools/bench_torch_backtrace.py [--source LABEL=PATH[,D...]]...
        [--rounds 2] [--out DIR]

Compares `dmcnet_tpu_torch/ops/csrc/backtrace_warp.cu` ("shipped") with
each `--source`: a .cu with the same C interface, such as that file at
another commit (`git show REV:dmcnet_tpu_torch/ops/csrc/backtrace_warp.cu`),
built with the `-D` defines listed after its path (`NAME=VALUE`, comma
separated).  All are compiled with `ops/_build.NVCC_FLAGS` by parallel nvcc
processes and launched through the package's wrappers (`ops/backtrace.py`).
Each build is held bit-equal to the plain versions at the timed shapes and
at `chip_smoke.RAGGED`.  Then B1 at the serving shape (G=64, T=12, 256x320,
cell 16) and B2 at T=12, 256x320, cells 16 and 8 are timed by device time
over queued launches (`chip_smoke.device_ms_per_call`), the builds in turns
(A B .. B A) for `--rounds` rounds, beside the launch floor (a 1-element
`zero_()`) and a `zero_()` of B1's outputs.  Writes the ptxas reports, the
shipped build's SASS (`cuobjdump -sass`) and `bench.json` to `--out`, and
prints one JSON line per build.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from chip_smoke import RAGGED, device_ms_per_call  # noqa: E402
from dmcnet_tpu_torch.codec.synthetic import (  # noqa: E402
    block_arrays,
    synthetic_gop,
)
from dmcnet_tpu_torch.ops import _build  # noqa: E402
from dmcnet_tpu_torch.ops import backtrace as bt  # noqa: E402

G, T, H, W = 64, 12, 256, 320


def build_all(sources, out_dir):
    """{label: (path, defines)} -> {label: (ctypes library, path, ptxas
    report)}, compiled by parallel nvcc processes into `out_dir`."""
    procs = {}
    for i, (label, (src, defines)) in enumerate(sources.items()):
        lib = os.path.join(out_dir, f"libbacktrace-{i}.so")
        cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS,
               *(f"-D{d}" for d in defines), "-o", lib, src]
        procs[label] = (lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    libs = {}
    for label, (path, proc) in procs.items():
        report, _ = proc.communicate()
        if proc.returncode != 0:
            raise _build.KernelBuildError(f"nvcc failed for {label}:\n"
                                          f"{report}")
        lib = ctypes.CDLL(path)
        bt._declare(lib)
        libs[label] = (lib, path, report)
    return libs


def use(lib):
    """Make the package's wrappers launch `lib`'s kernels."""
    _build._loaded["backtrace_warp"] = lib


def serving_inputs(rng, dev):
    """G synthetic GOPs as the smoke's main path makes them: cell grids at
    cell 16 and the I-frames (G, 3, H, W) int32."""
    cms, ifrs = [], []
    for _ in range(G):
        block_lists, frames = synthetic_gop(rng, num_frames=T, height=H,
                                            width=W, max_motion=16)
        cm, cell = bt.cell_mv_from_blocks_np(*block_arrays(block_lists), H,
                                             W)
        assert cm is not None and cell == 16
        cms.append(cm)
        ifrs.append(frames[0].transpose(2, 0, 1))
    return (torch.as_tensor(np.stack(cms), dtype=torch.int32, device=dev),
            torch.as_tensor(np.ascontiguousarray(np.stack(ifrs)),
                            dtype=torch.int32, device=dev))


def max_err(cases, refs):
    """Largest |kernel - plain| of B1 and B2 over `cases` (cm, ifr, h, w,
    cell), against `refs`, their plain B1 outputs; B2 runs on each case's
    first GOP."""
    err = 0
    for (cm, ifr, h, w, cell), (ra, rw) in zip(cases, refs):
        accu, warped = bt.backtrace_warp_batch(cm, ifr, h, w, cell)
        gop = bt.backtrace_gop_cells(cm[0].contiguous(), h, w, cell)
        torch.cuda.synchronize()
        err = max(err, int((accu - ra).abs().max()),
                  int((warped - rw).abs().max()),
                  int((gop - ra[0]).abs().max()))
    return err


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--source", action="append", default=[],
                    metavar="LABEL=PATH[,D...]",
                    help="another .cu with the same C interface, and -D "
                    "defines for it")
    ap.add_argument("--out", default=os.path.join(_build.BUILD_DIR,
                                                  "bench"))
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_torch_backtrace: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    os.makedirs(args.out, exist_ok=True)
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(card, flush=True)
    sources = {"shipped": (os.path.join(_build.CSRC_DIR,
                                        "backtrace_warp.cu"), [])}
    for spec in args.source:
        label, rest = spec.split("=", 1)
        path, *defines = rest.split(",")
        sources[label] = (path, defines)
    libs = build_all(sources, args.out)
    with open(os.path.join(args.out, "ptxas.txt"), "w") as f:
        for label, (_, _, report) in libs.items():
            f.write(f"== {label}\n{report}\n")
            regs = [ln.strip() for ln in report.splitlines()
                    if "registers" in ln]
            print(f"{label}: {'; '.join(regs)}", flush=True)
    cuobjdump = shutil.which("cuobjdump") or os.path.join(
        os.path.dirname(_build.find_nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", libs["shipped"][1]],
                          capture_output=True, text=True)
    with open(os.path.join(args.out, "shipped.sass"), "w") as f:
        f.write(sass.stdout + sass.stderr)

    rng = np.random.default_rng(0)
    cm, ifr = serving_inputs(rng, dev)
    bl8, _ = synthetic_gop(rng, num_frames=T, height=H, width=W,
                           block_size=8, max_motion=16)
    cm8, cell8 = bt.cell_mv_from_blocks_np(*block_arrays(bl8), H, W)
    assert cell8 == 8
    cm8 = torch.as_tensor(cm8, device=dev)
    cases = [(cm, ifr, H, W, 16), (cm8[None], ifr[:1], H, W, 8)]
    for cell, h, w, t in RAGGED:
        m = bt.max_mv(cell)
        rc = rng.integers(-m, m + 1, size=(3, t, h // cell, w // cell, 2))
        ri = rng.integers(0, 256, size=(3, 3, h, w))
        cases.append((torch.as_tensor(rc, dtype=torch.int32, device=dev),
                      torch.as_tensor(ri, dtype=torch.int32, device=dev),
                      h, w, cell))
    refs = [bt.backtrace_warp_batch_ref(*case) for case in cases]
    errs = {}
    for label, (lib, _, _) in libs.items():
        use(lib)
        errs[label] = max_err(cases, refs)
    print(f"max |kernel - plain| over {len(cases)} shapes: {errs}",
          flush=True)

    accu = torch.empty((G, T, 2, H, W), dtype=torch.int32, device=dev)
    warped = torch.empty((G, T, 3, H, W), dtype=torch.int32, device=dev)
    cm16 = cm[0].contiguous()
    one = torch.empty(1, device=dev)
    times = {label: {"b1_ms": [], "b2_c16_ms": [], "b2_c8_ms": []}
             for label in libs}
    floor, fill = [], []
    order = list(libs)
    for r in range(args.rounds):
        for label in (order if r % 2 == 0 else order[::-1]):
            use(libs[label][0])
            t = times[label]
            t["b1_ms"].append(device_ms_per_call(
                lambda: bt.backtrace_warp_batch(cm, ifr, H, W, 16), 20,
                torch))
            t["b2_c16_ms"].append(device_ms_per_call(
                lambda: bt.backtrace_gop_cells(cm16, H, W, 16), 100, torch))
            t["b2_c8_ms"].append(device_ms_per_call(
                lambda: bt.backtrace_gop_cells(cm8, H, W, 8), 100, torch))
            floor.append(device_ms_per_call(lambda: one.zero_(), 100, torch))
            fill.append(device_ms_per_call(
                lambda: (accu.zero_(), warped.zero_()), 20, torch))
    b1_bytes = (cm.numel() + ifr.numel() + accu.numel() + warped.numel()) * 4
    results = []
    for label, t in times.items():
        row = {"build": label, "source": sources[label][0],
               "defines": sources[label][1], "max_abs_err": errs[label],
               **t, "b1_GB_per_s": b1_bytes / min(t["b1_ms"]) / 1e6}
        results.append(row)
        print(json.dumps(row), flush=True)
    summary = {"launch_floor_ms": floor, "b1_outputs_zero_ms": fill,
               "b1_bytes": b1_bytes, "card": card}
    print(json.dumps(summary), flush=True)
    with open(os.path.join(args.out, "bench.json"), "w") as f:
        json.dump({"results": results, **summary}, f, indent=1)
    bad = {k: v for k, v in errs.items() if v}
    if bad:
        print(f"builds that disagree with the plain version: {bad}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
