"""Dataset preparation: re-encode videos to MPEG-4 part 2 (the port's
counterpart of `dmcnet_tpu/codec/convert.py`).

Equivalent of the reference's convert_videos.py (ffmpeg `-c:v mpeg4
-filter:v scale=-2:360 -b:v 640k -an`, :55, parallel via joblib :46-49), but
self-contained: the port's native library transcodes through libav*
directly (`cv_transcode`; no ffmpeg command needed), in a thread pool.

CLI: python -m dmcnet_tpu_torch.codec.convert SRC_DIR DST_DIR
     [--height 360] [--bitrate 640000] [--gop 12] [--workers 8]
"""

from __future__ import annotations

import argparse
import os
import sys
from concurrent.futures import ThreadPoolExecutor

from dmcnet_tpu_torch.codec.mpeg4 import _lib

VIDEO_EXTS = (".avi", ".mp4", ".mkv", ".webm", ".mov", ".mpg", ".mpeg")


def transcode(in_path, out_path, height=360, gop=12, bit_rate=640_000):
    rc = _lib().cv_transcode(os.fspath(in_path).encode(),
                             os.fspath(out_path).encode(), height, gop,
                             bit_rate)
    if rc != 0:
        raise IOError(f"transcode failed ({rc}): {in_path}")


def convert_tree(src_dir, dst_dir, height=360, gop=12, bit_rate=640_000,
                 workers=8):
    """Re-encode every video under src_dir into dst_dir/<relpath>.mp4.
    Returns (number converted, [(source, error message)])."""
    jobs = []
    for root, _dirs, files in os.walk(src_dir):
        for f in files:
            if os.path.splitext(f)[1].lower() not in VIDEO_EXTS:
                continue
            src = os.path.join(root, f)
            rel = os.path.relpath(src, src_dir)
            dst = os.path.join(dst_dir, os.path.splitext(rel)[0] + ".mp4")
            os.makedirs(os.path.dirname(dst), exist_ok=True)
            jobs.append((src, dst))

    def one(job):
        src, dst = job
        try:
            transcode(src, dst, height, gop, bit_rate)
        except IOError as exc:
            return src, str(exc)
        return None

    with ThreadPoolExecutor(max_workers=workers) as pool:
        failures = [f for f in pool.map(one, jobs) if f is not None]
    return len(jobs) - len(failures), failures


def main(argv=None):
    p = argparse.ArgumentParser(description="re-encode videos to mpeg4")
    p.add_argument("src_dir")
    p.add_argument("dst_dir")
    p.add_argument("--height", type=int, default=360)
    p.add_argument("--bitrate", type=int, default=640_000)
    p.add_argument("--gop", type=int, default=12)
    p.add_argument("--workers", type=int, default=8)
    args = p.parse_args(argv)
    ok, failures = convert_tree(args.src_dir, args.dst_dir, args.height,
                                args.gop, args.bitrate, args.workers)
    print(f"converted {ok} videos, {len(failures)} failures")
    for src, err in failures:
        print(f"  FAILED {src}: {err}")
    return 0 if not failures else 1


if __name__ == "__main__":
    sys.exit(main())
