"""Batch serving command: compressed videos in, action scores out.

The port's counterpart of `dmcnet_tpu/cli/serve.py`, flag for flag, plus
`--device` (default `cuda`):

    python -m dmcnet_tpu_torch.cli.serve --weights ckpt.pth.tar \
        --data-name hmdb51 --test-list test.txt --data-root videos/ \
        --save-scores dmc_scores.npz --device cuda

- native decode-once front-end, back-trace on the card from MV block lists
  (the host entropy-decodes only), DenseNet generator + ResNet classifier;
- GOPs of many videos batched into fixed-size device programs
  (`predict_videos`);
- the score dump is bit-compatible with reference `test.py:183-198`, so the
  reference `combine.py` / `run_combine.sh` fuse its output.
- `--mesh-devices N` serves over the first N cards (`DMCPredictor(mesh=)`).

Inputs are either a reference-format list file (``video _ label`` lines,
code/dmcnet/dataset.py:116-128) or bare video paths on the command line.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

from dmcnet_tpu_torch.cli.common import (
    first_devices,
    num_classes_for,
    save_scores_npz,
)


def build_parser():
    parser = argparse.ArgumentParser(
        description="Batch video scoring with the PyTorch/CUDA serving pipeline")
    parser.add_argument('videos', nargs='*',
                        help='video files to score (alternative to '
                             '--test-list)')
    parser.add_argument('--data-name', type=str, default=None,
                        choices=['ucf101', 'hmdb51', 'kinetics400'])
    parser.add_argument('--num-class', type=int, default=None,
                        help='overrides --data-name class count')
    parser.add_argument('--data-root', type=str, default='')
    parser.add_argument('--test-list', type=str, default=None,
                        help='reference-format list: "video _ label" lines')
    parser.add_argument('--weights', type=str, required=True,
                        help='framework checkpoint or reference .pth.tar')
    parser.add_argument('--arch', type=str, default='resnet18')
    parser.add_argument('--arch_estimator', type=str, default='DenseNetTiny')
    parser.add_argument('--gen_flow_or_delta', type=int, default=1)
    parser.add_argument('--mv_minmaxnorm', type=int, default=1)
    parser.add_argument('--input_size', type=int, default=224)
    parser.add_argument('--segments', type=int, default=0,
                        help='score by the reference TSN test protocol: N '
                             'segment-centre frames per video (reference '
                             'test.py --test-segments 25) instead of '
                             '--frames-per-gop frames from EVERY GOP — '
                             'decodes ~num_gops/N fewer GOPs on long '
                             'videos')
    parser.add_argument('--frames-per-gop', type=int, default=3,
                        help='P-frames sampled per GOP (TSN-style '
                             'score averaging)')
    parser.add_argument('--backend', type=str, default='auto',
                        choices=['auto', 'device', 'host'],
                        help='device = back-trace on the card from '
                             'MV block lists; host = native accumulate; '
                             'auto = device with per-video fallback')
    parser.add_argument('--host-workers', type=int, default=0,
                        help='threads for the per-video host gather '
                             '(entropy decode runs GIL-free; scales with '
                             'host cores)')
    parser.add_argument('--chunk-gops', type=int, default=64,
                        help='GOPs per device program (predict_videos '
                             'batching quantum)')
    parser.add_argument('--mesh-devices', type=int, default=0,
                        help='serve over the first N cards, a model '
                             'replica on each, every GOP chunk and host '
                             'clip batch split over them (0 = --device '
                             'alone); N above the visible cards raises; '
                             'with --device cpu, N CPU replicas')
    parser.add_argument('--no-pack', action='store_true',
                        help='accepted for compatibility: the port runs '
                             'the unpacked float32 forward only')
    parser.add_argument('--device', type=str, default='cuda',
                        help='torch device to serve on (cuda, cuda:N, cpu)')
    parser.add_argument('--save-scores', type=str, default=None,
                        help='combine-compatible npz (reference '
                             'test.py:183-198 layout)')
    parser.add_argument('--warmup', type=str, default=None,
                        help='comma-separated stream geometries to '
                             'precompile before scoring, each '
                             'HxW[:gop_len[:cell]] (defaults 12, 16) — '
                             'e.g. "256x320,240x320:12:8"; gop_len/cell '
                             'must match the streams; the kernel build and '
                             'first-call set-up then happen before traffic')
    parser.add_argument('--on-error', type=str, default='raise',
                        choices=['raise', 'zero'],
                        help='zero = keep the batch alive through corrupt '
                             'videos (zero scores + stderr report)')
    parser.add_argument('--stdin', action='store_true',
                        help='daemon mode: read one request per line from '
                             'stdin (a video path, or JSON '
                             '{"path": ..., "id": ...}) and emit one JSON '
                             'result line per request — the predictor '
                             'stays loaded between requests; combine with '
                             '--warmup to absorb set-up before traffic')
    return parser


def serve_stdin(predictor, args, inp=None, out=None):
    """JSON-lines request loop: one video per line, one result per line.

    Per-request failures never kill the daemon — they emit an
    {"error": ...} line (a production server must outlive one corrupt
    upload).  EOF on stdin ends the loop."""
    import json

    inp = inp if inp is not None else sys.stdin
    out = out if out is not None else sys.stdout
    for i, line in enumerate(inp):
        line = line.strip()
        if not line:
            continue
        req = {"path": line, "id": i}
        if line.startswith("{"):
            try:
                req = {"id": i, **json.loads(line)}
            except ValueError as exc:
                print(json.dumps({"id": i, "error": f"bad json: {exc}"}),
                      file=out, flush=True)
                continue
        t0 = time.time()
        try:
            scores = predictor.predict_videos(
                [req["path"]], frames_per_gop=args.frames_per_gop,
                backend=args.backend, chunk_gops=args.chunk_gops,
                host_workers=args.host_workers, on_error=args.on_error,
                segments=args.segments or None)
            s = np.asarray(scores[0])
            result = {"id": req["id"], "path": req["path"],
                      "pred": int(s.argmax()), "score": float(s.max()),
                      "ms": round((time.time() - t0) * 1e3, 2)}
        except Exception as exc:  # noqa: BLE001 — daemon must survive
            result = {"id": req["id"], "path": req.get("path"),
                      "error": repr(exc)[:200],
                      "ms": round((time.time() - t0) * 1e3, 2)}
        print(json.dumps(result), file=out, flush=True)


def parse_inputs(args):
    """-> (paths, labels, names); labels/names None without a list file."""
    if args.test_list:
        paths, labels, names = [], [], []
        with open(args.test_list) as f:
            for line in f:
                parts = line.strip().split()
                if not parts:
                    continue
                name = parts[0]
                label = int(parts[-1]) if len(parts) > 1 else -1
                path = os.path.join(args.data_root, name)
                if not os.path.exists(path) and path.endswith(('.avi',
                                                               '.mp4')):
                    path = os.path.splitext(path)[0] + '.mp4'
                paths.append(path)
                labels.append(label)
                names.append(name)
        return paths, labels, names
    if not args.videos:
        raise SystemExit("either --test-list or video paths are required")
    names = [os.path.basename(p) for p in args.videos]
    if len(set(names)) != len(names):
        # duplicate basenames would collapse in the sorted-by-name npz
        # (save_scores_npz keys rows by name), silently dropping scores
        names = list(args.videos)
    return list(args.videos), None, names


def mesh_devices(n, device):
    """The `--mesh-devices` replicas (`common.first_devices`)."""
    return first_devices(n, device, "--mesh-devices")


def main(argv=None):
    args = build_parser().parse_args(argv)
    from dmcnet_tpu_torch.serving import DMCPredictor

    num_class = args.num_class or num_classes_for(args.data_name or
                                                  'hmdb51')
    if not args.stdin:
        paths, labels, names = parse_inputs(args)

    where = {"device": args.device}
    if args.mesh_devices:
        where = {"mesh": mesh_devices(args.mesh_devices, args.device)}

    predictor = DMCPredictor.from_checkpoint(
        args.weights, num_class=num_class, arch=args.arch,
        arch_estimator=args.arch_estimator,
        gen_flow_or_delta=args.gen_flow_or_delta,
        mv_minmaxnorm=args.mv_minmaxnorm, input_size=args.input_size,
        **where)

    if args.warmup:
        def parse_geom(g):
            hw, *rest = g.split(':')
            return tuple(int(v) for v in hw.split('x')) \
                + tuple(int(v) for v in rest)

        geoms = [parse_geom(g) for g in args.warmup.split(',')]
        t0 = time.time()
        predictor.warmup(geometries=geoms, chunk_gops=args.chunk_gops,
                         frames_per_gop=args.frames_per_gop)
        print(f"warmed {len(geoms)} geometries in {time.time() - t0:.1f}s")

    if args.stdin:
        return serve_stdin(predictor, args)

    t0 = time.time()
    scores = predictor.predict_videos(paths,
                                      frames_per_gop=args.frames_per_gop,
                                      backend=args.backend,
                                      chunk_gops=args.chunk_gops,
                                      host_workers=args.host_workers,
                                      on_error=args.on_error,
                                      segments=args.segments or None)
    dt = time.time() - t0
    print(f"scored {len(paths)} videos in {dt:.2f}s "
          f"({len(paths) / dt:.2f} videos/sec)")

    preds = [int(np.argmax(s)) for s in scores]
    if labels is not None and any(l >= 0 for l in labels):
        mask = [l >= 0 for l in labels]
        acc = float(np.mean([p == l for p, l, m in
                             zip(preds, labels, mask) if m]))
        print(f"Accuracy {acc * 100:.02f}% ({sum(mask)})")
    else:
        labels = [-1] * len(paths)
        for p, s, pr in zip(paths, scores, preds):
            print(f"{p}\tpred={pr}\ttop={float(np.max(s)):.4f}")

    if args.save_scores:
        output = [(np.asarray(s)[None, :], l)
                  for s, l in zip(scores, labels)]
        save_scores_npz(args.save_scores, output, labels, names)
        print(f"saved scores to {args.save_scores}")
    return scores


if __name__ == "__main__":
    main(sys.argv[1:])
