"""Runner `video_test`: plain TSN scoring of whole videos, one video a
request, as `cli/test.py --plain 1` scores each video of its list: the
canvas and crop specs of `data.dmc_dataset.BatchAssembler.eval_batch`
(25 segments x 10 crops), then `cli.test.score_video` (`augment_eval_batch`,
the `PlainTSN`, `segment_consensus`), the video's scores read back.

The canvases come from a pool of u8 canvases (`synthetic.clip_pool`, the
assembler's layout) made at set-up, and the assembler lays out each of
them once at set-up: the host decode is left out of the window.  The
weights are seeded, then shaped as a trained network's on one more canvas
through the plain reference (`reference.coviar.calibrate`).

Traffic keys: `pool` canvases, `segments` a video, `items_per_request` and
`item_size` (1 and [1, 1]: a request is one video), `check_videos` answers
compared with the reference.
"""

from __future__ import annotations

import numpy as np

from benchmark import synthetic, weights
from benchmark.laps import Laps
from benchmark.reference import coviar as ref
from benchmark.reference.precision import rounder, strict_fp32
from benchmark.runners import i3d_eval
from benchmark.runners.i3d_eval import logit_gap
from benchmark.traffic import Schedule
from benchmark.yardstick import PEAK_FLOPS, flops, meta_state

MODE = "video_test"


class _Canvases:
    """The pool as the dataset `BatchAssembler` reads: item i -> (canvas
    (S, H, W, C) u8, label, (H, W))."""

    def __init__(self, canvases, labels, representation):
        self.canvases, self.labels = canvases, labels
        self.representation = representation

    def __len__(self):
        return len(self.canvases)

    def __getitem__(self, i):
        c = self.canvases[i][0]
        return c, int(self.labels[i]), c.shape[1:3]


class Cell:
    def __init__(self, cfg, traffic, seed, device, tracer):
        self.cfg, self.traffic, self.seed = cfg, traffic, int(seed)
        self.device, self.tracer = device, tracer
        self.schedule = Schedule(traffic, seed)
        self.videos = 0
        self.done = []   # (request index, pool index, (scores (C,), logits))
        self._want = {}  # pool index -> reference (scores, clip logits)
        self.phases = {}  # set-up seconds by step

    def setup(self):
        import torch

        from dmcnet_tpu_torch.cli.test import score_video
        from dmcnet_tpu_torch.data.dmc_dataset import BatchAssembler
        from dmcnet_tpu_torch.models.tsn import PlainTSN

        cfg, tr, geo = self.cfg, self.traffic, self.cfg["frame"]
        lap = Laps(self.phases)
        canvases = synthetic.clip_pool(
            self.seed, tr["pool"] + 1, tr["segments"], geo["height"],
            geo["width"], geo["channels"], self.device)
        self.canvases = canvases[:-1]
        self.labels = np.random.default_rng([self.seed, 3]).integers(
            0, cfg["num_class"], tr["pool"]).astype(np.int32)
        lap("inputs")
        self.sd = weights.make_state(ref.shapes(cfg), self.seed, self.device)
        with strict_fp32():
            ref.calibrate(self.sd, cfg, torch.as_tensor(
                canvases[-1][0], device=self.device))
        net = PlainTSN(cfg["num_class"], arch=cfg["arch"],
                       in_channels=cfg["in_channels"])
        net.load_state_dict(self.sd)
        self.net = net.to(self.device).eval()
        lap("weights and model")
        asm = BatchAssembler(
            _Canvases(self.canvases, self.labels, cfg["representation"]),
            input_size=cfg["input_size"], scale_size=cfg["scale_size"],
            test_crops=cfg["test_crops"])
        self.raw = [asm.eval_batch([k]) for k in range(tr["pool"])]
        self.aug = dict(representation=cfg["representation"],
                        input_size=cfg["input_size"],
                        negate_channels=asm.negate_channels,
                        device=self.device)
        self.score = score_video
        lap("crop specs")
        self._score(0)   # every shape of the scoring, once
        lap("warm step")

    def _one_video(self):
        import torch

        g = self.cfg["frame"]
        ref.clip_logits(meta_state(ref.shapes(self.cfg)), self.cfg,
                        torch.empty((self.traffic["segments"], g["height"],
                                     g["width"], g["channels"]),
                                    dtype=torch.uint8, device="meta"))

    def _score(self, k):
        with self.tracer.span("step"):
            # the iframe rides in the mv slot, as in `cli/test.py`
            out = self.score(self.net, self.raw[k], self.aug, "mv")
        with self.tracer.span("readback"):
            return out["scores"].cpu().numpy()[0], out["logits"]

    def request(self, i):
        (k,), = self.schedule.request(i)
        with self.tracer.span("request"):
            scores, logits = self._score(k)
        self.done.append((i, k, (scores, logits)))
        self.videos += 1
        return bool(scores.shape == (self.cfg["num_class"],)
                    and np.isfinite(scores).all())

    # videos a second; the sample: one answer of each pool canvas scored,
    # then others, `check_videos` in all, drawn from the seed
    end_to_end = i3d_eval.Cell.end_to_end
    sample = i3d_eval.Cell.sample

    def counters(self):
        return {"videos": self.videos, "units": self.videos,
                "flops_per_unit": flops(self._one_video),
                "peak_flops": PEAK_FLOPS[self.cfg["modes"][MODE]["peak"]]}

    def release(self):
        import torch

        del self.net
        if self.device != "cpu":
            torch.cuda.empty_cache()

    # -- correctness -----------------------------------------------------

    def reference_logits(self, k, precision="fp32"):
        """The reference's clip logits (10 x S, C) of pool canvas k."""
        import torch

        with torch.no_grad(), strict_fp32():
            canvas = torch.as_tensor(self.canvases[k][0], device=self.device)
            return ref.clip_logits(self.sd, self.cfg, canvas,
                                   rounder(precision)).double().cpu().numpy()

    def readings(self, stand_in=None):
        """Widest over `sample()` of the program's answers, or, with
        `stand_in` (a precision), of the reference computed in that
        precision put in the program's place: `logit_gap` of the video's
        scores (the mean over its clips), `clip_gap` of its clips'
        logits."""
        gaps = {"logit_gap": 0.0, "clip_gap": 0.0}
        for _, k, (scores, logits) in self.sample():
            if k not in self._want:
                want = self.reference_logits(k)
                self._want[k] = (want.mean(0), want)
            if stand_in:
                logits = self.reference_logits(k, stand_in)
                scores = logits.mean(0)
            else:
                logits = logits.double().cpu().numpy()
            gaps["logit_gap"] = max(gaps["logit_gap"],
                                    logit_gap(scores, self._want[k][0]))
            gaps["clip_gap"] = max(gaps["clip_gap"],
                                   logit_gap(logits, self._want[k][1]))
        return gaps
