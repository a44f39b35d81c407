"""End-to-end video inference: compressed file -> action scores.

The port's counterpart of `dmcnet_tpu/serving.py`.  The native front-end
entropy-decodes each GOP once and emits MV block lists; the card runs the
back-trace kernel (`ops/csrc/backtrace_warp.cu`), the frame pick, the center
crop, the exact integer u8 encode of the accumulated MV and residual, the
DenseNet generator with the `+mv` delta and the ResNet classifier; scores are
averaged per video, TSN-style.

    predictor = DMCPredictor.from_checkpoint(ckpt, num_class=51)
    scores = predictor.predict_video("video.mp4")   # (num_class,)

The forward is the JAX package's.  `pack=True` (the default) serves its
folded forward: for a dense estimator with ResNet-18, the u8 normalize
(x/255 - 0.5)/std is folded into the generator's weights (`input_affine`)
and the `+mv` delta fused into `predict_flow` (`fuse_mv_delta`), the
generator's packed output feeds `ops.packed_resnet.PackedResNet18` (a
packed stem, inference BN folded), and both run in bfloat16 on the raw u8
values, exact in bfloat16 below 256; with another classifier only the
generator is packed, in bfloat16, followed by the float32 `+mv` and the
model's classifier; any other estimator serves the unfolded forward.
`pack=False` is the unfolded float32 forward.  What the JAX code does only
for the TPU is not carried over: frames are picked with an index gather
(not a one-hot contraction), inputs move as separate tensors (not one flat
u8 buffer), and nothing is compiled per shape.

Several cards (`mesh=[device, ...]`, the JAX package's 1-D serving mesh):
the predictor holds a replica of the model on each device, splits each GOP
chunk and each host-path clip batch into contiguous per-device slices
(`np.array_split`: ragged shares, no quantum to lift since nothing is
compiled per shape), copies each slice to its device, launches every
device's program before it reads any result back, so that the cards
overlap, and concatenates the outputs in input order.  GOPs are
independent: each device back-traces its own with the kernel
(`backtrace_warp_batch`, once per device per chunk) and no collective
runs.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from dmcnet_tpu_torch import resolve_device
from dmcnet_tpu_torch.codec.host_accumulate import gop_mv_residual_u8
from dmcnet_tpu_torch.codec.mpeg4 import shared_reader_cache
from dmcnet_tpu_torch.data.transforms import IMAGENET_STD, MEAN_STD
from dmcnet_tpu_torch.models.generators import _DenseEstimator
from dmcnet_tpu_torch.models.tsn import DMCNet
from dmcnet_tpu_torch.ops.backtrace import backtrace_warp_batch
from dmcnet_tpu_torch.ops.packed_generator import PackedDenseEstimator
from dmcnet_tpu_torch.ops.packed_resnet import PackedResNet18


class DMCPredictor:
    """MV-representation DMC-Net inference over whole videos, in eval mode
    on `device` (default CUDA; raises when CUDA is unavailable), or over
    the devices of `mesh`."""

    _gop_quant = 4  # GOP-batch size quantum of the chunk ladder

    def __init__(self, state_dict=None, num_class=51, arch="resnet18",
                 arch_estimator="DenseNetTiny", gen_flow_or_delta=1,
                 mv_minmaxnorm=1, input_size=224, pack=True, mesh=None,
                 backtrace_impl=None, device=None, seed=0):
        """`state_dict`: the port's (or a reference) DMCNet state_dict;
        None keeps the random initialisation drawn from `seed`.  `pack`:
        serve the folded bfloat16 forward (module docstring), its packed
        modules built once for each device.
        `mesh`: a sequence of devices to serve over (a replica on each;
        `device` is then its first); cards need CUDA, with no fallback.
        `backtrace_impl` replaces `backtrace_warp_batch` (the kernel on
        CUDA tensors, its plain version on CPU tensors)."""
        if mesh is not None and device is not None:
            raise ValueError("give either `device` or `mesh`")
        self.mesh = ([resolve_device(d) for d in mesh] if mesh is not None
                     else [resolve_device(device)])
        if not self.mesh:
            raise ValueError("an empty mesh")
        if any(d.type == "cuda" for d in self.mesh) and \
                not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available: a mesh of cards "
                               "needs it")
        self.device = self.mesh[0]
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            self.model = DMCNet(num_class=num_class, num_segments=1,
                                arch=arch, arch_estimator=arch_estimator,
                                gen_flow_or_delta=gen_flow_or_delta)
        if state_dict is not None:
            self.model.load_state_dict(state_dict)
        self.model.to(self.device).eval()
        # one replica a device (the first is `model`)
        self.replicas = [self.model] + [
            copy.deepcopy(self.model).to(d) for d in self.mesh[1:]]
        self.input_size = input_size
        self.mv_minmaxnorm = mv_minmaxnorm
        self.gen_flow_or_delta = gen_flow_or_delta
        self.packed = self.packed_cls = None   # per device, when packing
        if pack and isinstance(self.model.gen_flow_model, _DenseEstimator):
            full = arch == "resnet18"
            affine = None
            if full:
                # the normalize of _forward_u8, folded into the weights
                affine = (np.concatenate([[1.0 / (255.0 * MEAN_STD)] * 2,
                                          1.0 / (255.0 * IMAGENET_STD)]),
                          np.concatenate([[-0.5 / MEAN_STD] * 2,
                                          -0.5 / IMAGENET_STD]))
            gen = PackedDenseEstimator(
                self.model.gen_flow_model, packed_output=full,
                fuse_mv_delta=full and bool(gen_flow_or_delta),
                input_affine=affine)
            self.packed = [copy.deepcopy(gen).to(d) for d in self.mesh]
            if full:
                cls = PackedResNet18(self.model.base_model)
                self.packed_cls = [copy.deepcopy(cls).to(d)
                                   for d in self.mesh]
        self._res_std = [torch.as_tensor(IMAGENET_STD, device=d)
                         for d in self.mesh]
        self._backtrace = backtrace_impl or backtrace_warp_batch

    @classmethod
    def from_checkpoint(cls, path, num_class=51, **kwargs):
        """Load a checkpoint in any of the port's formats
        (`train.checkpoints.read_model_state`): a torch file (the port's
        state_dict or a reference `.pth.tar` {epoch, arch, state_dict,
        best_prec1}, DataParallel `module.` prefix stripped), a JAX package
        msgpack file, or a step directory of `--ckpt-backend orbax`
        (its newest committed step); `kwargs` (`pack`, `mesh`, ...) go to
        the constructor.  Keys of modules the forward does not
        use (the reference's `data_bn`, a GAN discriminator) are dropped;
        a missing key raises.  A JAX orbax directory raises `SystemExit`
        naming its format."""
        from dmcnet_tpu_torch.train.checkpoints import read_model_state

        sd = {k: v.float() if v.is_floating_point() else v
              for k, v in read_model_state(path).items()
              if k.startswith(("base_model.", "gen_flow_model."))}
        return cls(sd, num_class=num_class, **kwargs)

    @torch.inference_mode()
    def _forward_u8(self, mv, res, replica=0):
        """uint8-encoded representation (N, S, S, 2|3) -> float32 logits
        (N, C) by the replica `replica`, on its device; normalised exactly
        like the training pipeline (reference dataset.py:251-263), or with
        the normalize folded into the packed generator."""
        if self.packed_cls is not None:
            # the normalize and +mv live in the packed weights: raw u8 in
            x = torch.cat([mv, res], -1).permute(0, 3, 1, 2)
            return self.packed_cls[replica](
                self.packed[replica](x.to(torch.bfloat16))).float()
        mv = ((mv.float() / 255.0 - 0.5) / MEAN_STD).permute(0, 3, 1, 2)
        res = ((res.float() / 255.0 - 0.5)
               / self._res_std[replica]).permute(0, 3, 1, 2)
        model = self.replicas[replica]
        if self.packed is not None:
            x = torch.cat([mv, res], 1).to(torch.bfloat16)
            dmc = self.packed[replica](x).float()
            return model.classify(dmc + mv if self.gen_flow_or_delta
                                  else dmc)
        logits, _ = model(mv, res)
        return logits

    def _shares(self, n):
        """[(replica, start, stop)] of `n` rows split over the mesh
        (`np.array_split`'s ragged shares), empty shares left out."""
        bounds = np.cumsum([0] + [len(a) for a in np.array_split(
            np.arange(n), len(self.mesh))])
        return [(i, int(a), int(b))
                for i, (a, b) in enumerate(zip(bounds[:-1], bounds[1:]))
                if b > a]

    def _forward_u8_mesh(self, mv, res):
        """`_forward_u8` of host u8 arrays (N, S, S, 2|3) over the mesh:
        each device its slice, all launched before any is read; logits
        (N, C) as numpy in input order."""
        parts = []
        for i, a, b in self._shares(len(mv)):
            d = self.mesh[i]
            parts.append(self._forward_u8(
                torch.from_numpy(mv[a:b]).to(d),
                torch.from_numpy(res[a:b]).to(d), replica=i))
        return np.concatenate([p.cpu().numpy() for p in parts])

    def _chunk_ladder(self, chunk_gops):
        """GOP-batch sizes a chunk is padded to: power-of-2 multiples of
        `_gop_quant`, capped at `chunk_gops`, so a ragged tail chunk pads
        at most 2x instead of up to `chunk_gops`."""
        sizes, g = [], self._gop_quant
        while g < chunk_gops:
            sizes.append(g)
            g *= 2
        sizes.append(chunk_gops)
        return sizes

    def _gop_program(self, g, t, h, w, cell, n_pick, replica=0):
        """GOP-batch program for one shape on the device of `replica`:
        tensors from `_pack_rows` (cell MVs, I-frames, cropped picked
        frames, picks) on that device ->
        (logits (g*n_pick, C), mv_u8 (g, n_pick, S, S, 2),
        res_u8 (g, n_pick, S, S, 3)).

        Back-trace, crop, pick by index gather, then the exact integer u8
        encode of the native path (coviar_decode.cpp cv_accumulate_gop_u8;
        reference coviar_data_loader.c:97-124): accumulated MV truncated
        toward zero after scaling by 127.5/20 = 51/8 (exact in float32),
        +128, clipped to [0, 255]; residual frame - warped, +128, clipped."""
        size = self.input_size
        scale = 127.5 / 20.0 if self.mv_minmaxnorm else 0.0
        y0 = max((h - size) // 2, 0)
        x0 = max((w - size) // 2, 0)
        backtrace = self._backtrace

        @torch.inference_mode()
        def fn(cell_mvs, iframes, picked_frames, picks):
            ifr = iframes.permute(0, 3, 1, 2).to(torch.int32).contiguous()
            accu, warped = backtrace(cell_mvs, ifr, h, w, cell)
            accu = accu[..., y0:y0 + size, x0:x0 + size]
            warped = warped[..., y0:y0 + size, x0:x0 + size]
            rows = torch.arange(g, device=picks.device)[:, None]
            acc_p = accu[rows, picks]     # (g, n_pick, 2, hc, wc)
            warp_p = warped[rows, picks]  # (g, n_pick, 3, hc, wc)
            hc, wc = accu.shape[-2], accu.shape[-1]
            ix = x0 + torch.arange(wc, dtype=torch.int32, device=accu.device)
            iy = y0 + torch.arange(hc, dtype=torch.int32,
                                   device=accu.device)[:, None]
            vx = ix - acc_p[:, :, 0]
            vy = iy - acc_p[:, :, 1]
            if scale:
                vx = torch.trunc(vx.float() * scale).to(torch.int32)
                vy = torch.trunc(vy.float() * scale).to(torch.int32)
            mv_u8 = (torch.stack([vx, vy], -1) + 128).clamp_(0, 255) \
                .to(torch.uint8)
            fr_p = picked_frames[:, :, :hc, :wc].to(torch.int32)
            res = fr_p - warp_p.permute(0, 1, 3, 4, 2)
            res_u8 = (res + 128).clamp_(0, 255).to(torch.uint8)
            if hc != size or wc != size:
                pad = (0, 0, 0, size - wc, 0, size - hc)
                mv_u8 = torch.nn.functional.pad(mv_u8, pad)
                res_u8 = torch.nn.functional.pad(res_u8, pad)
            logits = self._forward_u8(
                mv_u8.reshape(g * n_pick, size, size, 2),
                res_u8.reshape(g * n_pick, size, size, 3), replica)
            return logits, mv_u8, res_u8

        return fn

    def _to_device(self, arrays, device=None):
        return [torch.from_numpy(a).to(device or self.device)
                for a in arrays]

    def _launch(self, rows, g, tmax, h, w, cell, n_pick):
        """Enqueue the GOP program of `rows` padded to `g` rows: over the
        mesh, each device its contiguous share of the `g` rows, packed,
        copied and launched before any result is read.  Returns [(logits,
        mv_u8, res_u8)] on the devices, in row order (`gather_outputs`)."""
        out = []
        for i, a, b in self._shares(g):
            fn = self._gop_program(b - a, tmax, h, w, cell, n_pick,
                                   replica=i)
            out.append(fn(*self._to_device(self._pack_rows(
                rows[a:b], b - a, tmax, h, w, cell, n_pick),
                self.mesh[i])))
        return out

    @staticmethod
    def gather_outputs(parts):
        """The host numpy (logits, mv_u8, res_u8) of `_launch`'s per-device
        outputs, concatenated in row order."""
        return tuple(np.concatenate([p[k].cpu().numpy() for p in parts])
                     for k in range(3))

    def warmup(self, geometries=((256, 320),), t=12, cell=16,
               frames_per_gop=3, chunk_gops=64, host_buckets=(16,)):
        """Run every serving shape once before traffic: the kernel build
        and cuDNN's first-call set-up then happen here, not on a request.

        `geometries` are (height, width) or (height, width, t[, cell])
        tuples; the full `_chunk_ladder(chunk_gops)` runs per geometry.
        `host_buckets` runs the host-path classifier at those clip
        counts."""
        quant = self._gop_quant
        top = -(-chunk_gops // quant) * quant
        size = self.input_size
        for geom in geometries:
            h, w = geom[0], geom[1]
            t_g = geom[2] if len(geom) > 2 else t
            cell_g = geom[3] if len(geom) > 3 else cell
            for g in self._chunk_ladder(top):
                for i, a, b in self._shares(g):
                    n = b - a
                    fn = self._gop_program(n, t_g, h, w, cell_g,
                                           frames_per_gop, replica=i)
                    arrays = (
                        np.zeros((n, t_g, h // cell_g, w // cell_g, 2),
                                 np.int32),
                        np.zeros((n, h, w, 3), np.uint8),
                        np.zeros((n, frames_per_gop, size, size, 3),
                                 np.uint8),
                        np.ones((n, frames_per_gop), np.int64))
                    fn(*self._to_device(arrays, self.mesh[i]))
        for n in host_buckets:
            self._forward_u8_mesh(np.zeros((n, size, size, 2), np.uint8),
                                  np.zeros((n, size, size, 3), np.uint8))
        for d in self.mesh:
            if d.type == "cuda":
                torch.cuda.synchronize(d)

    def _center_crop(self, arr):
        size = self.input_size
        h, w = arr.shape[1:3]
        y0 = max((h - size) // 2, 0)
        x0 = max((w - size) // 2, 0)
        out = arr[:, y0:y0 + size, x0:x0 + size]
        if out.shape[1] != size or out.shape[2] != size:
            pad = [(0, 0), (0, size - out.shape[1]), (0, size - out.shape[2]),
                   (0, 0)]
            out = np.pad(out, pad)
        return out

    def _segment_picks(self, reader, segments):
        """Reference TSN test protocol: `segments` segment-centre P-frames
        over the whole video (code/dmcnet/test.py:48 with --test-segments
        25; centre formula dataset.py:139-149) -> {gop_index: (positions,
        weights)}.  Duplicate picks (short videos) are deduped per GOP and
        carried as integer weights so the score is the exact protocol
        average.  Frame->GOP mapping uses the stream's actual GOP
        boundaries."""
        lens = [reader.gop_len(g) for g in range(reader.num_gops)]
        starts = np.concatenate([[0], np.cumsum(lens)])
        # P-frame count (frame 0 of each stream is the first I-frame; the
        # protocol excludes index 0, dataset.py:46-60)
        n = reader.num_frames - 1
        by_gop = {}
        for seg in range(segments):
            idx = int(np.round((n - 1) / segments * (seg + 0.5))) + 1
            g = int(np.searchsorted(starts, idx, side="right")) - 1
            g = min(g, reader.num_gops - 1)
            pos = idx - int(starts[g])
            if pos == 0:  # I-frame position: previous GOP's last P-frame
                g = max(g - 1, 0)
                pos = lens[g] - 1
            pos = min(max(pos, 1), lens[g] - 1) if lens[g] > 1 else 0
            by_gop.setdefault(g, {}).setdefault(pos, [0])[0] += 1
        return {g: (np.asarray(sorted(d), np.int32),
                    np.asarray([d[p][0] for p in sorted(d)], np.float32))
                for g, d in by_gop.items()}

    def predict_video(self, path, frames_per_gop=3, backend="auto",
                      segments=None):
        """Weighted mean of logits over sampled P-frames: `frames_per_gop`
        evenly spaced per GOP (every GOP decoded), or — with `segments=N`
        — the reference TSN protocol's N segment-centre frames
        (`_segment_picks`).

        `backend`: "device" back-traces on the card from MV block lists
        (the host entropy-decodes only); "host" is the native-accumulate
        path; "auto" takes the device path and falls back to the host path
        only when the stream does not qualify (unaligned blocks, |mv|
        beyond `max_mv`, more than 255 frames in a GOP).  An error raised
        by the device program or the kernel propagates."""
        if backend in ("auto", "device"):
            out = self._predict_video_device(path, frames_per_gop,
                                             segments=segments)
            if out is not None:
                return out
            if backend == "device":
                raise ValueError(
                    f"{path}: stream does not qualify for the device "
                    "back-trace path")
        mvs, ress, wts = [], [], []
        reader = shared_reader_cache().get(path)
        by_gop = self._segment_picks(reader, segments) if segments else None
        gops = sorted(by_gop) if segments else range(reader.num_gops)
        for g in gops:
            frames, mv_maps = reader.decode_gop(g)
            if len(frames) < 2:
                continue
            mv, res = gop_mv_residual_u8(
                mv_maps, frames, True, 20 if self.mv_minmaxnorm else None)
            if segments:
                pick, w = by_gop[g]
                pick = np.minimum(pick, len(frames) - 1)
            else:
                pick = np.linspace(1, len(frames) - 1,
                                   min(frames_per_gop, len(frames) - 1))
                pick = np.unique(np.round(pick).astype(int))
                w = np.ones(len(pick), np.float32)
            mvs.append(self._center_crop(mv[pick]))
            ress.append(self._center_crop(res[pick]))
            wts.append(w)
        if not mvs:
            raise ValueError(f"no usable GOPs in {path}")
        lg = self._forward_u8_mesh(np.concatenate(mvs), np.concatenate(ress))
        wts = np.concatenate(wts)
        return (lg * wts[:, None]).sum(axis=0) / wts.sum()

    def _gather_video_device(self, path, frames_per_gop, segments=None):
        """Host side of the device path for one video: entropy decode +
        block-list -> cell-grid conversion.  Returns (cms, gop_data, picks,
        counts, weights, h, w) — gop_data rows are (iframe (H, W, 3),
        cropped picked frames (count, size, size, 3), gop_len), picks rows
        unpadded — or None when any GOP disqualifies (the caller falls back
        to the host path).  Only the I-frame and the cropped picked frames
        are kept."""
        from dmcnet_tpu_torch.ops.backtrace import cell_mv_from_blocks

        cms, gop_data, picks, counts, weights = [], [], [], [], []
        reader = shared_reader_cache().get(path)
        h, w = reader.height, reader.width
        by_gop = self._segment_picks(reader, segments) if segments else None
        gops = sorted(by_gop) if segments else range(reader.num_gops)
        for gidx in gops:
            def picks_for(n):
                if segments:
                    p, w_ = by_gop[gidx]
                    return np.minimum(p, n - 1), w_
                p = np.linspace(1, n - 1, min(frames_per_gop, n - 1))
                p = np.unique(np.round(p).astype(np.int32))
                return p, np.ones(len(p), np.float32)

            # Picks are known from the GOP length before decoding, so the
            # decoder skips the YUV->BGR conversion of every other frame.
            n_exp = reader.gop_len(gidx)
            keep = None
            if n_exp >= 2:
                pick, wt = picks_for(n_exp)
                # a bool mask: an integer array would be read as indices
                keep = np.zeros(n_exp, bool)
                keep[0] = True
                keep[pick] = True
            frames, _, blocks, n_blocks = reader.decode_gop_blocks(
                gidx, skip_dense=True, keep=keep)
            if len(frames) < 2:
                continue
            if len(frames) != n_exp:
                # decode shortfall: the predicted picks are invalid
                frames, _, blocks, n_blocks = reader.decode_gop_blocks(
                    gidx, skip_dense=True)
                pick, wt = picks_for(len(frames))
            cm, cell = cell_mv_from_blocks(blocks, n_blocks, h, w)
            if cm is None:
                return None
            counts.append(len(pick))
            weights.append(wt)
            picks.append(pick)
            cms.append((cm, cell))
            gop_data.append((frames[0], self._center_crop(frames[pick]),
                             frames.shape[0]))
        if not cms:
            return None
        return cms, gop_data, picks, counts, weights, h, w

    def _pack_rows(self, rows, g, tmax, h, w, cell, n_pick):
        """GOP rows `(cm, cell_of_cm, iframe, fp, pick)` -> the four host
        arrays of `_gop_program`, padded to `g` rows: cell MVs
        (g, tmax, H/cell, W/cell, 2) int32 (a 16-grid expands exactly to
        8), I-frames (g, H, W, 3) uint8, cropped picked frames
        (g, n_pick, S, S, 3) uint8, picks (g, n_pick) int64 (edge-padded;
        padded slots re-score a real frame and are dropped by the
        caller)."""
        ncy, ncx = h // cell, w // cell
        size = self.input_size
        cm_b = np.zeros((g, tmax, ncy, ncx, 2), np.int32)
        if_b = np.zeros((g, h, w, 3), np.uint8)
        fp_b = np.zeros((g, n_pick, size, size, 3), np.uint8)
        pk_b = np.ones((g, n_pick), np.int64)
        for i, (cm, c, iframe, fp, pick) in enumerate(rows):
            if c != cell:
                cm = np.repeat(np.repeat(cm, c // cell, axis=1),
                               c // cell, axis=2)
            cm_b[i, :cm.shape[0]] = cm
            if_b[i] = iframe
            fp_b[i, :fp.shape[0]] = fp
            pk_b[i, :len(pick)] = pick
            pk_b[i, len(pick):] = pick[-1]
        if pk_b.min(initial=0) < 0 or pk_b.max(initial=0) >= tmax:
            raise ValueError(f"picks out of range [0, {tmax})")
        return cm_b, if_b, fp_b, pk_b

    def _predict_video_device(self, path, frames_per_gop=3, segments=None):
        """Device-path inference of one video; None when any GOP
        disqualifies (the caller falls back to the host path)."""
        gathered = self._gather_video_device(path, frames_per_gop,
                                             segments=segments)
        if gathered is None:
            return None
        cms, gop_data, picks, counts, weights, h, w = gathered
        cell = min(c for _, c in cms)
        tmax = max(t for _, _, t in gop_data)
        if tmax > 255:
            return None  # same routing as the JAX package (u8 picks there)
        g_pad = -(-len(cms) // self._gop_quant) * self._gop_quant
        n_pick = max(frames_per_gop, max(counts))
        rows = [(cm, c, iframe, fp, pick) for (cm, c), (iframe, fp, _), pick
                in zip(cms, gop_data, picks)]
        logits = self.gather_outputs(self._launch(
            rows, g_pad, tmax, h, w, cell, n_pick))[0]
        logits = logits.reshape(g_pad, n_pick, -1)
        rows = np.concatenate([logits[i, :k] for i, k in enumerate(counts)])
        wts = np.concatenate(weights)
        return (rows * wts[:, None]).sum(axis=0) / wts.sum()

    def predict_videos(self, paths, frames_per_gop=3, backend="auto",
                       chunk_gops=64, host_workers=0, on_error="raise",
                       segments=None):
        """Batched whole-video inference: GOPs of many videos share device
        programs, in `chunk_gops`-GOP chunks per (height, width).

        Dispatch is streamed: each chunk is packed and enqueued as soon as
        enough gathered GOPs accumulate, while later videos are still being
        decoded; the card runs asynchronously and logits are read only
        after every chunk is in flight.  `host_workers` > 1 threads the
        per-video host gather (the native decode runs outside the GIL);
        videos are consumed in submission order, so results are
        deterministic.  `segments=N` scores by the reference TSN protocol.

        `on_error="zero"` keeps a batch alive through unreadable or corrupt
        videos: their score is a zero vector and the failure is reported on
        stderr.  Errors of the device itself (out of memory, a failed
        kernel) still abort.

        Returns score vectors aligned with `paths`; a duplicate path is
        scored once and later positions get a fresh copy.  Under "auto",
        videos that do not qualify for the device path take the host path
        individually."""
        from dmcnet_tpu_torch.ops._build import (
            KernelBuildError,
            KernelLaunchError,
        )

        order = list(paths)
        paths = list(dict.fromkeys(order))
        results = {}
        per_video = {}   # path -> [(logit rows, weight rows), ...]
        pending = {}     # (h, w) -> buffered GOP rows
        in_flight = []   # (logits on device, chunk rows, n_pick)
        chunk_gops = -(-chunk_gops // self._gop_quant) * self._gop_quant
        num_class = self.model.num_class
        device_faults = (MemoryError, torch.OutOfMemoryError,
                         KernelBuildError, KernelLaunchError,
                         getattr(torch, "AcceleratorError", MemoryError))

        def zero_score(p, exc):
            import sys

            print(f"predict_videos: {p} failed ({exc!r}); scoring zeros",
                  file=sys.stderr)
            results[p] = np.zeros(num_class, np.float32)

        def gather_one(p):
            """-> (gathered, None) | (None, exc): the host gather's real
            error is kept for the on_error report."""
            if backend not in ("auto", "device"):
                return None, None
            try:
                return self._gather_video_device(p, frames_per_gop,
                                                 segments=segments), None
            except (OSError, ValueError, IndexError) as exc:
                return None, exc

        def dispatch(hw, chunk):
            """Pack one chunk and enqueue it on the device.  tmax rounds up
            to a multiple of 12 and the cell / pick count are chunk-wide;
            a ragged tail pads only to the next `_chunk_ladder` size."""
            h, w = hw
            g = next(s for s in self._chunk_ladder(chunk_gops)
                     if s >= len(chunk))
            cell = min(c for *_, c, _ in chunk)
            tmax = max(12, -(-max(t for *_, t in chunk) // 12) * 12)
            n_pick = max(frames_per_gop,
                         max(len(pk) for *_, pk, _, _, _ in chunk))
            rows = [(cm, c, iframe, fp, pick)
                    for (_, cm, iframe, fp, pick, _, c, _) in chunk]
            in_flight.append((self._launch(rows, g, tmax, h, w, cell,
                                           n_pick), chunk, n_pick))

        def consume(p, gathered, gather_exc):
            tmax_v = (max(t for _, _, t in gathered[1])
                      if gathered else 0)
            if gathered is None or tmax_v > 255:
                if backend == "device":
                    exc = gather_exc or ValueError(
                        f"{p}: stream does not qualify for the device "
                        "back-trace path")
                    if on_error != "zero":
                        raise exc
                    zero_score(p, exc)
                    return
                try:
                    results[p] = self.predict_video(p, frames_per_gop,
                                                    backend="host",
                                                    segments=segments)
                except device_faults:
                    raise  # device faults abort, whatever on_error says
                except Exception as exc:  # noqa: BLE001 — data errors
                    if on_error != "zero":
                        raise
                    zero_score(p, exc)
                return
            cms, gd, pk, cn, wt, h, w = gathered
            per_video[p] = []
            buf = pending.setdefault((h, w), [])
            for (cm, c), (iframe, fp, t), pick, count, w_ in zip(
                    cms, gd, pk, cn, wt):
                buf.append((p, cm, iframe, fp, pick, w_, c, t))
            while len(buf) >= chunk_gops:
                dispatch((h, w), buf[:chunk_gops])
                del buf[:chunk_gops]

        if host_workers > 1:
            from concurrent.futures import ThreadPoolExecutor

            # pool.map yields in submission order while workers run ahead
            with ThreadPoolExecutor(max_workers=host_workers) as pool:
                for p, (gathered, exc) in zip(paths,
                                              pool.map(gather_one, paths)):
                    consume(p, gathered, exc)
        else:
            for p in paths:
                consume(p, *gather_one(p))
        for hw, buf in pending.items():
            if buf:  # flush the ragged tail chunk of each geometry
                dispatch(hw, buf)
        for parts, chunk, n_pick in in_flight:
            lg = np.concatenate([p[0].cpu().numpy() for p in parts])
            lg = lg.reshape(-1, n_pick, lg.shape[-1])
            for i, (p, *_, pick, w_, c, t) in enumerate(chunk):
                per_video[p].append((lg[i, :len(pick)], w_))
        for p, rows in per_video.items():
            lg = np.concatenate([r for r, _ in rows])
            wt = np.concatenate([w_ for _, w_ in rows])
            results[p] = (lg * wt[:, None]).sum(axis=0) / wt.sum()
        seen = set()
        out = []
        for p in order:
            out.append(np.array(results[p]) if p in seen else results[p])
            seen.add(p)
        return out
