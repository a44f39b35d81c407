"""I3D clip dataset, batches and their device transform (counterpart of
`dmcnet_tpu/data/video_iter.py`), mirroring the reference VideoIter
(code/dmcnet_I3D/data/video_iterator.py:312-579):

  * temporal sampling by Random/SequentialSampling over the video's frames;
  * per-frame modality assembly (mploader, :91-178): mv = accumulated MV
    (+ optional min-max norm) +128 clipped to uint8; res = accumulated
    residual +128; I = the GOP's I-frame BGR->RGB; rgb = the decoded frame;
    flow = external flow JPEGs; flow+mp4 = [flow(2), mv(2), res(3)];
  * the I3D GOP-position remap: MV and residual at position 0 (the
    I-frame, which has no motion) are read at position 1 (:80-89);
  * fault tolerance: up to `MAX_RETRIES` resampling trials, then the last
    good item (:373-426, :442-454);
  * cached per-video frame-count info files with header validation
    (:479-577).

The host assembles raw uint8 clips (GOP decode and accumulation once per
GOP, cached); crop, flip, normalization and flow blockify run on a device
(`i3d_augment_batch`), whose outputs are the model's NCTHW tensors.

Differences from the JAX package:
  * a fault fixed: the JAX package passes the modality name to
    `get_gop_pos_i3d`, whose MV/residual branch knows "mv" but not "res" or
    "flow+mp4", so its res and flow+mp4 clips read every frame's MV and
    residual at GOP position 0, the I-frame's zeros, and its rgb clips
    repeat each GOP's I-frame.  Here MV and residual are read as the
    reference reads them (position 0 -> 1) and rgb frames at their own
    position (`VideoClipDataset.gop_position`);
  * the retry loop resamples only on the decode errors `CoviarDataset`
    catches (`OSError`, `ValueError`, `IndexError`), so a missing native
    decoder or a bug raises instead of resampling into the backup item;
    `_items_from_list` of `data.iterator_factory` drops a video on the same
    errors only;
  * options no caller sets are constants: 20 retries, HLS jitter (15, 35,
    25); the list shuffle, fixed canvas size and vertical flip are left
    out.
"""

from __future__ import annotations

import json
import os
import threading

import numpy as np
import torch

from dmcnet_tpu_torch import resolve_device
from dmcnet_tpu_torch.codec.mpeg4 import shared_reader_cache
from dmcnet_tpu_torch.data import transforms as T
from dmcnet_tpu_torch.data.dmc_dataset import GopCache
from dmcnet_tpu_torch.data.sampling import SequentialSampling, get_gop_pos_i3d
from dmcnet_tpu_torch.utils.profiling import span
from dmcnet_tpu_torch.utils.staging import PinnedStaging

_CHANNELS = {"rgb": 3, "I": 3, "res": 3, "mv": 2, "flow": 2, "flow+mp4": 7}
# Decode errors a clip is resampled on (those `CoviarDataset` zero-fills).
DECODE_ERRORS = (OSError, ValueError, IndexError)
MAX_RETRIES = 20
HLS_VARS = (15, 35, 25)  # RandomHLS of the rgb/I train pipelines
# The `get_gop_pos_i3d` flavour of the frames each modality reads.
_GOP_FLAVOUR = {"I": "I", "mv": "mv", "res": "residual", "flow": "flow",
                "flow+mp4": "mv"}
# Channels mapped to 256 - x on a mirror: flow_x, and mv_x in flow+mp4.
_NEGATE = {"flow+mp4": (0, 2), "mv": (0,), "flow": (0,)}


class VideoClipDataset:
    """Index-addressable clip dataset: `ds[i]` -> (clip (T, H, W, C) uint8,
    label)."""

    def __init__(self, items, sampler, modality="flow+mp4", accumulate=True,
                 mv_minmaxnorm=False, gop=12, seed=0, cached_info_path=None):
        if modality not in _CHANNELS:
            raise ValueError(f"unknown modality {modality!r}")
        self.items = list(items)
        self.sampler = sampler
        self.modality = modality
        self.accumulate = accumulate
        self.mv_minmaxnorm = mv_minmaxnorm
        self.gop = gop
        self.rng = np.random.default_rng(seed)
        self._readers = shared_reader_cache(32)
        self._gops = GopCache()
        self._sampler_lock = threading.Lock()
        self._backup_item = None
        if cached_info_path:
            self._apply_cached_info(cached_info_path)

    # -- frame-count info cache (reference :479-577) ----------------------

    def _apply_cached_info(self, path):
        key = json.dumps([it.path for it in self.items[:4]])
        if os.path.exists(path):
            with open(path) as f:
                payload = json.load(f)
            if payload.get("check") == key:
                counts = payload["counts"]
                self.items = [it.__class__(it.path, it.label,
                                           counts.get(it.path, it.num_frames),
                                           it.flow_path)
                              for it in self.items]
                return
        counts = {it.path: it.num_frames for it in self.items}
        with open(path, "w") as f:
            json.dump({"check": key, "counts": counts}, f)

    # -- decoding ---------------------------------------------------------

    def __len__(self):
        return len(self.items)

    def _reader(self, path):
        return self._readers.get(path)

    def gop_position(self, frame_idx):
        """(GOP index, position in the GOP) that frame `frame_idx` reads:
        its own for rgb, the I-frame for I, MV and residual at position 0
        moved to 1 for mv, res and flow+mp4."""
        if self.modality == "rgb":
            return divmod(frame_idx, self.gop)
        return get_gop_pos_i3d(frame_idx, _GOP_FLAVOUR[self.modality],
                               self.gop)

    def _frame(self, item, frame_idx):
        """One (H, W, C) uint8 frame in the dataset's modality."""
        gop_index, gop_pos = self.gop_position(frame_idx)
        reader = self._reader(item.path)
        gop_index = max(0, min(gop_index, reader.num_gops - 1))
        bound = 20 if self.mv_minmaxnorm else None
        # rgb/I/flow never touch motion vectors: no MV rasterization or
        # accumulation (also the only mode for non-MPEG-4 originals, as the
        # reference's codec-generic cv2 rgb reader, video_iterator.py:
        # 185-309); 'flow' reads JPEGs and uses the frames for their shape.
        frames_only = self.modality in ("rgb", "I", "flow")
        frames, mv_u8, res_u8 = self._gops.get(
            reader, item.path, gop_index, self.accumulate, bound,
            frames_only=frames_only)
        gop_pos = min(gop_pos, len(frames) - 1)

        def flow_u8():
            if item.flow_path is None:
                return np.full(frames.shape[1:3] + (2,), 128, np.uint8)
            from PIL import Image
            idx = frame_idx + 1
            x = np.array(Image.open(os.path.join(
                item.flow_path, f"flow_x_{idx:05d}.jpg")).convert("L"))
            y = np.array(Image.open(os.path.join(
                item.flow_path, f"flow_y_{idx:05d}.jpg")).convert("L"))
            return np.stack([x, y], axis=-1)

        if self.modality == "rgb":
            return frames[gop_pos][..., ::-1]
        if self.modality == "I":
            return frames[0][..., ::-1]
        if self.modality == "mv":
            return mv_u8[gop_pos]
        if self.modality == "res":
            return res_u8[gop_pos]
        if self.modality == "flow":
            return flow_u8()
        return np.concatenate([flow_u8(), mv_u8[gop_pos], res_u8[gop_pos]],
                              axis=-1)

    def _get_clip(self, index):
        item = self.items[index % len(self.items)]
        range_max = max(item.num_frames, 1)
        # samplers keep RNG/cursor state: serialize the (cheap) draw so
        # loader threads can decode concurrently
        with self._sampler_lock:
            if isinstance(self.sampler, SequentialSampling):
                idxs = self.sampler.sampling(range_max, v_id=index)
            else:
                idxs = self.sampler.sampling(range_max)
        clip = np.stack([self._frame(item, int(i)) for i in idxs])
        return clip, item.label

    def __getitem__(self, index):
        for _ in range(MAX_RETRIES):
            try:
                clip, label = self._get_clip(index)
                self._backup_item = (clip, label)
                return clip, label
            except DECODE_ERRORS:
                with self._sampler_lock:
                    index = int(self.rng.integers(len(self.items)))
        if self._backup_item is not None:
            return self._backup_item
        raise RuntimeError(f"failed to load any clip after {MAX_RETRIES} "
                           "retries")


class I3DBatchAssembler:
    """Collate clips into uint8 canvases + crop specs.

    Train: RandomCrop(input_size) + coin-flip mirror (reference
    iterator_factory.py:49-56), with RandomScale + RandomHLS for rgb/I
    (:38-46); eval: CenterCrop(input_size), no rescale (:75-79).
    """

    def __init__(self, dataset, input_size=224, is_train=True, seed=0):
        self.ds = dataset
        self.input_size = input_size
        self.is_train = is_train
        self.rng = np.random.default_rng(seed + 7)
        self._rng_lock = threading.Lock()
        # the scale folds into the crop spec; the HLS jitter runs on the
        # host per frame
        self.rgb_aug = dataset.modality in ("rgb", "I") and is_train

    def batch(self, indices):
        # numpy Generators are not thread-safe: each call works from a child
        # generator forked under the lock
        with self._rng_lock:
            rng = np.random.default_rng(self.rng.integers(2 ** 63))
        clips, labels = zip(*(self.ds[i] for i in indices))
        sizes = [c.shape[1:3] for c in clips]
        hp = max(max(s[0] for s in sizes), self.input_size)
        wp = max(max(s[1] for s in sizes), self.input_size)
        ch = clips[0].shape[-1]
        frames = np.zeros((len(clips), clips[0].shape[0], hp, wp, ch),
                          np.uint8)
        scales, trans, flips = [], [], []
        cs = self.input_size
        for i, (clip, (h, w)) in enumerate(zip(clips, sizes)):
            if self.rgb_aug:
                from dmcnet_tpu_torch.data.color import random_hls
                clip = np.stack([random_hls(f, rng, HLS_VARS)
                                 for f in clip])
            frames[i, :, :h, :w] = clip
            crop_h = crop_w = cs
            if self.is_train:
                if self.rgb_aug:
                    # RandomScale(slen 224..288, aspect 0.8..1.25) as a
                    # larger/smaller source crop resized to input_size
                    hi = max(float(cs), min(cs * 288 / 224, min(h, w)))
                    slen = rng.uniform(cs, hi)
                    aspect = rng.uniform(0.8, 1.25)
                    crop_h = int(min(h, slen))
                    crop_w = int(min(w, slen * aspect))
                oh = int(rng.integers(0, max(h - crop_h, 0) + 1))
                ow = int(rng.integers(0, max(w - crop_w, 0) + 1))
                flip = bool(rng.random() < 0.5)
            else:
                oh, ow = max((h - cs) // 2, 0), max((w - cs) // 2, 0)
                flip = False
            sh, sw, th, tw = T.crop_spec_to_scale_translate(
                oh, ow, crop_h, crop_w, cs)
            scales.append((sh, sw))
            trans.append((th, tw))
            flips.append(flip)
        return {
            "frames": frames,
            "scales": np.asarray(scales, np.float32),
            "translations": np.asarray(trans, np.float32),
            "flips": np.asarray(flips, bool),
            "label": np.asarray(labels, np.int32),
        }


# Module state, since `i3d_augment_batch` is a function its callers share;
# the lock and the event make the reuse safe across calls and threads.
_STAGING = PinnedStaging()


def i3d_augment_batch(batch, modality="flow+mp4", ds_factor=0,
                      input_size=224, mean=0.5, std=0.5, device=None):
    """Crop/flip, /255 and (x - mean) / std on ALL channels (the intended
    semantics of the reference Normalize; its 3-channel zip is quirk (c) of
    SURVEY.md §2.5), flow blockify for flow+mp4, on `device` (CUDA unless
    the caller passes "cpu").

    Returns dict(mv, residual, flow, label) for flow+mp4, else dict(x,
    label): (B, C, T, input_size, input_size) float32 and (B,) int64.
    Only the box of pixels the batch's crops read (`transforms.crop_box`,
    from the numpy specs) leaves the host, through a reused buffer
    (`PinnedStaging`, pinned on a card) on every device.  The copy runs
    inside the `data.i3d_h2d` span (`utils.profiling.span`), which counts
    the u8 `bytes` of the box, the u8 bytes of the crops the model reads
    (`kept`), and `pinned` (1 when staged through the pinned buffer)."""
    dev = resolve_device(device)
    b, t, h, w, c = batch["frames"].shape
    y0, y1, x0, x1 = T.crop_box(batch["scales"], batch["translations"],
                                input_size, h, w)
    box = batch["frames"][:, :, y0:y1, x0:x1]
    with _STAGING.take(dev) as slot, span(
            "data.i3d_h2d", bytes=box.nbytes,
            kept=b * t * input_size * input_size * c,
            pinned=int(slot.pinned)):
        frames = slot.to_device(box)
    frames = frames.permute(0, 1, 4, 2, 3).float()  # (B, T, C, H, W)
    out = T.apply_crops(frames, batch["scales"], batch["translations"],
                        batch["flips"], out_size=input_size,
                        negate_channels=_NEGATE.get(modality, ()),
                        box=(y0, x0, h, w))
    x = (out / 255.0 - mean) / std
    label = torch.as_tensor(batch["label"], dtype=torch.long, device=dev)

    def ncthw(v):
        return v.permute(0, 2, 1, 3, 4).contiguous()

    if modality != "flow+mp4":
        return {"x": ncthw(x), "label": label}
    flow = x[:, :, 0:2]
    if ds_factor:
        flow = T.blockify_flow(flow, ds_factor)
    return {"flow": ncthw(flow), "mv": ncthw(x[:, :, 2:4]),
            "residual": ncthw(x[:, :, 4:7]), "label": label}
