"""CoViAR dataset for the dmcnet variants (counterpart of
`dmcnet_tpu/data/dmc_dataset.py`), mirroring `CoviarDataSet` (reference
code/dmcnet/dataset.py:76-281) with the work split between host and device:

  host (this module): list parsing, TSN frame sampling, GOP decode through
    the native front-end (once per GOP, cached), host accumulation, MV
    min-max norm and +128 uint8 encoding, flow-JPEG reads, batching into
    fixed-size uint8 canvases, crop-spec sampling;
  device (data.transforms): crop + resize + flip, /255, normalization and
    flow blockify, on the device the caller names (`augment_*_batch`).

Faithful semantics: group channel layout [flow(2), mv(2), residual(3)]
(dataset.py:215, 224-227), train-time random video choice per item
(dataset.py:162), a random frame per TSN segment, test-time segment
centres, mv_minmaxnorm int32 truncation (GAN dataset.py:41-42), +128 clip
to uint8 (dataset.py:195-213).  Host arrays keep the JAX package's (S, H,
W, C) layout; the device outputs are (B, S, C, H, W).

Deliberate divergences from the reference, as in the JAX package:
  * representation 'iframe'/'residual' use the intended channel layout
    instead of the reference's accidental double-residual stacking;
  * mirror negation applies to flow_x/mv_x only (never iframe colors).
"""

from __future__ import annotations

import itertools
import os
import threading
from typing import Optional

import numpy as np
import torch

from dmcnet_tpu_torch import resolve_device
from dmcnet_tpu_torch.codec.host_accumulate import (
    gop_mv_residual_numpy,
    gop_mv_residual_u8,
)
from dmcnet_tpu_torch.codec.mpeg4 import (
    NativeCodecUnavailable,
    shared_reader_cache,
)
from dmcnet_tpu_torch.data import transforms as T
from dmcnet_tpu_torch.data.lists import load_video_list
from dmcnet_tpu_torch.data.sampling import test_frame_index, train_frame_index
from dmcnet_tpu_torch.utils.profiling import span


def _encode_u8(arr, minmax_bound=None):
    """int32 -> uint8 via optional min-max scale, +128 shift, clip
    (dataset.py:195-202; GAN int32 truncation dataset.py:41-42)."""
    arr = np.asarray(arr)
    if minmax_bound is not None:
        arr = (arr.astype(np.float64) * (127.5 / minmax_bound)).astype(np.int32)
    return np.clip(arr + 128, 0, 255).astype(np.uint8)


class GopCache:
    """Per-video accumulated-GOP cache: decode + accumulate + uint8-encode
    once per GOP, entirely in native code (GIL-free in loader threads).

    Byte-budgeted LRU: entries are evicted oldest-first once the cached
    arrays exceed `max_bytes` (default 128 MB), so host RSS stays bounded at
    dataset scale (the reference retains nothing — it re-decodes per call,
    coviar_data_loader.c:235)."""

    def __init__(self, max_bytes=128 << 20):
        import collections

        self._items = collections.OrderedDict()
        self._max_bytes = max_bytes
        self._bytes = 0
        self._lock = threading.Lock()
        self._decoding = {}  # key -> Lock: serialize same-GOP misses

    @property
    def nbytes(self):
        return self._bytes

    def get(self, reader, path, gop, accumulate, minmax_bound=None,
            frames_only=False):
        """`frames_only=True` skips MV rasterization + accumulation entirely
        (rgb/I modalities; also the only valid mode for non-MPEG4 inputs)
        and returns (frames, empty, empty)."""
        key = (path, gop, accumulate, minmax_bound, frames_only)
        with self._lock:
            if key in self._items:
                self._items.move_to_end(key)
                return self._items[key]
            # Loader threads missing on the SAME GOP would each redo the
            # full native decode (the dominant host cost); serialize per
            # key so one thread decodes and the rest pick up the entry.
            gate = self._decoding.setdefault(key, threading.Lock())
        try:
            with gate:
                with self._lock:
                    if key in self._items:
                        self._items.move_to_end(key)
                        return self._items[key]
                value = self._decode(reader, gop, accumulate, minmax_bound,
                                     frames_only)
            with self._lock:
                self._insert(key, value)
            return value
        finally:
            # Drop the gate — a failed decode (corrupt video) must not
            # leave a stale Lock serializing every later attempt — but only
            # OUR gate: a waiter waking after the owner already popped it
            # must not remove a successor thread's fresh gate (that would
            # re-open the duplicate-decode window).
            with self._lock:
                if self._decoding.get(key) is gate:
                    del self._decoding[key]

    def _decode(self, reader, gop, accumulate, minmax_bound,
                frames_only=False):
        if frames_only:
            frames, _ = reader.decode_gop(gop, with_mv=False)
            empty = np.empty((0,), np.uint8)
            return (frames, empty, empty)
        frames, mv_maps = reader.decode_gop(gop)
        try:
            mv_u8, res_u8 = gop_mv_residual_u8(mv_maps, frames, accumulate,
                                               minmax_bound)
        except NativeCodecUnavailable:
            mv, res = gop_mv_residual_numpy(mv_maps, frames, accumulate)
            mv_u8 = _encode_u8(mv, minmax_bound)
            res_u8 = _encode_u8(res)
        return (frames, mv_u8, res_u8)

    def _insert(self, key, value):
        """Caller holds self._lock."""
        frames, mv_u8, res_u8 = value
        if key not in self._items:
            self._items[key] = value
            self._bytes += frames.nbytes + mv_u8.nbytes + res_u8.nbytes
        self._items.move_to_end(key)
        while self._bytes > self._max_bytes and len(self._items) > 1:
            _, (f, m, r) = self._items.popitem(last=False)
            self._bytes -= f.nbytes + m.nbytes + r.nbytes


class CoviarDataset:
    """Index-addressable dataset yielding raw group stacks.

    `__getitem__` -> (frames (S, H, W, 7) uint8, label, (H, W)).
    """

    def __init__(self, data_root, flow_root, video_list, representation,
                 num_segments=3, is_train=True, accumulate=True, gop=12,
                 flow_ds_factor=0, upsample_interp=False, mv_minmaxnorm=0,
                 flow_folder="tvl1", new_length=1, seed=0,
                 items=None, gop_cache_mb=128, reader_cache=32):
        self.representation = representation
        self.num_segments = num_segments
        self.is_train = is_train
        self.accumulate = accumulate
        self.gop = gop
        self.flow_ds_factor = flow_ds_factor
        self.upsample_interp = upsample_interp
        self.mv_minmaxnorm = mv_minmaxnorm
        self.new_length = new_length
        self.flow_tmpl = ("flow_{0}_{1:05d}.jpg" if flow_folder == "tvl1"
                          else "flow_{0}_{1:05d}.png")
        # numpy Generators are not thread-safe; loader threads derive a
        # fresh per-item generator from (seed, draw counter).
        self._seed = seed
        self._draws = itertools.count()
        self._draw_lock = threading.Lock()
        self.items = items if items is not None else load_video_list(
            video_list, data_root, flow_root)
        # Budgets are host-dependent (a 9.5k-video UCF-101 run wants more
        # than the defaults) — exposed as --gop-cache-mb / --reader-cache.
        # Shared process-wide cache: one budget across datasets +
        # compat shim + serving (grows to the largest request).
        self._readers = shared_reader_cache(reader_cache)
        self._gops = GopCache(max_bytes=int(gop_cache_mb) << 20)
        self._failed = set()  # paths already warned about (log once)

    def __len__(self):
        return len(self.items)

    def _reader(self, path):
        return self._readers.get(path)

    def _read_flow(self, item, frame_idx):
        """Load the (H, W, 2) uint8 precomputed flow pair (dataset.py:182-184)."""
        from PIL import Image
        tmpl = self.flow_tmpl
        x = np.array(Image.open(
            os.path.join(item.flow_path, tmpl.format("x", frame_idx)))
            .convert("L"))
        y = np.array(Image.open(
            os.path.join(item.flow_path, tmpl.format("y", frame_idx)))
            .convert("L"))
        return np.stack([x, y], axis=-1)

    def _segment_frame(self, item, gop_index, gop_pos):
        """Build one (H, W, 7) uint8 group frame.

        Decode failures (unreadable/corrupt video) zero-fill instead of
        aborting the epoch, matching the reference's
        `if mv is None: ... np.zeros(...)` tolerance
        (code/dmcnet/dataset.py:191-193); logged once per video.
        """
        bound = 20 if self.mv_minmaxnorm == 1 else None
        try:
            reader = self._reader(item.path)
            gop_index = max(0, min(gop_index, reader.num_gops - 1))
            frames, mv_u8, res_u8 = self._gops.get(
                reader, item.path, gop_index, self.accumulate, bound)
        except (OSError, ValueError, IndexError) as exc:
            if item.path not in self._failed:
                self._failed.add(item.path)
                print(f"Error: loading video {item.path} failed "
                      f"({exc}); zero-filling.")
            h, w = 256, 256  # reference fallback shape (dataset.py:193)
            frames = np.zeros((1, h, w, 3), np.uint8)
            mv_u8 = np.full((1, h, w, 2), 128, np.uint8)
            res_u8 = np.full((1, h, w, 3), 128, np.uint8)
            gop_index, gop_pos = 0, 0
            # flow jpgs may exist at the video's true resolution, which
            # would no longer match the fallback planes — the sample is
            # synthetic anyway, so neutral-fill the flow too.
            flow = np.full((h, w, 2), 128, np.uint8)
            mid = mv_u8[0] if self.representation != "iframe" \
                else frames[0][..., ::-1]
            return np.concatenate([flow, mid, res_u8[0]], axis=-1)
        gop_pos = min(gop_pos, len(frames) - 1)

        flow_idx = gop_index * self.gop + gop_pos + 1  # 1-based jpgs
        if item.flow_path is not None:
            try:
                flow = self._read_flow(item, flow_idx)
            except OSError:
                if (item.path, "flow") not in self._failed:
                    self._failed.add((item.path, "flow"))
                    print(f"Error: loading flow {item.flow_path} failed.")
                flow = np.full(frames.shape[1:3] + (2,), 128, np.uint8)
        else:
            flow = np.full(frames.shape[1:3] + (2,), 128, np.uint8)

        if self.representation == "iframe":
            iframe = frames[0]
            if self.is_train:
                from dmcnet_tpu_torch.data.color import color_aug
                with self._draw_lock:
                    aug_rng = np.random.default_rng(
                        (self._seed, next(self._draws)))
                iframe = color_aug(iframe, aug_rng)  # dataset.py:204-205
            mid = iframe[..., ::-1]  # BGR -> RGB (dataset.py:207-208)
        else:
            mid = mv_u8[gop_pos]
        residual = res_u8[gop_pos]
        return np.concatenate([flow, mid, residual], axis=-1)

    def __getitem__(self, index):
        with self._draw_lock:
            draw = next(self._draws)
        rng = np.random.default_rng((self._seed, draw))
        if self.is_train:
            item = self.items[int(rng.integers(len(self.items)))]
        else:
            item = self.items[index]
        segs = []
        for seg in range(self.num_segments):
            if self.is_train:
                gop_index, gop_pos = train_frame_index(
                    item.num_frames, self.num_segments, seg,
                    self.representation, rng, self.gop)
            else:
                gop_index, gop_pos = test_frame_index(
                    item.num_frames, self.num_segments, seg,
                    self.representation, self.gop)
            segs.append(self._segment_frame(item, gop_index, gop_pos))
        frames = np.stack(segs)
        return frames, item.label, frames.shape[1:3]


class BatchAssembler:
    """Collates dataset items into device-ready uint8 canvases + crop specs.

    Train: one MultiScaleCrop spec + coin-flip mirror per sample
    (model.get_augmentation, reference model.py:369-378).
    Eval: 1-crop (GroupScale+CenterCrop) or 10-crop (GroupOverSample)
    (reference test.py:89-99).
    """

    def __init__(self, dataset, input_size=224, scale_size=256,
                 test_crops=1, pad_hw: Optional[tuple] = None, seed=0):
        self.ds = dataset
        self.input_size = input_size
        self.scale_size = scale_size
        self.test_crops = test_crops
        self.pad_hw = pad_hw
        self._seed = seed + 1
        self._draws = itertools.count()
        self._draw_lock = threading.Lock()
        rep = dataset.representation
        self.scales = (1, .875, .75) if rep in ("mv", "residual", "flow") \
            else (1, .875, .75, .66)
        self.negate_channels = (0, 2) if rep != "iframe" else (0,)

    def _pad(self, stacks, sizes):
        hp = self.pad_hw[0] if self.pad_hw else max(s[0] for s in sizes)
        wp = self.pad_hw[1] if self.pad_hw else max(s[1] for s in sizes)
        # channel count follows the representation: 7 for mv/residual
        # (flow2 + mv2 + residual3), 8 for iframe (flow2 + RGB3 +
        # residual3 — the reference's 7-channel split is the broken
        # stacking documented as PARITY divergence #4; we keep the
        # intended per-modality layout)
        out = np.zeros((len(stacks),) + stacks[0].shape[:1]
                       + (hp, wp, stacks[0].shape[-1]), np.uint8)
        for i, st in enumerate(stacks):
            out[i, :, :st.shape[1], :st.shape[2]] = st
        return out

    def train_batch(self, indices):
        with self._draw_lock:
            draw = next(self._draws)
        rng = np.random.default_rng((self._seed, draw))
        stacks, labels, sizes = zip(*(self.ds[i] for i in indices))
        frames = self._pad(stacks, sizes)
        scales, trans, flips = [], [], []
        for (h, w) in sizes:
            oh, ow, ch, cw = T.sample_multiscale_crop(
                rng, h, w, self.input_size, self.scales)
            sh, sw, th, tw = T.crop_spec_to_scale_translate(
                oh, ow, ch, cw, self.input_size)
            scales.append((sh, sw))
            trans.append((th, tw))
            flips.append(rng.random() < 0.5)
        return {
            "frames": frames,
            "scales": np.asarray(scales, np.float32),
            "translations": np.asarray(trans, np.float32),
            "flips": np.asarray(flips, bool),
            "label": np.asarray(labels, np.int32),
        }

    def eval_batch(self, indices):
        stacks, labels, sizes = zip(*(self.ds[i] for i in indices))
        frames = self._pad(stacks, sizes)
        scales, trans, flips = [], [], []
        for (h, w) in sizes:
            if self.test_crops == 1:
                sh, sw, th, tw = T.center_crop_spec(
                    h, w, self.scale_size, self.input_size)
                scales.append([(sh, sw)])
                trans.append([(th, tw)])
                flips.append([False])
            else:
                specs = T.oversample_specs(h, w, self.scale_size,
                                           self.input_size)
                scales.append([(s[0], s[1]) for s in specs])
                trans.append([(s[2], s[3]) for s in specs])
                flips.append([s[4] for s in specs])
        return {
            "frames": frames,
            "scales": np.asarray(scales, np.float32),      # (B, crops, 2)
            "translations": np.asarray(trans, np.float32),  # (B, crops, 2)
            "flips": np.asarray(flips, bool),               # (B, crops)
            "label": np.asarray(labels, np.int32),
        }


def _device_frames(frames_u8, device, copy_span=None):
    """(B, S, H, W, C) uint8 host canvas -> (B, S, C, H, W) float32 on
    `device` (the uint8 bytes cross to the device, not the floats).  With
    `copy_span`, the copy runs inside that `utils.profiling.span`, which
    counts its `bytes`."""
    x = torch.from_numpy(np.ascontiguousarray(frames_u8))
    if copy_span is None:
        x = x.to(device)
    else:
        with span(copy_span, bytes=x.nbytes):
            x = x.to(device)
    return x.permute(0, 1, 4, 2, 3).contiguous().float()


def augment_train_batch(batch, representation, flow_ds_factor=0,
                        upsample_interp=False, input_size=224,
                        negate_channels=(0, 2), device=None):
    """Crop/flip + normalize a collated train batch on `device` (CUDA unless
    the caller passes "cpu").

    Returns dict(mv, residual, flow) of (B, S, c, input_size, input_size)
    float32 and label (B,) int64, ready for the train step."""
    dev = resolve_device(device)
    frames = _device_frames(batch["frames"], dev)
    out = T.apply_crops(frames, batch["scales"], batch["translations"],
                        batch["flips"], out_size=input_size,
                        negate_channels=negate_channels)
    parts = T.normalize_group(out, representation, flow_ds_factor,
                              upsample_interp)
    parts["label"] = torch.as_tensor(batch["label"], dtype=torch.long,
                                     device=dev)
    return parts


def augment_eval_batch(batch, representation, flow_ds_factor=0,
                       upsample_interp=False, input_size=224,
                       negate_channels=(0, 2), device=None):
    """Apply every crop on `device` and fold the crops into the segment axis
    like the reference ((num_crops * num_segments) consensus, test.py:146):
    outputs are (B, crops * S, c, input_size, input_size).  The canvas's
    copy to `device` is the span `data.eval_h2d` (its `bytes`)."""
    dev = resolve_device(device)
    frames = _device_frames(batch["frames"], dev, "data.eval_h2d")
    b, s = frames.shape[:2]
    n_crops = batch["scales"].shape[1]
    crops = torch.stack([
        T.apply_crops(frames, batch["scales"][:, c],
                      batch["translations"][:, c], batch["flips"][:, c],
                      out_size=input_size, negate_channels=negate_channels)
        for c in range(n_crops)], dim=1)
    crops = crops.reshape((b, n_crops * s) + tuple(crops.shape[3:]))
    parts = T.normalize_group(crops, representation, flow_ds_factor,
                              upsample_interp)
    parts["label"] = torch.as_tensor(batch["label"], dtype=torch.long,
                                     device=dev)
    return parts
