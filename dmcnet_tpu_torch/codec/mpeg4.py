"""ctypes bindings for the native MPEG-4 front-end (codec/native).

The port's counterpart of `dmcnet_tpu/codec/mpeg4.py`, with the same
`VideoReader` / `ReaderCache` / `shared_reader_cache` / `encode_mpeg4`
contract over its own copy of the decoder, built as `libcoviar_torch.so`.
`VideoReader` opens a video once and gives per-GOP random access: decoded
BGR frames, dense MV maps or MV block lists, each GOP decoded exactly once.

The library is built with `make` at first use.  When FFmpeg's development
files are missing (`pkg-config` cannot find libavcodec and friends) or the
build fails, `_lib()` raises `NativeCodecUnavailable` naming the cause; it
never loads a library left from an earlier build of other sources.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import os
import subprocess
import threading

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libcoviar_torch.so")
_LOCK_DIR = os.path.join(os.path.dirname(_NATIVE_DIR), os.pardir, "_build")
_FFMPEG_PKGS = ("libavformat", "libavcodec", "libavutil", "libswscale")


class NativeCodecUnavailable(RuntimeError):
    """The native decoder cannot be built or loaded on this machine."""


def _build_native():
    """Run `make` (a no-op when the library is newer than its source) under
    a file lock, so concurrent processes never race on one output."""
    try:
        subprocess.run(["pkg-config", "--exists", *_FFMPEG_PKGS],
                       check=True, capture_output=True)
    except (OSError, subprocess.CalledProcessError) as exc:
        raise NativeCodecUnavailable(
            "FFmpeg development files not found: `pkg-config --exists "
            f"{' '.join(_FFMPEG_PKGS)}` failed ({exc!r}); the native "
            "decoder (codec/native) cannot be built") from exc
    os.makedirs(_LOCK_DIR, exist_ok=True)
    with open(os.path.join(_LOCK_DIR, "coviar_torch.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        proc = subprocess.run(["make", "-C", _NATIVE_DIR],
                              capture_output=True, text=True)
    if proc.returncode != 0:
        raise NativeCodecUnavailable(
            f"building {_LIB_PATH} failed (make exit {proc.returncode}):\n"
            f"{proc.stdout[-2000:]}\n{proc.stderr[-2000:]}")


@functools.lru_cache(maxsize=None)
def _lib():
    _build_native()
    lib = ctypes.CDLL(_LIB_PATH)
    lib.cv_open.restype = ctypes.c_void_p
    lib.cv_open.argtypes = [ctypes.c_char_p]
    lib.cv_close.argtypes = [ctypes.c_void_p]
    lib.cv_error.restype = ctypes.c_char_p
    lib.cv_error.argtypes = [ctypes.c_void_p]
    for fn in ("cv_ok", "cv_width", "cv_height", "cv_num_frames",
               "cv_num_gops", "cv_codec_id"):
        getattr(lib, fn).restype = ctypes.c_int
        getattr(lib, fn).argtypes = [ctypes.c_void_p]
    lib.cv_gop_len.restype = ctypes.c_int
    lib.cv_gop_len.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.cv_decode_gop.restype = ctypes.c_int
    lib.cv_decode_gop.argtypes = [
        ctypes.c_void_p, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int16),
        ctypes.c_int]
    lib.cv_decode_gop_blocks_keep.restype = ctypes.c_int
    lib.cv_decode_gop_blocks_keep.argtypes = [
        ctypes.c_void_p, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int16),
        ctypes.c_int, ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8)]
    lib.cv_cells_from_blocks.restype = ctypes.c_int
    lib.cv_cells_from_blocks.argtypes = [
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int32)]
    lib.cv_accumulate_gop.restype = None
    lib.cv_accumulate_gop.argtypes = [
        ctypes.POINTER(ctypes.c_int16), ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32)]
    lib.cv_accumulate_gop_u8.restype = None
    lib.cv_accumulate_gop_u8.argtypes = [
        ctypes.POINTER(ctypes.c_int16), ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_double, ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_uint8)]
    lib.cv_encode_mpeg4_fmt.restype = ctypes.c_int
    lib.cv_encode_mpeg4_fmt.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int64,
        ctypes.c_char_p]
    lib.cv_encode_named.restype = ctypes.c_int
    lib.cv_encode_named.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int64, ctypes.c_char_p]
    lib.cv_transcode.restype = ctypes.c_int
    lib.cv_transcode.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int64]
    return lib


class VideoReader:
    """One compressed video, demuxed once, GOP-level random access.

    Thread-safe: the native handle is only mutated under `_lock` and all
    state lives in the handle (no process globals, unlike the reference).
    """

    def __init__(self, path, cache_gops=2):
        self._lib = _lib()
        self._handle = self._lib.cv_open(os.fspath(path).encode())
        self._lock = threading.Lock()
        if not self._lib.cv_ok(self._handle):
            err = self._lib.cv_error(self._handle).decode()
            self._lib.cv_close(self._handle)
            self._handle = None
            raise IOError(f"cannot open {path}: {err}")
        self.width = self._lib.cv_width(self._handle)
        self.height = self._lib.cv_height(self._handle)
        self.num_frames = self._lib.cv_num_frames(self._handle)
        self.num_gops = self._lib.cv_num_gops(self._handle)
        # libavcodec AVCodecID of the stream.  Frame (rgb/iframe) decode is
        # codec-generic — any codec libavcodec ships a decoder for works,
        # matching the reference's cv2-based rgb reader
        # (code/dmcnet_I3D/data/video_iterator.py:185-309).  MV/residual
        # semantics are only defined for MPEG-4 part 2 (AV_CODEC_ID_MPEG4
        # == 12), the format the dmcnet pipeline standardises on.
        self.codec_id = self._lib.cv_codec_id(self._handle)
        self.is_mpeg4 = self.codec_id == 12
        self._cache = {}
        self._cache_order = []
        self._cache_gops = cache_gops

    def gop_len(self, gop):
        return self._lib.cv_gop_len(self._handle, gop)

    def _require_mpeg4(self, what):
        if not self.is_mpeg4:
            raise ValueError(
                f"{what} requires an MPEG-4 part 2 stream, but this stream's "
                f"codec id is {self.codec_id} (AV_CODEC_ID_MPEG4 == 12). "
                "H.264 multi-ref/B-frame motion vectors violate the coviar "
                "single-forward-ref accumulate semantics, so decoding them "
                "would silently corrupt mv/residual training data. "
                "Transcode first (dmcnet_tpu.codec.convert / cv_transcode); "
                "rgb/I frame decode is codec-generic and needs no "
                "transcode.")

    def decode_gop(self, gop, with_mv=True):
        """Decode one GOP -> (frames_bgr (T,H,W,3) uint8, mv_maps (T,H,W,2) int16).

        Small LRU keeps recently decoded GOPs (TSN often samples several
        frames from the same GOP).  `with_mv=False` skips the dense MV
        rasterization in native code entirely and returns mv_maps=None —
        the rgb/I modalities never touch motion vectors, and non-MPEG4
        codecs (H.264 originals) have no dmcnet MV semantics to export.

        `with_mv=True` on a non-MPEG4 stream raises: H.264 motion vectors
        (multi-ref, B-frames, quarter-pel) and MJPEG's absence of them both
        violate the coviar single-forward-ref accumulate math, so decoding
        them would feed plausible-looking garbage into training — fail loud
        and point at the transcoder instead.
        """
        if with_mv:
            self._require_mpeg4("motion-vector/residual decode")
        with self._lock:
            hit = self._cache.get((gop, True))
            if hit is None and not with_mv:
                hit = self._cache.get((gop, False))
            if hit is not None:
                # honor the documented contract regardless of cache
                # history: with_mv=False always returns mv_maps=None even
                # when a full-decode entry satisfied the lookup
                return hit if with_mv else (hit[0], None)
        n = self.gop_len(gop)
        if n <= 0:
            raise IndexError(f"gop {gop} out of range (num_gops={self.num_gops})")
        frames = np.zeros((n, self.height, self.width, 3), np.uint8)
        if with_mv:
            mv_maps = np.zeros((n, self.height, self.width, 2), np.int16)
            mv_ptr = mv_maps.ctypes.data_as(ctypes.POINTER(ctypes.c_int16))
        else:
            mv_maps, mv_ptr = None, None
        # cv_decode_gop is thread-safe (fresh codec context per call; the
        # handle's packet index is immutable after open) — no lock here, so
        # loader threads decode different GOPs of one video concurrently.
        got = self._lib.cv_decode_gop(
            self._handle, gop,
            frames.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            mv_ptr, n)
        if got < 0:
            raise IOError(f"decode failed for gop {gop}: "
                          f"{self._lib.cv_error(self._handle).decode()}")
        frames = frames[:got]
        if mv_maps is not None:
            mv_maps = mv_maps[:got]
        with self._lock:
            self._cache[(gop, with_mv)] = (frames, mv_maps)
            self._cache_order.append((gop, with_mv))
            while len(self._cache_order) > self._cache_gops:
                old = self._cache_order.pop(0)
                if old != (gop, with_mv):
                    self._cache.pop(old, None)
        return frames, mv_maps

    def decode_gop_blocks(self, gop, max_blocks=None, skip_dense=False,
                          keep=None):
        """Decode one GOP including raw MV block lists.

        Returns (frames (T,H,W,3) uint8, mv_maps (T,H,W,2) int16 or None,
        blocks (T, max_blocks, 6) int32 [src_x,src_y,dst_x,dst_y,w,h],
        n_blocks (T,) int32) — the input of the GPU back-trace kernel
        (via `ops.backtrace.cell_mv_from_blocks`).
        `skip_dense=True` skips the dense per-pixel MV rasterization in the
        native decoder (returns mv_maps=None): consumers that back-trace on
        the device only need the block lists, and the dense maps are the
        dominant rasterization cost per GOP.

        `keep`: optional iterable of frame indices (or a bool mask) — only
        those frames are converted YUV->BGR (others return zero rows).
        Every frame is still entropy-decoded (P-frame reconstruction is
        sequential) and MV block lists cover every frame, but the sws_scale
        conversion — a material share of per-GOP host time — is skipped
        for frames the caller discards.

        MPEG-4-only like `decode_gop(with_mv=True)` — block lists carry the
        same coviar MV semantics.
        """
        self._require_mpeg4("motion-vector block-list decode")
        n = self.gop_len(gop)
        if n <= 0:
            raise IndexError(f"gop {gop} out of range")
        if max_blocks is None:
            # 4MV mode can emit four 8x8 blocks per macroblock.
            max_blocks = 4 * ((self.height + 15) // 16) * \
                ((self.width + 15) // 16)
        frames = np.zeros((n, self.height, self.width, 3), np.uint8)
        if skip_dense:
            mv_maps, mv_ptr = None, None
        else:
            mv_maps = np.zeros((n, self.height, self.width, 2), np.int16)
            mv_ptr = mv_maps.ctypes.data_as(ctypes.POINTER(ctypes.c_int16))
        blocks = np.zeros((n, max_blocks, 6), np.int32)
        n_blocks = np.zeros((n,), np.int32)
        if keep is None:
            keep_ptr = None
        else:
            # bool array = per-frame mask; integer array/list = frame
            # indices.  The dtype disambiguates — an int 0/1 array would
            # otherwise silently select frames 0 and 1.
            keep_arr = np.asarray(keep)
            if keep_arr.dtype == np.bool_:
                if keep_arr.shape != (n,):
                    raise ValueError(
                        f"keep mask shape {keep_arr.shape} != ({n},)")
            else:
                mask = np.zeros(n, bool)
                mask[np.asarray(keep_arr, np.int64)] = True
                keep_arr = mask
            keep_arr = np.ascontiguousarray(keep_arr, np.uint8)
            keep_ptr = keep_arr.ctypes.data_as(
                ctypes.POINTER(ctypes.c_uint8))
        got = self._lib.cv_decode_gop_blocks_keep(
            self._handle, gop,
            frames.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            mv_ptr, n,
            blocks.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            n_blocks.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            max_blocks, keep_ptr)
        if got < 0:
            raise IOError(f"decode failed for gop {gop}")
        return (frames[:got], None if skip_dense else mv_maps[:got],
                blocks[:got], n_blocks[:got])

    def close(self):
        if self._handle is not None:
            self._lib.cv_close(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class ReaderCache:
    """Bounded LRU of open `VideoReader`s keyed by path.

    The reference opens and frees the file per `load()` call
    (coviar_data_loader.c:235,387) — O(file) work per sampled frame but zero
    retained memory.  A `VideoReader` keeps the demuxed packets resident, so
    caching every video of a 9.5k-video dataset would grow to multi-GB RSS;
    this cap keeps the hot working set open and lets evicted readers free
    their packets (via refcount — a reader still in use by another loader
    thread stays alive until that thread drops it, so eviction is safe).
    """

    def __init__(self, max_readers=32):
        import collections

        self._lock = threading.Lock()
        self._readers = collections.OrderedDict()
        self._opening = {}  # path -> Lock: serialize opens per path so two
        # threads missing concurrently don't both demux the same file
        self._max = max_readers

    def get(self, path):
        with self._lock:
            reader = self._readers.get(path)
            if reader is not None:
                self._readers.move_to_end(path)
                return reader
            open_lock = self._opening.setdefault(path, threading.Lock())
        with open_lock:
            with self._lock:  # double-check: the racing thread may have won
                reader = self._readers.get(path)
                if reader is not None:
                    self._readers.move_to_end(path)
                    return reader
            reader = VideoReader(path)
            with self._lock:
                self._readers[path] = reader
                self._readers.move_to_end(path)
                while len(self._readers) > self._max:
                    self._readers.popitem(last=False)
                self._opening.pop(path, None)
        return reader

    def __len__(self):
        return len(self._readers)

    def request_capacity(self, max_readers):
        """Grow the budget to at least `max_readers` (never shrinks
        implicitly — the budget of a shared cache is the max any consumer
        asked for)."""
        with self._lock:
            if max_readers > self._max:
                self._max = max_readers

    def clear(self):
        with self._lock:
            self._readers.clear()


_SHARED_READERS = None
_SHARED_READERS_LOCK = threading.Lock()


def shared_reader_cache(max_readers=None):
    """The process-wide `ReaderCache`: one budget, one eviction policy.

    Every in-process consumer of `VideoReader`s (both datasets, the coviar
    compat shim, serving) keys into this single LRU, so a process mixing
    access paths never double-opens or double-buffers a file.  Passing
    `max_readers` grows the shared budget to at least that many open
    readers.
    """
    global _SHARED_READERS
    with _SHARED_READERS_LOCK:
        if _SHARED_READERS is None:
            _SHARED_READERS = ReaderCache(max_readers=max_readers or 32)
        elif max_readers is not None:
            _SHARED_READERS.request_capacity(max_readers)
    return _SHARED_READERS


def encode_mpeg4(path, frames_bgr, gop_size=12, bit_rate=640_000,
                 container="avi"):
    """Encode (T, H, W, 3) uint8 BGR frames to an MPEG-4 part-2 file.

    Mirrors the reference dataset prep (`-c:v mpeg4 ... -b:v 640k`,
    code/dmcnet_I3D/dataset/HMDB51/scripts/convert_videos.py:55) without
    needing the ffmpeg CLI; used by tests and synthetic benchmarks.
    `container='m4v'` writes the raw elementary stream (what the reference's
    bitstream-parsing loader consumes).
    """
    frames_bgr = np.ascontiguousarray(frames_bgr, dtype=np.uint8)
    t, h, w, _ = frames_bgr.shape
    rc = _lib().cv_encode_mpeg4_fmt(
        os.fspath(path).encode(),
        frames_bgr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        t, h, w, gop_size, bit_rate, container.encode())
    if rc != 0:
        raise IOError(f"mpeg4 encode failed with code {rc}")


def encode_video(path, frames_bgr, codec="mpeg4", gop_size=12,
                 bit_rate=640_000, container="avi"):
    """Encode (T, H, W, 3) uint8 BGR frames with any named libavcodec
    encoder (e.g. 'mpeg2video', 'mjpeg'), to make clips of other codecs for
    the codec-generic frame decode without the ffmpeg CLI."""
    frames_bgr = np.ascontiguousarray(frames_bgr, dtype=np.uint8)
    t, h, w, _ = frames_bgr.shape
    rc = _lib().cv_encode_named(
        os.fspath(path).encode(), codec.encode(),
        frames_bgr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        t, h, w, gop_size, bit_rate, container.encode())
    if rc != 0:
        raise IOError(f"{codec} encode failed with code {rc}")
