"""Drop-in replacement for the reference `coviar` CPython module (the port's
counterpart of `dmcnet_tpu/codec/coviar_compat.py`).

Same call surface as coviar_data_loader.c:578-583 —

    load(path, gop_index, gop_pos, representation, accumulate) -> np.ndarray
    get_num_frames(path) -> int
    get_num_gops(path) -> int

with representation 0=iframe, 1=mv, 2=residual, and the same return shapes
and dtypes (iframe (H,W,3) uint8 BGR; mv (H,W,2) int32; residual (H,W,3)
int32).  Backed by the native GOP reader through the process-wide reader
cache, so repeated loads touch the file once per GOP instead of re-decoding
the file per call, and by `codec.accumulate.gop_mv_residual` on a device:
`load` takes a keyword-only `device` (CUDA unless the caller passes "cpu").
"""

from __future__ import annotations

from dmcnet_tpu_torch.codec.accumulate import gop_mv_residual
from dmcnet_tpu_torch.codec.mpeg4 import shared_reader_cache

IFRAME, MV, RESIDUAL = 0, 1, 2


def _reader(path):
    # The reader cache shared with the datasets and serving: one budget, one
    # eviction policy, no file opened twice.
    return shared_reader_cache().get(path)


def get_num_frames(path):
    return _reader(path).num_frames


def get_num_gops(path):
    return _reader(path).num_gops


def load(path, gop_index, gop_pos, representation, accumulate, *,
         device=None):
    reader = _reader(path)
    frames, mv_maps = reader.decode_gop(gop_index)
    if gop_pos >= len(frames):
        gop_pos = len(frames) - 1
    if representation == IFRAME:
        return frames[gop_pos].copy()
    mv, res = gop_mv_residual(mv_maps, frames, accumulate=bool(accumulate),
                              device=device)
    out = mv[gop_pos] if representation == MV else res[gop_pos]
    return out.cpu().numpy()
