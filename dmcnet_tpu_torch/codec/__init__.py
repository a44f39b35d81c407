"""Compressed-video codec layer of the port (counterpart of
`dmcnet_tpu/codec`).

  * native/, mpeg4  C++ (FFmpeg libav*) demux + decode, once per GOP, into
                    BGR frames and dense per-frame MV maps or block lists
  * semantics       pure-NumPy golden model of the reference's accumulation
                    semantics, for bit-parity tests
  * accumulate      plain PyTorch back-trace and residuals of every frame of
                    a GOP on a device (`ops.backtrace.gop_mv_residual_cuda`
                    runs the back-trace as the B2 kernel)
  * host_accumulate the same on the host (native or numpy), for the loader
  * coviar_compat   the reference `coviar.load` surface
"""

from dmcnet_tpu_torch.codec.semantics import (
    MVBlock,
    rasterize_blocks,
    accumulate_gop_numpy,
    load_like_coviar_numpy,
)
from dmcnet_tpu_torch.codec.accumulate import (
    backtrace_gop,
    accumulated_mv_from_src,
    accumulated_residual_from_src,
    gop_mv_residual,
    load_like_coviar_torch,
)
