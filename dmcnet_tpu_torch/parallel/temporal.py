"""Time-sharded I3D evaluation: a clip's T axis over the ranks of a process
group (counterpart of `dmcnet_tpu/parallel/temporal.py`, where XLA's
spatial partitioner inserts the halo exchanges).

Each rank holds a contiguous range of frames (`split_frames`: the first
T % n ranks one more).  The per-frame generator needs nothing from the
other ranks.  Every op with a temporal window does: the I3D's modules
take the `TimeShard` (`models.layers.window3d`), and `TimeShard.window`
runs the op so: it takes the op's global output count, gives each rank the
outputs whose first input frame it owns (output j belongs to the owner of
input frame j * stride), works out the global input frames those outputs
read, fetches the ones it does not hold from their owners by point-to-point
sends, pads the ends of the clip as the op pads them (TF-SAME from the
global T), and runs the op with no temporal padding.  A rank whose range is
empty at some depth (T = 24 over 3 ranks holds 1 frame a rank after
`mixed_4f`'s pool, and the (2, 7, 7) VALID average gives 2 outputs) sends
what others need and runs the op on one window of zeros, only for its
output's shape; a range may read frames of several ranks.  The mean over T is a sum all-reduced over the group.  No rank
gathers a whole activation along T: it receives its halos, at most the
window's reach beyond its own frames (`TimeShard.max_halo` counts the most
frames one exchange received).

This is the eval forward (running-statistics BN, dropout off), so no
statistic crosses T.  Sends of CUDA tensors go straight through NCCL; on a
gloo group they are staged through the host.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist
import torch.nn.functional as F

from dmcnet_tpu_torch.models.layers import same_pad_3d
from dmcnet_tpu_torch.parallel.multihost import _through_host, all_reduce


def split_frames(t, n):
    """[(start, stop)] of `n` contiguous ranges over `t` frames, the first
    t % n one frame longer."""
    per, extra = divmod(t, n)
    out, a = [], 0
    for r in range(n):
        b = a + per + (r < extra)
        out.append((a, b))
        a = b
    return out


def output_ranges(ranges, stride, n_out):
    """The output ranges of a window op whose output j belongs to the
    owner of input frame j * stride, clipped to `n_out` outputs."""
    return [(min(-(-a // stride), n_out), min(-(-b // stride), n_out))
            for a, b in ranges]


@dataclasses.dataclass
class Frames:
    """This rank's frames `x` (B, C, t, H, W) of an activation whose T axis
    is split as `ranges` over the group's ranks."""
    x: torch.Tensor
    ranges: list

    @property
    def t(self):
        return self.ranges[-1][1]

    @property
    def shape(self):
        """The whole activation's shape (B, C, T, H, W)."""
        b, c, _, h, w = self.x.shape
        return torch.Size((b, c, self.t, h, w))


class TimeShard:
    """The ranks of `group` (None: every rank) sharing a clip's T axis."""

    def __init__(self, group=None):
        self.group = group
        self.rank = dist.get_rank(group)
        self.size = dist.get_world_size(group)
        self.max_halo = 0   # the most frames one exchange received

    def _peer(self, q):
        return q if self.group is None else \
            dist.get_global_rank(self.group, q)

    def scatter(self, x, t_dim=2):
        """This rank's frames of a whole clip (every rank holds `x`), as
        `Frames` of `split_frames`."""
        ranges = split_frames(x.shape[t_dim], self.size)
        a, b = ranges[self.rank]
        return Frames(x.narrow(t_dim, a, b - a), ranges)

    def exchange(self, fr, need):
        """This rank's frames [lo, hi) of the global T axis (`need[rank]`),
        taken from their owners; `need` holds every rank's (clipped)
        range, so each rank knows what to send."""
        x, me = fr.x, self.rank
        a_me, b_me = fr.ranges[me]
        lo, hi = need[me]
        ops, pieces = [], []
        wire = (lambda t: t.cpu()) if _through_host(x, self.group) else \
            (lambda t: t)
        for q, (a, b) in enumerate(fr.ranges):
            s_lo, s_hi = max(a, lo), min(b, hi)
            if s_lo < s_hi:
                if q == me:
                    pieces.append(x[:, :, s_lo - a_me:s_hi - a_me])
                else:
                    shape = list(x.shape)
                    shape[2] = s_hi - s_lo
                    buf = wire(x.new_empty(shape))
                    ops.append(dist.P2POp(dist.irecv, buf, self._peer(q),
                                          self.group))
                    pieces.append(buf)
            q_lo, q_hi = need[q]
            s_lo, s_hi = max(a_me, q_lo), min(b_me, q_hi)
            if q != me and s_lo < s_hi:
                ops.append(dist.P2POp(
                    dist.isend,
                    wire(x[:, :, s_lo - a_me:s_hi - a_me].contiguous()),
                    self._peer(q), self.group))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        self.max_halo = max(self.max_halo, sum(
            p.shape[2] for p in pieces) - max(0, min(b_me, hi)
                                              - max(a_me, lo)))
        pieces = [p.to(x.device) for p in pieces]
        if not pieces:
            return x[:, :, :0]
        return torch.cat(pieces, dim=2) if len(pieces) > 1 else pieces[0]

    def window(self, fr, kernel, stride, op, same=True, pad_value=0.0):
        """`layers.window3d` on this rank's frames `fr`: `op`, an unpadded
        window of `kernel` and `stride`, on the input frames this rank's
        outputs read, padded with `pad_value` to `SAME` from the global
        shape (or VALID).  A rank with no outputs runs `op` on one window
        of zeros only for the output's shape."""
        b, c, t, h, w = fr.shape
        k, s = kernel[0], stride[0]
        if same:
            pads = same_pad_3d((t, h, w), kernel, stride)
            pad_lo, n_out = pads[4], -(-t // s)
        else:
            pads, pad_lo, n_out = (0,) * 4, 0, (t - k) // s + 1
        outs = output_ranges(fr.ranges, s, n_out)
        need = [(o_lo * s - pad_lo, (o_hi - 1) * s - pad_lo + k)
                if o_hi > o_lo else (0, 0) for o_lo, o_hi in outs]
        x = self.exchange(fr, [(max(lo, 0), min(hi, t)) if hi > lo
                               else (0, 0) for lo, hi in need])
        lo, hi = need[self.rank]
        empty = hi <= lo
        if empty:
            x, lo, hi = fr.x.new_zeros((b, c, k, h, w)), 0, k
        x = F.pad(x, pads[:4] + (max(0, -lo), max(0, hi - t)),
                  value=pad_value)
        y = op(x)
        return Frames(y[:, :, :0] if empty else y, outs)

    def cat(self, frames):
        """`Frames` of equal ranges concatenated on channels."""
        return Frames(torch.cat([f.x for f in frames], dim=1),
                      frames[0].ranges)

    def mean_t(self, fr):
        """The mean over the global T axis of (B, C, T, 1, 1) frames, as
        (B, C): a local sum all-reduced."""
        return all_reduce(fr.x.squeeze(4).squeeze(3).sum(dim=2),
                          self.group) / fr.t


@torch.no_grad()
def time_sharded_forward(model, shard, fr):
    """`model(x, "flow+logit")` of an `I3D` with a generator, in eval mode,
    on this rank's frames `fr` of the [mv, residual] clip: (logits (B, C),
    on every rank; this rank's frames of the generated flow)."""
    model.eval()
    gen = model.generate(fr.x) if fr.x.shape[2] else \
        fr.x.new_zeros(fr.x.shape[:1] + (2,) + fr.x.shape[2:])
    return model.features_to_logits(Frames(gen, fr.ranges), shard), gen
