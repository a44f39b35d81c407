"""Reused host buffers through which the port sends bytes to a card.

`PinnedStaging` keeps, for each device, `slots` grow-only u8 host buffers,
pinned for a card, taken in turn.  The CUDA event recorded behind the
copies last queued from a buffer guards it: a refill waits only for those
copies, never for the compute they feed.  I3D evaluation sends a clip's
crop box through one buffer a device (`data.video_iter._STAGING`, via
`to_device`, on the CPU as on a card); serving fills GOP chunks in two
(`serving.DMCPredictor`, via `take`), so that a third chunk in flight does
not wait behind the first one's compute."""

from __future__ import annotations

import collections
import contextlib
import threading

import torch


class Slot:
    """One grow-only u8 host buffer of `PinnedStaging`, pinned for a card,
    and the event recorded behind the copies last queued from it."""

    def __init__(self, device):
        self.device, self.buf, self.done = device, None, None
        self.pinned = device.type == "cuda"

    def busy(self):
        """True while the copies last queued from the buffer still run."""
        return self.done is not None and not self.done.query()

    def buffer(self, nbytes):
        """The u8 buffer, `nbytes` long at least, once the copies last
        queued from it have completed."""
        if self.done is not None:
            self.done.synchronize()
        if self.buf is None or self.buf.numel() < nbytes:
            self.buf = torch.empty(nbytes, dtype=torch.uint8,
                                   pin_memory=self.pinned)
        return self.buf

    def to_device(self, array):
        """`PinnedStaging.to_device` through this buffer."""
        host = self.buffer(array.nbytes)[:array.nbytes].view(array.shape)
        host.copy_(torch.from_numpy(array))
        out = torch.empty(array.shape, dtype=torch.uint8, device=self.device)
        out.copy_(host, non_blocking=True)
        self.sent()
        return out

    def sent(self):
        """Record the event behind the copies just queued from the buffer
        on the device's current stream (nothing off a card, whose copies
        have completed on return)."""
        if self.pinned:
            if self.done is None:
                self.done = torch.cuda.Event()
            self.done.record(torch.cuda.current_stream(self.device))


class PinnedStaging:
    """For each device `slots` grow-only host buffers, sized in bytes,
    taken in turn under a lock, pinned for a card."""

    def __init__(self, slots=1):
        self.slots = slots
        self._lock = threading.Lock()
        self._slots = {}   # device -> deque of Slot, the next one first

    @contextlib.contextmanager
    def take(self, device):
        """The next `Slot` of `device`, held by the caller until the block
        ends: fill `slot.buffer(nbytes)`, queue its copies, `slot.sent()`."""
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        with self._lock:
            ring = self._slots.get(device)
            if ring is None:
                ring = self._slots[device] = collections.deque(
                    Slot(device) for _ in range(self.slots))
            slot = ring[0]
            ring.rotate(-1)
            yield slot

    def to_device(self, array, device):
        """The numpy u8 `array` (any strides) as a fresh contiguous tensor
        on `device`: written into the next buffer, then copied
        `non_blocking` on the device's current stream (the copy `_stage` of
        `serving.DMCPredictor` makes too).  On the CPU the buffer is
        unpinned and the tensor a copy of it."""
        with self.take(device) as slot:
            return slot.to_device(array)
