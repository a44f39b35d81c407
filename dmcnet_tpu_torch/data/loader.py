"""Threaded prefetching batch loader (the port's copy of
`dmcnet_tpu/data/loader.py`).

Replaces torch DataLoader worker processes (reference train.py:71-90,
`--workers 8`): a thread pool assembles host batches (decode, accumulation
and crop-spec sampling run in native code or numpy, mostly outside the
interpreter lock) while the device steps, with a bounded prefetch queue for
double buffering.
"""

from __future__ import annotations

import queue
import threading


def pad_indices(start, stop, batch_size):
    """Eval-batch indices [start, stop) padded to `batch_size` by repeating
    the last index (fixed batch shapes; callers mask or slice the padded
    rows).  Returns (indices, n_valid)."""
    idx = list(range(start, stop))
    if not idx:
        raise ValueError(f"empty index range [{start}, {stop})")
    n_valid = len(idx)
    idx += [idx[-1]] * (batch_size - n_valid)
    return idx, n_valid


class PrefetchLoader:
    """Iterate batches produced by `make_batch(batch_index)` with
    `num_batches` batches per epoch, prefetched by `workers` threads.

    ORDERING: `ordered=True` (the default) yields batches in INDEX order —
    workers still assemble ahead in parallel, and completed out-of-turn
    batches wait in a small reorder buffer until their turn.  Per-step
    logs/metrics are then reproducible across ANY `--workers` value (torch
    DataLoader gives the same guarantee), at the cost of a head-of-line
    stall when one batch decodes unusually slowly.

    `ordered=False` yields in COMPLETION order: a slow decode lets later
    indices overtake it, maximizing device feed at the price of
    order-reproducibility.  Every batch is yielded exactly once either
    way.  Anything strictly order-sensitive beyond logging (eval score
    dumps, golden traces) still iterates the dataset directly, as the
    eval loops in cli/train.py do."""

    def __init__(self, make_batch, num_batches, workers=4, prefetch=8,
                 ordered=True):
        self.make_batch = make_batch
        self.num_batches = num_batches
        self.workers = max(1, workers)
        self.prefetch = prefetch
        self.ordered = ordered

    def __len__(self):
        return self.num_batches

    def __iter__(self):
        tickets = queue.Queue()
        for i in range(self.num_batches):
            tickets.put(i)
        out = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def worker():
            while not stop.is_set():
                try:
                    i = tickets.get_nowait()
                except queue.Empty:
                    return
                try:
                    out.put((i, self.make_batch(i)))
                except Exception as exc:  # surface in consumer
                    out.put((i, exc))

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(self.workers)]
        for t in threads:
            t.start()
        # reorder buffer: bounded by construction — at most `workers`
        # batches can be in flight past the next-needed index, and the
        # bounded `out` queue already caps total buffered batches
        pending = {}
        nxt = 0
        try:
            for _ in range(self.num_batches):
                if self.ordered:
                    while nxt not in pending:
                        i, batch = out.get()
                        pending[i] = batch
                    batch = pending.pop(nxt)
                    nxt += 1
                else:
                    _, batch = out.get()
                if isinstance(batch, Exception):
                    raise batch
                yield batch
        finally:
            stop.set()
