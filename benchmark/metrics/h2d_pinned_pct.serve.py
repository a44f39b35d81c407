"""Share of the GOP chunk bytes copied to the card that left from pinned
staging: the `pinned_bytes` over the `bytes` counts of the `serving.h2d`
spans."""

from benchmark.program_spans import count_pct


def read(run):
    return count_pct(run, "serving.h2d", "pinned_bytes", "bytes")
