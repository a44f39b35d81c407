"""Share of the clip bytes copied to the card that the model reads: the
`kept` over the `bytes` counts of the `data.i3d_h2d` spans."""

from benchmark.program_spans import count_pct


def read(run):
    return count_pct(run, "data.i3d_h2d", "kept", "bytes")
