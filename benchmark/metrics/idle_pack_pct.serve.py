"""Device idle while `serving.pack` is the open serving stage, as a share
of the traced window (`program_spans.idle_pct`)."""

from benchmark.program_spans import idle_pct


def read(run):
    return idle_pct(run, "serving.pack")
