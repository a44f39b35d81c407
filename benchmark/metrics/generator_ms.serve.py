"""Stream time of the `serving.generator` spans per request."""

from benchmark.program_spans import stream_ms_per


def read(run):
    return stream_ms_per(run, "serving.generator", "requests")
