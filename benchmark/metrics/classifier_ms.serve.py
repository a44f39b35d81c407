"""Stream time of the `serving.classifier` spans per request."""

from benchmark.program_spans import stream_ms_per


def read(run):
    return stream_ms_per(run, "serving.classifier", "requests")
