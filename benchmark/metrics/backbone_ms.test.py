"""Stream time of the `tsn.backbone` spans per video."""

from benchmark.program_spans import stream_ms_per


def read(run):
    return stream_ms_per(run, "tsn.backbone", "videos")
