"""Stream time of the `i3d.backbone` spans per video."""

from benchmark.program_spans import stream_ms_per


def read(run):
    return stream_ms_per(run, "i3d.backbone", "videos")
