"""Share of the peak (`readers.mfu_pct`)."""

from benchmark.readers import mfu_pct as read  # noqa: F401
