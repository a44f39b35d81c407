"""Device idle share of the traced window (`readers.idle_pct`)."""

from benchmark.readers import idle_pct as read  # noqa: F401
