"""Compressed-video codec layer of the port (see dmcnet_tpu_torch/codec/*)."""
