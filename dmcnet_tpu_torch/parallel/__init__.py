"""Training over several processes (counterpart of `dmcnet_tpu/parallel`):
`multihost` starts the process group and shards the batch's rows,
`mesh` is data parallelism with global-batch BatchNorm and averaged
gradients, `fsdp` shards parameters and optimizer states with FSDP2.  The
JAX package's tensor, pipeline and temporal parallelism (`tensor.py`,
`pipeline.py`, `pp_resnet.py`, `temporal.py`) are not ported yet (ROADMAP A
item 9): `--tp`, `--pp` and `--shard-time` raise."""
