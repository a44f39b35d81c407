"""dmcnet training in the port: optimizers, train/eval steps, metrics and
checkpoints (counterpart of `dmcnet_tpu/train`; the GAN and I3D engines
are not ported yet)."""
