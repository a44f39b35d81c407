"""Training in the port: optimizers, the dmcnet train/eval steps, the GAN's
D and G steps, the I3D eval step, metrics and checkpoints (counterpart of
`dmcnet_tpu/train`; the I3D train steps are not ported yet)."""
