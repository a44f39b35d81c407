"""Training in the port: optimizers, the dmcnet train/eval steps, the GAN's
D and G steps, the I3D train steps with iter-size accumulation and the I3D
eval step, the I3D LR schedulers and callbacks, metrics and checkpoints
(counterpart of `dmcnet_tpu/train`)."""
