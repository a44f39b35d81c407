"""Training and evaluation over several processes (counterpart of
`dmcnet_tpu/parallel`): `multihost` starts the process group, shards the
batch's rows and spawns one process per card, `mesh` is data parallelism
with global-batch BatchNorm and averaged gradients, `fsdp` shards
parameters and optimizer states with FSDP2, `tensor` shards the large
layers' output channels over a (data, model) mesh, and `temporal` splits an
I3D clip's T axis over the ranks with halo exchanges.  Serving over several
cards needs no process group: `serving.DMCPredictor(mesh=...)` holds a
replica on each device.  The JAX package's pipeline parallelism
(`pipeline.py`, `pp_resnet.py`) is not ported yet (ROADMAP A item 9):
`--pp` raises."""
