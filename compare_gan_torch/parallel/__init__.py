"""Parallelism: synchronous data parallelism over worker processes
(counterpart of compare_gan_tpu/parallel).

The JAX package writes the train step over the global batch and lets XLA
derive the collectives on a device mesh. The port runs one worker process
per device, joined by `torch.distributed` (NCCL between GPUs, gloo on the
CPU), and places the collectives itself where the step reads the batch as a
whole: BN moments, the losses' means, the gradients. Each worker holds its
rows of every sub-step's global batch and a replica of every variable, so
the step equals the one-process step at the same global batch.

`mesh_utils` holds the worker identity (`Replicas`), process-group set-up,
the row split and the gradient all-reduce; `tpu_ops` the differentiable
collectives.
"""

from compare_gan_torch.parallel import mesh_utils  # noqa: F401
from compare_gan_torch.parallel import tpu_ops  # noqa: F401
