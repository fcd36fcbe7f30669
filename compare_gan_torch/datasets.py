"""Datasets for the port: the JAX package's numpy input pipeline, reused.

`compare_gan_tpu.datasets` never touches jax on its own; the port registers
its own `dataset` configurable and calls the undecorated `get_dataset`, so
the JAX registry's bindings are never read. Batches stay numpy
({"images": f32 [B,H,W,C] in [0, 1], "labels": int32 [B]}) until the
trainer moves them to its device.

The port is one process, so each dataset's host topology is pinned to
(1 host, id 0): left unset, the JAX dataset would ask jax.distributed for it.
Bindings of the JAX package's transform configurables
(`train_imagenet_transform.*`, `image_resize.*`) are not forwarded yet.
"""

from __future__ import annotations

from compare_gan_tpu import datasets as _datasets

from compare_gan_torch import config as gin

set_fake_dataset = _datasets.set_fake_dataset


@gin.configurable("dataset")
def get_dataset(name, seed=547):
    """Gin key `dataset.name`."""
    ds = _datasets.get_dataset.__wrapped_fn__(name, seed=seed)
    ds._num_hosts, ds._host_id = 1, 0
    return ds
