"""Named, per-(seed, step, sub_step) random streams.

Counterpart of compare_gan_tpu/ops/rng.py. The JAX package folds (seed,
step, sub_step) and a hash of the op's name into a threefry key; the port
seeds one `torch.Generator` per (seed, step, sub_step, name) the same way, so
a draw is identical across runs and restarts and different across steps and
names. The bits differ from JAX's (threefry cannot be reproduced here), so
parity tests hand the JAX draws to the port instead.
"""

from __future__ import annotations

import torch

from compare_gan_torch import config as gin
from compare_gan_torch import core


def stream(seed: int, step: int, sub_step: int, name: str,
           device) -> torch.Generator:
    """The generator of one named draw in one training sub-step."""
    gen = torch.Generator(device=device)
    gen.manual_seed(core.seed_for(seed, f"{int(step)}/{int(sub_step)}/{name}"))
    return gen


def uniform(shape, generator: torch.Generator, dtype=torch.float32,
            minval=0.0, maxval=1.0) -> torch.Tensor:
    u = torch.rand(tuple(shape), generator=generator, dtype=dtype,
                   device=generator.device)
    return minval + (maxval - minval) * u


def normal(shape, generator: torch.Generator, dtype=torch.float32,
           mean=0.0, stddev=1.0) -> torch.Tensor:
    return mean + stddev * torch.randn(tuple(shape), generator=generator,
                                       dtype=dtype, device=generator.device)


def randint(shape, minval, maxval, generator: torch.Generator
            ) -> torch.Tensor:
    return torch.randint(minval, maxval, tuple(shape), generator=generator,
                         device=generator.device)


# The reference's configs bind z.distribution_fn to TF RNG symbols
# (example_configs/biggan_imagenet128.gin), as in ops/rng.py:104-111.
gin.register("tf.random.normal", normal)
gin.register("tf.random.uniform", uniform)
gin.register("random_normal", normal)
gin.register("random_uniform", uniform)
