"""GAN penalties (counterpart of compare_gan_tpu/gans/penalty_lib.py).

Only `no_penalty` and the `penalty.fn` dispatcher are ported; the gradient
penalties (wgangp, dragan), which need double backward, are listed in
ROADMAP.md.
"""

from __future__ import annotations

import torch

from compare_gan_torch import config as gin
from compare_gan_torch import utils


@gin.configurable("no_penalty")
def no_penalty(device=None):
    return torch.zeros((), dtype=torch.float32, device=device)


@gin.configurable("penalty")
def get_penalty_loss(fn=no_penalty, **kwargs):
    """Dispatcher, gin key `penalty.fn`."""
    return utils.call_with_accepted_args(fn, **kwargs)
