"""GAN losses (counterpart of compare_gan_tpu/gans/loss_lib.py).

Each loss maps the discriminator outputs on real/fake batches to
`(d_loss, d_loss_real, d_loss_fake, g_loss)` f32 scalars, means over the
batch. Gin-selected via `loss.fn`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from compare_gan_torch import config as gin
from compare_gan_torch import utils


def check_dimensions(d_real, d_fake, d_real_logits, d_fake_logits):
    """All inputs [batch_size, 1] (loss_lib.py:22-36)."""

    def _check_pair(a, b):
        if tuple(a) != tuple(b):
            raise ValueError(f"Shape mismatch: {a} vs {b}.")
        if len(a) != 2 or len(b) != 2:
            raise ValueError(f"Rank: expected 2, got {len(a)} and {len(b)}")

    if d_real is not None and d_fake is not None:
        _check_pair(d_real.shape, d_fake.shape)
    if d_real_logits is not None and d_fake_logits is not None:
        _check_pair(d_real_logits.shape, d_fake_logits.shape)
    if d_real is not None and d_real_logits is not None:
        _check_pair(d_real.shape, d_real_logits.shape)


def _sigmoid_ce_with_logits(logits, labels):
    x32 = logits.float()
    return (torch.clamp(x32, min=0.0) - x32 * labels
            + torch.log1p(torch.exp(-torch.abs(x32))))


@gin.configurable("non_saturating")
def non_saturating(d_real_logits, d_fake_logits, d_real=None, d_fake=None):
    check_dimensions(d_real, d_fake, d_real_logits, d_fake_logits)
    d_loss_real = _sigmoid_ce_with_logits(d_real_logits, 1.0).mean()
    d_loss_fake = _sigmoid_ce_with_logits(d_fake_logits, 0.0).mean()
    g_loss = _sigmoid_ce_with_logits(d_fake_logits, 1.0).mean()
    return d_loss_real + d_loss_fake, d_loss_real, d_loss_fake, g_loss


@gin.configurable("wasserstein")
def wasserstein(d_real_logits, d_fake_logits, d_real=None, d_fake=None):
    check_dimensions(d_real, d_fake, d_real_logits, d_fake_logits)
    d_loss_real = -d_real_logits.float().mean()
    d_loss_fake = d_fake_logits.float().mean()
    return d_loss_real + d_loss_fake, d_loss_real, d_loss_fake, -d_loss_fake


@gin.configurable("least_squares")
def least_squares(d_real, d_fake, d_real_logits=None, d_fake_logits=None):
    check_dimensions(d_real, d_fake, d_real_logits, d_fake_logits)
    d_loss_real = torch.square(d_real.float() - 1.0).mean()
    d_loss_fake = torch.square(d_fake.float()).mean()
    d_loss = 0.5 * (d_loss_real + d_loss_fake)
    g_loss = 0.5 * torch.square(d_fake.float() - 1.0).mean()
    return d_loss, d_loss_real, d_loss_fake, g_loss


@gin.configurable("hinge")
def hinge(d_real_logits, d_fake_logits, d_real=None, d_fake=None):
    check_dimensions(d_real, d_fake, d_real_logits, d_fake_logits)
    d_loss_real = F.relu(1.0 - d_real_logits.float()).mean()
    d_loss_fake = F.relu(1.0 + d_fake_logits.float()).mean()
    g_loss = -d_fake_logits.float().mean()
    return d_loss_real + d_loss_fake, d_loss_real, d_loss_fake, g_loss


@gin.configurable("loss")
def get_losses(fn=non_saturating, **kwargs):
    """Dispatcher, gin key `loss.fn`."""
    return utils.call_with_accepted_args(fn, **kwargs)
