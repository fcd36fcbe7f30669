"""GAN penalties (counterpart of compare_gan_tpu/gans/penalty_lib.py).

The gradient penalties take D's slope at perturbed inputs with
`torch.autograd.grad(..., create_graph=True)`, so D's optimizer
differentiates the penalty a second time. `d_logits_fn(x) -> logits` is
supplied by the trainer and runs D without committing state. Their random
draws come from `draw(name, shape)`, uniform in [0, 1) in f32: the trainer's
named stream of the sub-step ("alpha", "dragan_noise"), or draws a test
hands in.

Means and DRAGAN's standard deviation are over the global batch
(`tpu_ops`): in a data-parallel step each worker returns its share of the
penalty, and of the L2 penalty, which every worker computes alike from the
replicated weights, its 1 / world part.

Gin-selected via `penalty.fn`.
"""

from __future__ import annotations

import torch

from compare_gan_torch import config as gin
from compare_gan_torch import utils
from compare_gan_torch.parallel import tpu_ops


def _slope_penalty(d_logits_fn, x_perturbed):
    """mean((||grad_x D(x)||_2 - 1)^2) with the 1e-4 stabilizer under the
    root (penalty_lib.py:24-33)."""
    if tpu_ops.spatial() is not None:
        raise ValueError("The gradient penalties have no spatial layout "
                         "(image height split over a model group).")
    xx = x_perturbed.detach().requires_grad_()
    logits = d_logits_fn(xx)
    gradients, = torch.autograd.grad(logits.float().sum(), xx,
                                     create_graph=True)
    slopes = torch.sqrt(1e-4 + gradients.float().square().sum(
        dim=tuple(range(1, gradients.dim()))))
    return tpu_ops.batch_mean((slopes - 1.0).square())


@gin.configurable("no_penalty")
def no_penalty(device=None):
    return torch.zeros((), dtype=torch.float32, device=device)


@gin.configurable("dragan_penalty")
def dragan_penalty(d_logits_fn, x, draw):
    """DRAGAN (penalty_lib.py:41-51): real samples perturbed by
    std(x) * U(-0.5, 0.5), clipped to [0, 1]. The perturbation is cast to
    x's type before the add, so a bf16 x keeps the penalty's D forward in
    bf16."""
    std = torch.sqrt(tpu_ops.batch_variance(x.float()))
    noise = draw("dragan_noise", tuple(x.shape)) - 0.5
    x_noisy = torch.clamp(x + (std * noise).to(x.dtype), 0.0, 1.0)
    return _slope_penalty(d_logits_fn, x_noisy)


@gin.configurable("wgangp_penalty")
def wgangp_penalty(d_logits_fn, x, x_fake, draw):
    """WGAN-GP (penalty_lib.py:54-60): real and fake interpolated with a
    per-example alpha ~ U(0, 1)."""
    alpha = draw("alpha", (x.shape[0],) + (1,) * (x.dim() - 1))
    interpolates = x + alpha.to(x.dtype) * (x_fake - x)
    return _slope_penalty(d_logits_fn, interpolates)


@gin.configurable("l2_penalty")
def l2_penalty(d_params):
    """Mean over D's kernels (names ending "/kernel", so no biases) of
    0.5 * sum(w^2) (penalty_lib.py:63-73)."""
    kernels = [v for name, v in d_params.items() if name.endswith("/kernel")]
    if not kernels:
        return torch.zeros((), dtype=torch.float32)
    return tpu_ops.replicated_share(torch.stack(
        [0.5 * v.float().square().sum() for v in kernels]).mean())


@gin.configurable("penalty")
def get_penalty_loss(fn=no_penalty, d_params_fn=None, **kwargs):
    """Dispatcher, gin key `penalty.fn`. `d_params_fn()` gathers D's
    parameters, and is called only for a penalty that reads `d_params`."""
    accepted = utils.accepted_args(fn)
    if d_params_fn is not None and (accepted is None
                                    or "d_params" in accepted):
        kwargs["d_params"] = d_params_fn()
    return utils.call_with_accepted_args(fn, **kwargs)
