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

In the spatial layout the perturbed images are bands of image height and
D's logits are whole on every model rank. The backward of D's sums over
the model group adds the k ranks' seeds, so each rank seeds 1 / k of the
logits' sum: the gradient is then the band of the whole image's (images
held whole, which no input height that splits gives, seed all of it and
sum their own squares). The
slope sums the bands' squares over the group (`tpu_ops.image_sum`), and
the penalty's double backward runs the collectives' adjoints, the same
calls in the same order on every rank. DRAGAN's noise is drawn in the
whole image's shape and cut into the band, the one-process stream.

Gin-selected via `penalty.fn`.
"""

from __future__ import annotations

import torch

from compare_gan_torch import config as gin
from compare_gan_torch import utils
from compare_gan_torch.parallel import tpu_ops


def slopes(d_logits_fn, x):
    """||grad_x D(x)||_2 of each image, with the 1e-4 stabilizer under the
    root (penalty_lib.py:24-33), differentiable again; `x` requires grad."""
    logits = d_logits_fn(x)
    shares = (tpu_ops.spatial().model_size if tpu_ops.is_band(x, "slopes")
              else 1)
    gradients, = torch.autograd.grad(logits.float().sum() / shares, x,
                                     create_graph=True)
    return torch.sqrt(1e-4 + tpu_ops.image_sum(gradients.float().square()))


def _slope_penalty(d_logits_fn, x_perturbed):
    """mean((||grad_x D(x)||_2 - 1)^2) (penalty_lib.py:24-33)."""
    slope = slopes(d_logits_fn, x_perturbed.detach().requires_grad_())
    return tpu_ops.batch_mean((slope - 1.0).square())


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
    noise = tpu_ops.split_bands(draw("dragan_noise", (
        x.shape[0], tpu_ops.image_rows(x)) + tuple(x.shape[2:]))) - 0.5
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
