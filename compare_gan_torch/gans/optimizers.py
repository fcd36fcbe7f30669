"""Optimizers under the reference's gin names (counterpart of
compare_gan_tpu/gans/optimizers.py).

Only Adam is ported. It follows `optax.adam` (optimizers.py:18-32) step for
step: mu = b1*mu + (1-b1)*g; nu = b2*nu + (1-b2)*g^2; count += 1;
update = -lr * (mu / (1 - b1^count)) / (sqrt(nu / (1 - b2^count)) + eps).
Moments are f32 and updated in place.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np
import torch

from compare_gan_torch import config as gin


@dataclasses.dataclass
class AdamState:
    count: int
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]


class Adam:
    def __init__(self, learning_rate, beta1=0.9, beta2=0.999, epsilon=1e-8):
        self.lr = learning_rate
        self.b1, self.b2, self.eps = beta1, beta2, epsilon

    def init(self, params: Dict[str, torch.Tensor]) -> AdamState:
        zeros = {k: torch.zeros_like(v, dtype=torch.float32)
                 for k, v in params.items()}
        return AdamState(count=0, mu=zeros,
                         nu={k: torch.zeros_like(v) for k, v in zeros.items()})

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor],
             grads: Dict[str, torch.Tensor], state: AdamState) -> None:
        """Update `params` and `state` in place."""
        names = list(params)
        p: List[torch.Tensor] = [params[k] for k in names]
        g = [grads[k] for k in names]
        mu = [state.mu[k] for k in names]
        nu = [state.nu[k] for k in names]
        state.count += 1
        # (1 - b) * g + b * m, as optax's update_moment.
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, torch._foreach_mul(g, 1.0 - self.b1))
        g2 = torch._foreach_mul(g, g)
        torch._foreach_mul_(g2, 1.0 - self.b2)
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_add_(nu, g2)
        # optax computes 1 - b**count in float32.
        bc1, bc2 = (float(np.float32(1) - np.float32(b) ** np.float32(
            state.count)) for b in (self.b1, self.b2))
        mu_hat = torch._foreach_div(mu, bc1)
        nu_hat = torch._foreach_div(nu, bc2)
        torch._foreach_sqrt_(nu_hat)
        torch._foreach_add_(nu_hat, self.eps)
        torch._foreach_div_(mu_hat, nu_hat)
        torch._foreach_mul_(mu_hat, -self.lr)
        torch._foreach_add_(p, mu_hat)


@gin.configurable("AdamOptimizer")
def adam_optimizer(learning_rate, beta1=0.9, beta2=0.999, epsilon=1e-8,
                   name=None):
    """Adam under the reference's binding name."""
    del name
    return Adam(learning_rate, beta1=beta1, beta2=beta2, epsilon=epsilon)


gin.register("tf.train.AdamOptimizer", adam_optimizer)
gin.add_scope_alias("tf.train.AdamOptimizer", "AdamOptimizer")
