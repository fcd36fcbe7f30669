"""Optimizers under the reference's gin names (counterpart of
compare_gan_tpu/gans/optimizers.py).

Each follows the optax transformation the JAX package builds, step for
step and in the same f32 operations, and updates parameters and its state
in place. A state is a dataclass whose int fields are counters and whose
dict fields map each parameter's JAX name to a slot tensor (checkpoint.py
saves every field under the port's own keys, `.g_opt.<field>`).

* Adam (`optax.adam`): mu = b1*mu + (1-b1)*g; nu = b2*nu + (1-b2)*g^2;
  update = -lr * (mu / (1 - b1^count)) / (sqrt(nu / (1 - b2^count)) + eps).
  `moment_dtype='bfloat16'` stores mu in bf16 (optax's `mu_dtype`): the
  update reads the f32 moment, the state keeps it rounded.
* GradientDescent (`optax.sgd`): update = -lr * g.
* Momentum (`optax.sgd` with momentum): trace = g + m*trace; update =
  -lr * trace, or -lr * (g + m*trace) with Nesterov.
* RMSProp (`optax.rmsprop`, initial_scale 1 as TF1's): nu = decay*nu +
  (1-decay)*g^2 from nu = 1; u = -lr * g / sqrt(nu + eps); with momentum m
  the update is trace = u + m*trace (m = 0 keeps no trace: it is u).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np
import torch

from compare_gan_torch import config as gin

Slots = Dict[str, torch.Tensor]


def _zeros(params, dtype=torch.float32) -> Slots:
    return {k: torch.zeros_like(v, dtype=dtype) for k, v in params.items()}


def _lists(names, *dicts) -> List[List[torch.Tensor]]:
    return [[d[k] for k in names] for d in dicts]


def _apply(p, updates, lr):
    """p += -lr * u, the scaled update rounded before the add, as optax's
    scale_by_learning_rate then apply_updates."""
    torch._foreach_add_(p, torch._foreach_mul(updates, -lr))


@dataclasses.dataclass
class AdamState:
    count: int
    mu: Slots
    nu: Slots


class Adam:
    def __init__(self, learning_rate, beta1=0.9, beta2=0.999, epsilon=1e-8,
                 moment_dtype=None):
        self.lr = learning_rate
        self.b1, self.b2, self.eps = beta1, beta2, epsilon
        self.mu_dtype = (getattr(torch, moment_dtype)
                         if isinstance(moment_dtype, str) else moment_dtype)

    def init(self, params: Slots) -> AdamState:
        return AdamState(count=0,
                         mu=_zeros(params, self.mu_dtype or torch.float32),
                         nu=_zeros(params))

    @torch.no_grad()
    def step(self, params: Slots, grads: Slots, state: AdamState) -> None:
        """Update `params` and `state` in place."""
        names = list(params)
        p, g, mu, nu = _lists(names, params, grads, state.mu, state.nu)
        state.count += 1
        # (1 - b) * g + b * m, as optax's update_moment; a bf16 m times b
        # rounds to bf16 first (a weakly typed product in JAX).
        if self.mu_dtype in (None, torch.float32):
            torch._foreach_mul_(mu, self.b1)
            torch._foreach_add_(mu, torch._foreach_mul(g, 1.0 - self.b1))
            mu32 = mu
        else:
            mu32 = [gi.mul(1.0 - self.b1) + mi.mul(self.b1)
                    for gi, mi in zip(g, mu)]
        g2 = torch._foreach_mul(g, g)
        torch._foreach_mul_(g2, 1.0 - self.b2)
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_add_(nu, g2)
        # optax computes 1 - b**count in float32.
        bc1, bc2 = (float(np.float32(1) - np.float32(b) ** np.float32(
            state.count)) for b in (self.b1, self.b2))
        mu_hat = torch._foreach_div(mu32, bc1)
        nu_hat = torch._foreach_div(nu, bc2)
        torch._foreach_sqrt_(nu_hat)
        torch._foreach_add_(nu_hat, self.eps)
        torch._foreach_div_(mu_hat, nu_hat)
        _apply(p, mu_hat, self.lr)
        if mu32 is not mu:
            for mi, m32 in zip(mu, mu32):
                mi.copy_(m32)


@dataclasses.dataclass
class SGDState:
    count: int


class GradientDescent:
    def __init__(self, learning_rate):
        self.lr = learning_rate

    def init(self, params: Slots) -> SGDState:
        return SGDState(count=0)

    @torch.no_grad()
    def step(self, params: Slots, grads: Slots, state: SGDState) -> None:
        names = list(params)
        p, g = _lists(names, params, grads)
        state.count += 1
        _apply(p, g, self.lr)


@dataclasses.dataclass
class MomentumState:
    count: int
    trace: Slots


class Momentum:
    def __init__(self, learning_rate, momentum=0.9, use_nesterov=False):
        self.lr, self.momentum, self.nesterov = (learning_rate, momentum,
                                                 use_nesterov)

    def init(self, params: Slots) -> MomentumState:
        return MomentumState(count=0, trace=_zeros(params))

    @torch.no_grad()
    def step(self, params: Slots, grads: Slots, state: MomentumState
             ) -> None:
        names = list(params)
        p, g, trace = _lists(names, params, grads, state.trace)
        state.count += 1
        torch._foreach_mul_(trace, self.momentum)
        torch._foreach_add_(trace, g)
        updates = trace
        if self.nesterov:
            updates = torch._foreach_add(
                g, torch._foreach_mul(trace, self.momentum))
        _apply(p, updates, self.lr)


@dataclasses.dataclass
class RMSPropState:
    count: int
    nu: Slots
    trace: Slots


class RMSProp:
    def __init__(self, learning_rate, decay=0.9, momentum=0.0,
                 epsilon=1e-10):
        self.lr, self.decay, self.momentum, self.eps = (
            learning_rate, decay, momentum, epsilon)

    def init(self, params: Slots) -> RMSPropState:
        return RMSPropState(
            count=0,
            nu={k: torch.ones_like(v, dtype=torch.float32)
                for k, v in params.items()},
            trace=_zeros(params) if self.momentum else {})

    @torch.no_grad()
    def step(self, params: Slots, grads: Slots, state: RMSPropState
             ) -> None:
        names = list(params)
        p, g, nu = _lists(names, params, grads, state.nu)
        state.count += 1
        g2 = torch._foreach_mul(g, g)
        torch._foreach_mul_(g2, 1.0 - self.decay)
        torch._foreach_mul_(nu, self.decay)
        torch._foreach_add_(nu, g2)
        scale = torch._foreach_add(nu, self.eps)
        torch._foreach_rsqrt_(scale)
        updates = torch._foreach_mul(g, scale)
        torch._foreach_mul_(updates, -self.lr)
        if self.momentum:
            trace = _lists(names, state.trace)[0]
            torch._foreach_mul_(trace, self.momentum)
            torch._foreach_add_(trace, updates)
            updates = trace
        torch._foreach_add_(p, updates)


@gin.configurable("AdamOptimizer")
def adam_optimizer(learning_rate, beta1=0.9, beta2=0.999, epsilon=1e-8,
                   moment_dtype=None, name=None):
    """Adam under the reference's binding name (optimizers.py:18-32)."""
    del name
    return Adam(learning_rate, beta1=beta1, beta2=beta2, epsilon=epsilon,
                moment_dtype=moment_dtype)


@gin.configurable("GradientDescentOptimizer")
def sgd_optimizer(learning_rate, name=None):
    del name
    return GradientDescent(learning_rate)


@gin.configurable("MomentumOptimizer")
def momentum_optimizer(learning_rate, momentum=0.9, use_nesterov=False,
                       name=None):
    del name
    return Momentum(learning_rate, momentum=momentum,
                    use_nesterov=use_nesterov)


@gin.configurable("RMSPropOptimizer")
def rmsprop_optimizer(learning_rate, decay=0.9, momentum=0.0, epsilon=1e-10,
                      name=None):
    del name
    return RMSProp(learning_rate, decay=decay, momentum=momentum,
                   epsilon=epsilon)


# The reference's configs name the TF classes; alias both the @references
# and the parameter-binding scopes (optimizers.py:61-70).
for _tf_name, _fn, _canonical in [
        ("tf.train.AdamOptimizer", adam_optimizer, "AdamOptimizer"),
        ("tf.train.GradientDescentOptimizer", sgd_optimizer,
         "GradientDescentOptimizer"),
        ("tf.train.MomentumOptimizer", momentum_optimizer,
         "MomentumOptimizer"),
        ("tf.train.RMSPropOptimizer", rmsprop_optimizer, "RMSPropOptimizer"),
]:
    gin.register(_tf_name, _fn)
    gin.add_scope_alias(_tf_name, _canonical)
