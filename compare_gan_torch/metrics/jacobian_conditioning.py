"""Conditioning of the generator's Jacobian (counterpart of
compare_gan_tpu/metrics/jacobian_conditioning.py; arXiv:1802.08768).

The JAX package takes J with `jax.vmap(jax.jacrev(...))`, one VJP per
output pixel. The port takes it in reverse mode too, with one method for
every generator: z_i is replicated K times in a batch, G runs once on that
batch, and one `autograd.grad` with K one-hot output cotangents yields K
rows of J_i. This relies on G's eval-mode forward treating the examples of
a batch independently, which eval-mode batch norm does (tested). It runs
through the attention kernel, whose backward is first order (no vmap rule
is needed).
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch

from compare_gan_torch.metrics import eval_task

# Output rows of J per backward pass (the replicated batch's size).
ROWS_PER_PASS = 1024


def compute_jacobian(generator_fn: Callable, z, rows_per_pass=ROWS_PER_PASS
                     ) -> np.ndarray:
    """df/dz, [batch, out_dim, z_dim], of the flattened images
    f(z) = generator_fn(z) (a differentiable function of a [B, z_dim]
    tensor)."""
    z = torch.as_tensor(z)
    with torch.no_grad():
        out_dim = generator_fn(z[:1]).numel()
    k = min(rows_per_pass, out_dim)
    jac = torch.empty((len(z), out_dim, z.shape[1]), dtype=torch.float32)
    rows = torch.arange(k, device=z.device)
    for i in range(len(z)):
        zk = z[i:i + 1].expand(k, -1).clone().requires_grad_(True)
        with torch.enable_grad():
            out = generator_fn(zk).reshape(k, out_dim)
        for start in range(0, out_dim, k):
            n = min(k, out_dim - start)
            cotangent = torch.zeros_like(out)
            cotangent[rows[:n], start + rows[:n]] = 1.0
            (grad,) = torch.autograd.grad(out, zk, cotangent,
                                          retain_graph=start + k < out_dim)
            jac[i, start:start + n] = grad[:n].float().cpu()
    return jac.numpy()


def _analyze_metric_tensor(metric_tensor: np.ndarray) -> Dict[str, np.ndarray]:
    """Spectral statistics of [batch, dim, dim] metric tensors
    (jacobian_conditioning.py:127-147)."""
    eigenvalues, _ = np.linalg.eig(metric_tensor)
    condition_number = np.linalg.cond(metric_tensor)
    log_condition_number = np.log(condition_number)
    _, logdet = np.linalg.slogdet(metric_tensor)
    return {"eigenvalues": eigenvalues, "logdet": logdet,
            "log_condition_number": log_condition_number}


def analyze_jacobian(jacobian_array: np.ndarray) -> Dict:
    """Conditioning of J^T J per example and of its batch mean
    (jacobian_conditioning.py:150-175)."""
    jacobian_array = np.asarray(jacobian_array)
    jt = np.transpose(jacobian_array, [0, 2, 1])
    metric_tensor = np.matmul(jt, jacobian_array)
    mean_metric_tensor = metric_tensor.mean(0)[None]
    return {"metric_tensor": _analyze_metric_tensor(metric_tensor),
            "mean_metric_tensor": _analyze_metric_tensor(mean_metric_tensor)}


class GeneratorConditionNumberTask(eval_task.EvalTask):
    """Mean and std of the log condition numbers of G's metric tensor over a
    batch of z from the GAN's prior (jacobian_conditioning.py:30-58). Needs
    the generator: it runs once per checkpoint through `run_with_gan`."""

    _CONDITION_NUMBER_COUNT = "log_condition_number_count"
    _CONDITION_NUMBER_MEAN = "log_condition_number_mean"
    _CONDITION_NUMBER_STD = "log_condition_number_std"

    def metric_list(self):
        return frozenset([self._CONDITION_NUMBER_COUNT,
                          self._CONDITION_NUMBER_MEAN,
                          self._CONDITION_NUMBER_STD])

    def run_with_gan(self, gan, ts, batch_size=64, seed=42, z=None):
        """J of G in eval mode with the inference params at a batch of z
        drawn from the GAN's prior (`z` gin scope) with a generator seeded
        by `seed`, or at `z` when given (tests)."""
        if z is None:
            gen = torch.Generator(device=gan.device).manual_seed(seed)
            z = gan.z_generator([batch_size, gan.z_dim], gen)
        z = torch.as_tensor(z, device=gan.device)
        return self.run_with_generator(
            lambda zb: gan.sample(ts, zb, differentiable=True), z)

    def run_with_generator(self, generator_fn, z):
        jac = compute_jacobian(generator_fn, z)
        result = analyze_jacobian(jac)["metric_tensor"][
            "log_condition_number"]
        return {self._CONDITION_NUMBER_COUNT: len(result),
                self._CONDITION_NUMBER_MEAN: float(np.mean(result)),
                self._CONDITION_NUMBER_STD: float(np.std(result))}

    def run_after_session(self, fake_dset, real_dset=None):
        raise NotImplementedError(
            "GeneratorConditionNumberTask needs generator access; call "
            "run_with_gan(gan, ts) or run_with_generator(generator_fn, z).")
