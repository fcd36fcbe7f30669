"""Fréchet Inception Distance (counterpart of
compare_gan_tpu/metrics/fid_score.py).

The score of record is computed in float64 numpy on the host: FID's matrix
square root is numerically fragile. `fid_on_device` is the f32 variant on
the device (Newton–Schulz iteration, products only), within ~1% of the f64
value, for tracking a run.
"""

from __future__ import annotations

import numpy as np
import torch

from compare_gan_torch.metrics import eval_task

# Sentinel for a failed FID computation (reference fid_score.py:36).
FAILED_FID = 4242.0


def compute_fid_from_activations(fake_activations: np.ndarray,
                                 real_activations: np.ndarray) -> float:
    """FID = |m_f - m_r|^2 + tr(C_f + C_r - 2 sqrt(C_f C_r)), f64 on the host
    (tfgan.eval.frechet_classifier_distance_from_activations)."""
    fake = np.asarray(fake_activations, np.float64)
    real = np.asarray(real_activations, np.float64)
    m_f, m_r = fake.mean(0), real.mean(0)
    c_f = np.atleast_2d(np.cov(fake, rowvar=False))
    c_r = np.atleast_2d(np.cov(real, rowvar=False))
    # sqrt(C_f C_r) is similar to sqrt(S_f C_r S_f) with S_f = sqrt(C_f).
    eigvals_f, eigvecs_f = np.linalg.eigh(c_f)
    sqrt_f = (eigvecs_f * np.sqrt(np.maximum(eigvals_f, 0))) @ eigvecs_f.T
    inner = sqrt_f @ c_r @ sqrt_f
    eigvals = np.linalg.eigvalsh(inner)
    trace_sqrt = np.sum(np.sqrt(np.maximum(eigvals, 0)))
    fid = (np.sum((m_f - m_r) ** 2) + np.trace(c_f) + np.trace(c_r)
           - 2.0 * trace_sqrt)
    return float(fid)


def fid_on_device(fake_activations, real_activations, num_iters=20,
                  device="cuda"):
    """f32 FID on `device`: Newton–Schulz iteration for tr sqrt(C_f C_r).
    Every product is full f32: TF32 is turned off for the call (the JAX
    package pins Precision.HIGHEST), since rounded products are far too
    coarse for a covariance square root. Returns a 0-d tensor."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        fake = torch.as_tensor(np.asarray(fake_activations, np.float32),
                               device=device)
        real = torch.as_tensor(np.asarray(real_activations, np.float32),
                               device=device)
        m_f, m_r = fake.mean(0), real.mean(0)

        def cov(x, m):
            xc = x - m
            return xc.T @ xc / (x.shape[0] - 1)

        c_f, c_r = cov(fake, m_f), cov(real, m_r)
        prod = c_f @ c_r
        # Newton–Schulz on the normalized product.
        norm = torch.sqrt(torch.trace(prod @ prod.T))
        eye = torch.eye(prod.shape[0], dtype=torch.float32, device=device)
        y, z = prod / norm, eye
        for _ in range(num_iters):
            t = 0.5 * (3.0 * eye - z @ y)
            y, z = y @ t, t @ z
        sqrt_prod = y * torch.sqrt(norm)
        return (torch.sum((m_f - m_r) ** 2) + torch.trace(c_f)
                + torch.trace(c_r) - 2.0 * torch.trace(sqrt_prod))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


class FIDScoreTask(eval_task.EvalTask):
    """Evaluation task for the FID score (fid_score.py:39-60)."""

    _LABEL = "fid_score"

    def run_after_session(self, fake_dset, real_dset):
        try:
            score = compute_fid_from_activations(fake_dset.activations,
                                                 real_dset.activations)
        except (np.linalg.LinAlgError, ValueError):
            score = FAILED_FID
        return {self._LABEL: score}
