"""Kernel Inception Distance (counterpart of
compare_gan_tpu/metrics/kid_score.py): the block estimator of the unbiased
MMD^2 with the polynomial kernel (x.y/d + 1)^3, f64 numpy on the host."""

from __future__ import annotations

import numpy as np

from compare_gan_torch.metrics import eval_task


def kid(fake_activations, real_activations, max_block_size=1024,
        output_stderr=False):
    """Unbiased MMD^2 averaged over blocks (kid_score.py:61-149): both sets
    split into ceil(n / max_block_size) near-equal chunks, one unbiased
    estimate per pair of chunks."""
    fake = np.asarray(fake_activations, np.float64)
    real = np.asarray(real_activations, np.float64)
    n_r, dim = real.shape
    n_f = fake.shape[0]
    n_blocks = int(np.ceil(max(n_r, n_f) / max_block_size))

    def splits(n):
        sizes = np.full(n_blocks, n // n_blocks)
        sizes[:n % n_blocks] += 1
        ends = np.cumsum(sizes)
        return [slice(e - s, e) for s, e in zip(sizes, ends)]

    def k(a, b):
        return (a @ b.T / dim + 1.0) ** 3

    ests = []
    for sl_r, sl_f in zip(splits(n_r), splits(n_f)):
        r, f = real[sl_r], fake[sl_f]
        m, n = len(r), len(f)
        k_rr, k_ff, k_rf = k(r, r), k(f, f), k(r, f)
        # Unbiased: the within-set terms drop their diagonals.
        term_rr = (k_rr.sum() - np.trace(k_rr)) / (m * (m - 1))
        term_ff = (k_ff.sum() - np.trace(k_ff)) / (n * (n - 1))
        ests.append(term_rr + term_ff - 2.0 * k_rf.mean())

    mn = float(np.mean(ests))
    if output_stderr:
        return mn, float(np.std(ests) / np.sqrt(len(ests)))
    return mn


class KIDScoreTask(eval_task.EvalTask):
    """KID of the fake against the real activations (kid_score.py:31-41)."""

    _LABEL = "kid_score"

    def run_after_session(self, fake_dset, real_dset):
        return {self._LABEL: kid(fake_dset.activations,
                                 real_dset.activations)}
