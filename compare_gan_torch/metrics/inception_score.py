"""Inception Score (counterpart of compare_gan_tpu/metrics/inception_score.py).

IS = exp(E_x[KL(p(y|x) || p(y))]) from classifier logits, in f64 on the
host, in tfgan's log-space form.
"""

from __future__ import annotations

import numpy as np

from compare_gan_torch.metrics import eval_task


def classifier_score_from_logits(logits: np.ndarray) -> float:
    logits = np.asarray(logits, np.float64)
    log_prob = logits - _logsumexp(logits, axis=1, keepdims=True)
    prob = np.exp(log_prob)
    # E[log p(y|x)] - log p(y), with p(y) the marginal over the batch.
    q = prob.mean(0)
    kl = np.sum(prob * (log_prob - np.log(q)), axis=1)
    return float(np.exp(kl.mean()))


def _logsumexp(x, axis, keepdims):
    m = x.max(axis=axis, keepdims=True)
    out = m + np.log(np.sum(np.exp(x - m), axis=axis, keepdims=True))
    return out if keepdims else np.squeeze(out, axis)


class InceptionScoreTask(eval_task.EvalTask):
    """Task for the Inception score (inception_score.py:29-48)."""

    _LABEL = "inception_score"

    def run_after_session(self, fake_dset, real_dset):
        del real_dset  # IS uses only the fake logits.
        return {self._LABEL:
                classifier_score_from_logits(fake_dset.logits)}
