"""EvalTask interface (counterpart of compare_gan_tpu/metrics/eval_task.py).

A task consumes a pair of `EvalDataSample`s (fake, real) that carry images
and their Inception activations and logits, after sampling is done: the
reference's `run_after_session` protocol.
"""

from __future__ import annotations

import abc


class EvalTask(abc.ABC):
    """Class that describes a single evaluation task, e.g. compute FID."""

    _LABEL = None

    def metric_list(self):
        """Frozenset of metric names computed by this task."""
        return frozenset({self._LABEL})

    @abc.abstractmethod
    def run_after_session(self, fake_dset, real_dset):
        """Compute metrics after sampling; returns {metric_name: value}.

        Args:
          fake_dset: `EvalDataSample` with generated images (+ activations
            and logits where required).
          real_dset: `EvalDataSample` with real eval images.
        """

    def __repr__(self):
        return f"{type(self).__name__}({self._LABEL})"
