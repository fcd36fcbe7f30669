"""Precision and recall for distributions (counterpart of
compare_gan_tpu/metrics/prd_score.py; Sajjadi et al., arXiv:1806.00035):
cluster the union of the fake and real Inception embeddings, histogram
both sets over the clusters, compute the PRD curve of the two histograms
and compress it to the (F_8, F_1/8) pair.

The clustering is the port's own, since the card's machine has no
scikit-learn: Lloyd's k-means (k = 20) from k-means++ seeds, run from 10
initialisations, keeping the one of lowest inertia, in f64 on the eval's
device with a seeded `torch.Generator`, so the metric is deterministic. The
JAX package calls `sklearn.cluster.MiniBatchKMeans(n_clusters=20,
n_init=10)` with no `random_state`, so its value varies from call to call;
the two agree where the clustering is fixed by the data (well-separated
clusters, identical or disjoint sets). `compute_prd` and the F-beta pair
are exact copies.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from compare_gan_torch.metrics import eval_task


def compute_prd(eval_dist, ref_dist, num_angles=1001, epsilon=1e-10
                ) -> Tuple[np.ndarray, np.ndarray]:
    """PRD curve of two discrete distributions over the same states
    (prd_score.py:42-94): for slopes lambda = tan(theta), theta in
    (epsilon, pi/2 - epsilon), precision(lambda) = sum_s min(lambda ref(s),
    eval(s)) and recall = precision / lambda."""
    if not 0 < epsilon <= 0.1:
        raise ValueError(f"epsilon must be in (0, 0.1] but is {epsilon}.")
    if not 3 <= num_angles <= 1e6:
        raise ValueError(f"num_angles must be in [3, 1e6], got {num_angles}.")
    angles = np.linspace(epsilon, np.pi / 2 - epsilon, num=num_angles)
    slopes = np.tan(angles)[:, None]
    ref = np.asarray(ref_dist)[None, :]
    ev = np.asarray(eval_dist)[None, :]
    precision = np.minimum(ref * slopes, ev).sum(axis=1)
    recall = precision / slopes[:, 0]
    # Both lie in [0, 1]; clip excursions from rounding.
    return np.clip(precision, 0.0, 1.0), np.clip(recall, 0.0, 1.0)


def _sq_distances(x, centers):
    return ((x * x).sum(1, keepdim=True) - 2.0 * x @ centers.T
            + (centers * centers).sum(1)[None, :]).clamp_min(0.0)


def kmeans(data, num_clusters, num_init=10, max_iter=100,
           generator: Optional[torch.Generator] = None):
    """Labels [n] of the lowest-inertia run of Lloyd's k-means from
    `num_init` k-means++ seedings (each next seed drawn with probability
    proportional to its squared distance from the seeds so far), on
    `data`'s device and in its type."""
    n = data.shape[0]
    best_labels, best_inertia = None, None
    for _ in range(num_init):
        idx = torch.randint(n, (1,), generator=generator,
                            device=data.device)
        centers = data[idx]
        closest = _sq_distances(data, centers)[:, 0]
        for _ in range(1, num_clusters):
            weights = closest if closest.sum() > 0 else torch.ones_like(
                closest)
            idx = torch.multinomial(weights, 1, generator=generator)
            centers = torch.cat([centers, data[idx]])
            closest = torch.minimum(closest,
                                    _sq_distances(data, data[idx])[:, 0])
        labels = None
        for _ in range(max_iter):
            new_labels = _sq_distances(data, centers).argmin(1)
            if labels is not None and torch.equal(new_labels, labels):
                break
            labels = new_labels
            sums = torch.zeros_like(centers).index_add_(0, labels, data)
            counts = torch.bincount(labels, minlength=num_clusters)
            # An emptied cluster keeps its center.
            filled = counts > 0
            centers[filled] = sums[filled] / counts[filled, None].to(
                data.dtype)
        inertia = _sq_distances(data, centers).gather(
            1, labels[:, None]).sum()
        if best_inertia is None or inertia < best_inertia:
            best_labels, best_inertia = labels, inertia
    return best_labels


def _cluster_into_bins(eval_data, ref_data, num_clusters, generator):
    """Both sets' histograms over shared clusters (prd_score.py:97-122)."""
    union = torch.cat([eval_data, ref_data])
    labels = kmeans(union, num_clusters, generator=generator).cpu().numpy()
    bins = dict(bins=num_clusters, range=[0, num_clusters], density=True)
    return (np.histogram(labels[:len(eval_data)], **bins)[0],
            np.histogram(labels[len(eval_data):], **bins)[0])


def compute_prd_from_embedding(eval_data, ref_data, num_clusters=20,
                               num_angles=1001, num_runs=10,
                               enforce_balance=True, seed=0, device="cpu"):
    """PRD of two embeddings, averaged over `num_runs` clusterings
    (prd_score.py:126-178); the clustering runs on `device` from a
    generator seeded with `seed`."""
    if enforce_balance and len(eval_data) != len(ref_data):
        raise ValueError(
            f"The number of points in eval_data {len(eval_data)} is not "
            f"equal to the number of points in ref_data {len(ref_data)}. To "
            f"disable this exception, set enforce_balance to False (not "
            f"recommended).")
    eval_data = torch.as_tensor(np.asarray(eval_data, np.float64),
                                device=device)
    ref_data = torch.as_tensor(np.asarray(ref_data, np.float64),
                               device=device)
    generator = torch.Generator(device=device).manual_seed(seed)
    curves = [compute_prd(*_cluster_into_bins(eval_data, ref_data,
                                              num_clusters, generator),
                          num_angles)
              for _ in range(num_runs)]
    precision = np.mean([c[0] for c in curves], axis=0)
    recall = np.mean([c[1] for c in curves], axis=0)
    return precision, recall


def _prd_to_f_beta(precision, recall, beta=1, epsilon=1e-10):
    """F_beta of every point of the curve (prd_score.py:182-215)."""
    if not ((precision >= 0).all() and (precision <= 1).all()):
        raise ValueError("All values in precision must be in [0, 1].")
    if not ((recall >= 0).all() and (recall <= 1).all()):
        raise ValueError("All values in recall must be in [0, 1].")
    if beta <= 0:
        raise ValueError(f"Given parameter beta {beta} must be positive.")
    return ((1 + beta ** 2) * precision * recall
            / (beta ** 2 * precision + recall + epsilon))


def prd_to_max_f_beta_pair(precision, recall, beta=8):
    """(max F_beta, max F_1/beta): the curve as two scalars
    (prd_score.py:218-250)."""
    precision, recall = np.asarray(precision), np.asarray(recall)
    f_beta = float(np.max(_prd_to_f_beta(precision, recall, beta)))
    f_beta_inv = float(np.max(_prd_to_f_beta(precision, recall, 1.0 / beta)))
    return f_beta, f_beta_inv


def plot(precision_recall_pairs, labels: Optional[Sequence[str]] = None,
         out_path: Optional[str] = None, legend_loc="lower left", dpi=150):
    """PRD plot (prd_score.py:253-299); needs matplotlib, imported here
    only: nothing on the eval path calls it."""
    import matplotlib.pyplot as plt
    if labels is not None and len(labels) != len(precision_recall_pairs):
        raise ValueError("labels must match precision_recall_pairs length.")
    fig = plt.figure(figsize=(3.5, 3.5), dpi=dpi)
    ax = fig.add_subplot(111)
    ax.tick_params(axis="both", which="major", labelsize=12)
    for i, (precision, recall) in enumerate(precision_recall_pairs):
        label = labels[i] if labels is not None else None
        plt.plot(recall, precision, label=label, alpha=0.5, linewidth=3)
    if labels is not None:
        plt.legend(loc=legend_loc)
    plt.xlim([0, 1])
    plt.ylim([0, 1])
    plt.xlabel("Recall", fontsize=12)
    plt.ylabel("Precision", fontsize=12)
    plt.tight_layout()
    if out_path is None:
        plt.show()
    else:
        plt.savefig(out_path, bbox_inches="tight", dpi=dpi)
        plt.close()


class PRDTask(eval_task.EvalTask):
    """(F_8, F_1/8) of the fake against the real activations, clustered on
    the eval's device."""

    _LABEL = "prd"

    def metric_list(self):
        return frozenset({"prd_f8", "prd_f1_8"})

    def run_after_session(self, fake_dset, real_dset, device="cpu"):
        n = min(len(fake_dset.activations), len(real_dset.activations))
        precision, recall = compute_prd_from_embedding(
            fake_dset.activations[:n], real_dset.activations[:n],
            device=device)
        f8, f1_8 = prd_to_max_f_beta_pair(precision, recall)
        return {"prd_f8": f8, "prd_f1_8": f1_8}
