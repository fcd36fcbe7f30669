"""Fractal dimension of a set of generated images (counterpart of
compare_gan_tpu/metrics/fractal_dimension.py): the box-counting slope of
log N(r) against log r around the middle of the count range, where N(r)
counts the (image, seed) pairs closer than r, for random seed images.
f64 numpy on the host; the seeds come from the global `np.random`, which
the eval seeds with 42 (eval_gan_lib), as in the JAX package."""

from __future__ import annotations

import numpy as np

from compare_gan_torch.metrics import eval_task


def compute_fractal_dimension(fake_images, num_fd_seeds=100, n_bins=1000,
                              scale=0.1):
    """Box-counting slope (fractal_dimension.py:39-97)."""
    fake_images = np.asarray(fake_images)
    assert fake_images.ndim >= 2
    num_images = fake_images.shape[0]
    assert num_images >= num_fd_seeds
    flat = fake_images.reshape(num_images, -1).astype(np.float64)
    seeds = flat[np.random.randint(num_images, size=num_fd_seeds)]

    d2 = (np.sum(flat ** 2, 1)[:, None] + np.sum(seeds ** 2, 1)[None, :]
          - 2.0 * flat @ seeds.T)
    distances = np.sqrt(np.maximum(d2, 0.0)).ravel()
    min_d = distances[np.nonzero(distances)].min()
    max_d = distances.max()
    radii = min_d * (max_d / min_d) ** np.linspace(0, 1, n_bins)[1:]
    counts = np.sum(distances[:, None] < radii[None, :], axis=0)

    # The log-log slope in a window of +-scale around the middle count.
    x = np.log(radii)
    y = np.log(np.maximum(counts, 1))
    max_y = np.log(num_images * num_fd_seeds)
    min_y = np.log(num_fd_seeds)
    width = max_y - min_y
    mid = min_y + 0.5 * width
    start = int(np.argmax(y > mid - scale * width))
    end = int(np.argmax(y > mid + scale * width))
    if end <= start:
        return float("nan")
    design = np.stack([x[start:end], np.ones(end - start)], axis=1)
    return float(np.linalg.lstsq(design, y[start:end], rcond=None)[0][0])


class FractalDimensionTask(eval_task.EvalTask):
    """Fractal dimension of the generated images
    (fractal_dimension.py:30-37). Reads the images of every averaging
    run."""

    _LABEL = "fractal_dimension"
    reads_images = True

    def run_after_session(self, fake_dset, real_dset=None):
        del real_dset
        return {self._LABEL: compute_fractal_dimension(fake_dset.images)}
