"""MS-SSIM diversity score (counterpart of
compare_gan_tpu/metrics/ms_ssim_score.py): the mean MS-SSIM over the
ordered pairs of distinct images within each of 5 random batches of 64
generated images, a probe of mode collapse (higher: less diverse; section
5.3 of arXiv:1710.08446)."""

from __future__ import annotations

import numpy as np
import torch

from compare_gan_torch.metrics import eval_task, image_similarity

def compute_msssim_score(fake_images, batch_size=64, num_batches=5, seed=0,
                         device="cpu"):
    """Average MS-SSIM over all ordered pairs (i != j) within each batch,
    the batches drawn with `np.random.default_rng(seed)` as in the JAX
    package; MS-SSIM runs on `device`."""
    fake_images = np.asarray(fake_images, np.float32)
    rng = np.random.default_rng(seed)
    scores = []
    for _ in range(num_batches):
        idx = rng.integers(0, len(fake_images), size=batch_size)
        batch = torch.from_numpy(fake_images[idx]).to(device)
        vals = image_similarity.pairwise_multiscale_ssim(batch).cpu().numpy()
        total = vals.sum() - batch_size  # Drop identical pairs (score 1).
        scores.append(total / (batch_size * batch_size - batch_size))
    return float(np.mean(scores))


class MultiscaleSSIMTask(eval_task.EvalTask):
    """MS-SSIM among the generated images (ms_ssim_score.py:38-47), on the
    eval's device. Reads the images of every averaging run."""

    _LABEL = "ms_ssim"
    reads_images = True

    def run_after_session(self, fake_dset, real_dset=None, device="cpu"):
        del real_dset
        return {self._LABEL: compute_msssim_score(fake_dset.images,
                                                  device=device)}
