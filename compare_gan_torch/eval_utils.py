"""Eval data holders and Inception feature extraction (counterpart of
compare_gan_tpu/eval_utils.py).

The feature extractor maps images in [0, 255] to (pool_3 activations,
logits). It is, in order:

1. a function installed with `set_inception_fn` (tests);
2. the port's Inception (`metrics/inception_net.py`) with the weights of
   `$COMPARE_GAN_INCEPTION_NPZ`, the `.npz` that
   `inception_net.convert_frozen_graph` writes from the frozen graph (the
   JAX package's converter writes the same file);
3. the port's Inception with the weights read straight from the frozen
   graph `$COMPARE_GAN_INCEPTION_PB` (the 2015-12-05 graph of every
   published compare_gan FID), without TensorFlow. The JAX package runs
   that graph in a TensorFlow session, fed at `Mul:0` after a bilinear
   resize to 299 and (x - 128) / 128; the port's network starts at the
   same place after the same preprocessing.

Both run on the eval's device.
"""

from __future__ import annotations

import os
from typing import Callable, Optional, Tuple

import numpy as np

NanFoundError = type("NanFoundError", (ValueError,), {})

INCEPTION_NPZ_ENV = "COMPARE_GAN_INCEPTION_NPZ"
INCEPTION_PB_ENV = "COMPARE_GAN_INCEPTION_PB"

# Test hook: fn(images_uint8_0_255 [N,H,W,3]) -> (pool [N,D], logits [N,K]).
_inception_fn: Optional[Callable] = None


def set_inception_fn(fn: Optional[Callable]) -> None:
    global _inception_fn
    _inception_fn = fn


class EvalDataSample:
    """Images in [0, 255] and, once computed, their activations and logits
    (reference EvalDataSample, eval_utils.py:56-84)."""

    def __init__(self, images: np.ndarray):
        self.images = images
        self.activations: Optional[np.ndarray] = None
        self.logits: Optional[np.ndarray] = None

    def set_num_examples(self, num_examples: int):
        """Keep exactly num_examples: sampling rounds up to whole batches,
        the metrics use N (reference eval_utils.py:68-78)."""
        if len(self.images):
            assert len(self.images) >= num_examples
            self.images = self.images[:num_examples]
        if self.activations is not None:
            self.activations = self.activations[:num_examples]
        if self.logits is not None:
            self.logits = self.logits[:num_examples]

    def discard_images(self):
        """Free the images once their features exist."""
        self.images = np.empty((0,))

    def set_data(self, activations, logits):
        self.activations = activations
        self.logits = logits


_resolved_fns: dict = {}  # (path, device) -> fn: the weights load once.


def get_inception_fn(device="cuda") -> Callable:
    """The feature extractor: the test hook if one is installed, else the
    port's Inception on `device` with the weights of
    $COMPARE_GAN_INCEPTION_NPZ, else of the frozen graph
    $COMPARE_GAN_INCEPTION_PB (memoized per file and device)."""
    if _inception_fn is not None:
        return _inception_fn
    from compare_gan_torch.metrics import inception_net
    for env, make in ((INCEPTION_NPZ_ENV, inception_net.make_feature_fn),
                      (INCEPTION_PB_ENV,
                       inception_net.make_graph_feature_fn)):
        path = os.environ.get(env)
        if path and os.path.exists(path):
            key = (path, str(device))
            if key not in _resolved_fns:
                _resolved_fns[key] = make(path, device)
            return _resolved_fns[key]
    raise RuntimeError(
        "No Inception feature extractor available. Set "
        f"${INCEPTION_NPZ_ENV} (the .npz that "
        "inception_net.convert_frozen_graph writes) or "
        f"${INCEPTION_PB_ENV} (the frozen graph), or inject one with "
        "eval_utils.set_inception_fn (tests).")


def inception_transform_np(images: np.ndarray, batch_size: int = 64,
                           device="cuda") -> Tuple[np.ndarray, np.ndarray]:
    """Batched (pool, logits) of images in [0, 255], [N, H, W, 3]
    (reference inception_transform_np, eval_utils.py:178-206). Raises
    NanFoundError on NaN inputs."""
    if np.isnan(images).any():
        raise NanFoundError("NaN detected in images fed to Inception.")
    fn = get_inception_fn(device)
    pools, logits = [], []
    for i in range(0, len(images), batch_size):
        p, l = fn(images[i:i + batch_size])
        pools.append(np.asarray(p))
        logits.append(np.asarray(l))
    return np.concatenate(pools), np.concatenate(logits)


def sample_fake_dataset(sample_fn: Callable, num_batches: int,
                        batch_size: int = 64) -> np.ndarray:
    """num_batches x batch_size images from `sample_fn(batch_index) ->
    [B, H, W, C] in [0, 1]`, scaled to [0, 255], grayscale tiled to RGB
    (reference sample_fake_dataset, eval_utils.py:144-162)."""
    out = []
    for i in range(num_batches):
        images = np.asarray(sample_fn(i))
        if np.isnan(images).any():
            raise NanFoundError("Detected NaN in fake images.")
        out.append(images * 255.0)
    images = np.concatenate(out)
    if images.shape[-1] == 1:
        images = np.tile(images, (1, 1, 1, 3))
    return images
