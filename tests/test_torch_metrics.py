"""The port's sample-and-feature metrics against the JAX package's: KID,
fractal dimension, MS-SSIM and PRD on shared numpy inputs made from a
seed, and the JAX tests' own analytic cases (tests/test_metrics.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_helpers as th

from compare_gan_tpu.metrics import fractal_dimension as jfractal
from compare_gan_tpu.metrics import image_similarity as jsim
from compare_gan_tpu.metrics import kid_score as jkid
from compare_gan_tpu.metrics import ms_ssim_score as jms_ssim
from compare_gan_tpu.metrics import prd_score as jprd
from compare_gan_torch.metrics import (fractal_dimension, image_similarity,
                                       kid_score, ms_ssim_score, prd_score)


# -- KID ----------------------------------------------------------------------

@pytest.mark.parametrize("n_fake,n_real,block", [(600, 600, 1024),
                                                 (2100, 1900, 512)])
def test_kid_equals_the_jax_package(n_fake, n_real, block):
    """Both are f64 numpy of the same sums: 1e-12 relative."""
    rng = np.random.RandomState(0)
    fake = rng.randn(n_fake, 8).astype(np.float32) + 0.3
    real = rng.randn(n_real, 8).astype(np.float32)
    for stderr in (False, True):
        got = kid_score.kid(fake, real, block, output_stderr=stderr)
        want = jkid.kid(fake, real, block, output_stderr=stderr)
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)


def test_kid_analytic_cases():
    """Identical sets: slightly negative (the within-set terms drop their
    diagonals); a shift is detected; the stderr is non-negative."""
    rng = np.random.RandomState(0)
    acts = rng.randn(600, 8)
    assert -0.1 < kid_score.kid(acts, acts.copy()) < 1e-8
    assert kid_score.kid(rng.randn(600, 8) + 1.0, acts) > 0.1
    _, std = kid_score.kid(rng.randn(2100, 4), rng.randn(2100, 4),
                           max_block_size=512, output_stderr=True)
    assert std >= 0


# -- Fractal dimension --------------------------------------------------------

def test_fractal_dimension_equals_the_jax_package():
    """The same global np.random seed picks the same seed images: 1e-12
    relative (f64 numpy on both sides)."""
    images = np.random.RandomState(1).rand(300, 8, 8, 3) * 255.0
    np.random.seed(42)
    want = jfractal.compute_fractal_dimension(images)
    np.random.seed(42)
    got = fractal_dimension.compute_fractal_dimension(images)
    np.testing.assert_allclose(got, want, rtol=1e-12)


def test_fractal_dimension_of_a_line_and_a_square():
    rng = np.random.RandomState(0)
    line = np.stack([np.linspace(0, 1, 2000), np.zeros(2000)], 1)
    square = rng.rand(2000, 2)
    assert abs(fractal_dimension.compute_fractal_dimension(line) - 1) < 0.3
    assert abs(fractal_dimension.compute_fractal_dimension(square) - 2) < 0.3


# -- MS-SSIM --------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(3, 64, 64, 3), (2, 28, 28, 1)])
def test_multiscale_ssim_equals_the_jax_package(shape):
    """f32 depthwise filters and products on two CPU backends: 1e-5. At 28
    px the pyramid meets odd sizes (7 -> 4 by edge padding) and windows
    narrower than 11 taps."""
    rng = np.random.RandomState(0)
    img1 = rng.rand(*shape).astype(np.float32) * 255.0
    img2 = np.clip(img1 + rng.randn(*shape).astype(np.float32) * 40.0, 0,
                   255)
    want = np.asarray(jsim.multiscale_ssim(jnp.asarray(img1),
                                           jnp.asarray(img2)))
    got = image_similarity.multiscale_ssim(img1, img2)
    assert tuple(got.shape) == (shape[0],)
    th.assert_close(got, want, rtol=1e-5, atol=1e-6)
    th.assert_close(image_similarity.ssim(img1, img2),
                    jsim.ssim(img1, img2), rtol=1e-5, atol=1e-6)


def test_msssim_score_equals_the_jax_package():
    """The same default_rng batches; every pair's MS-SSIM to 1e-5."""
    images = np.random.RandomState(2).rand(40, 32, 32, 3) * 255.0
    want = jms_ssim.compute_msssim_score(images, batch_size=8,
                                         num_batches=3)
    got = ms_ssim_score.compute_msssim_score(images, batch_size=8,
                                             num_batches=3)
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_pairwise_multiscale_ssim_is_the_ssim_of_each_pair():
    """The score's all-pairs form (each image's pyramid and moments taken
    once) equals multiscale_ssim of the explicit pairs, to f32 rounding."""
    images = torch.from_numpy(
        np.random.RandomState(4).rand(5, 32, 32, 3).astype(np.float32) * 255)
    got = image_similarity.pairwise_multiscale_ssim(images, rows=2)
    want = image_similarity.multiscale_ssim(
        images.repeat_interleave(5, dim=0), images.repeat(5, 1, 1, 1))
    th.assert_close(got.reshape(-1), want, rtol=1e-5, atol=1e-6)
    th.assert_close(torch.diagonal(got), np.ones(5), rtol=0, atol=1e-5)


def test_msssim_analytic_cases():
    """Identical images score 1; heavy noise scores below 0.9; a set of
    copies of one image scores higher than a diverse set."""
    rng = np.random.RandomState(0)
    img = rng.rand(2, 64, 64, 3) * 255
    th.assert_close(image_similarity.multiscale_ssim(img, img), 1.0,
                    rtol=0, atol=1e-4)
    noisy = np.clip(img[:1] + rng.randn(1, 64, 64, 3) * 80, 0, 255)
    assert 0 <= float(image_similarity.multiscale_ssim(img[:1], noisy)) < 0.9
    identical = np.tile(rng.rand(1, 64, 64, 3) * 255, (80, 1, 1, 1))
    diverse = rng.rand(80, 64, 64, 3) * 255
    same = ms_ssim_score.compute_msssim_score(identical, batch_size=8,
                                              num_batches=2)
    div = ms_ssim_score.compute_msssim_score(diverse, batch_size=8,
                                             num_batches=2)
    assert same > 0.99 and div < same


# -- PRD ------------------------------------------------------------------------

def test_prd_curve_and_f_beta_equal_the_jax_package_exactly():
    """compute_prd, _prd_to_f_beta and the max pair are copies: bitwise."""
    rng = np.random.RandomState(3)
    eval_dist, ref_dist = (h / h.sum() for h in rng.rand(2, 20))
    got = prd_score.compute_prd(eval_dist, ref_dist)
    want = jprd.compute_prd(eval_dist, ref_dist)
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
    assert np.array_equal(prd_score._prd_to_f_beta(*got, beta=8),
                          jprd._prd_to_f_beta(*want, beta=8))
    assert prd_score.prd_to_max_f_beta_pair(*got) == \
        jprd.prd_to_max_f_beta_pair(*want)


def test_prd_analytic_cases():
    """Identical distributions reach 1; disjoint ones stay at 0; the F-beta
    pair of a two-point curve; unbalanced sets are refused."""
    dist = np.array([0.25, 0.25, 0.5])
    precision, recall = prd_score.compute_prd(dist, dist)
    assert precision.max() > 0.99 and recall.max() > 0.99
    p, r = prd_score.compute_prd(np.array([1.0, 0.0]), np.array([0.0, 1.0]))
    assert p.max() < 1e-4 and r.max() < 1e-4
    f8, f1_8 = prd_score.prd_to_max_f_beta_pair(np.array([1.0, 0.5]),
                                                np.array([0.5, 1.0]))
    assert 0.5 < f8 <= 1.0 and 0.5 < f1_8 <= 1.0
    rng = np.random.RandomState(0)
    with pytest.raises(ValueError, match="not equal"):
        prd_score.compute_prd_from_embedding(rng.randn(10, 2),
                                             rng.randn(20, 2))


def _blobs(counts, seed, dim=16, spread=0.05):
    """Points around 5 centers 100 apart, `counts[i]` at center i: any
    k-means with k = 5 that converges finds these clusters."""
    centers = 100.0 * np.eye(5, dim)
    rng = np.random.RandomState(seed)
    return np.concatenate([c + spread * rng.randn(n, dim)
                           for c, n in zip(centers, counts) if n])


@pytest.mark.parametrize("eval_counts,ref_counts", [
    ((40, 40, 40, 40, 40), (40, 40, 40, 40, 40)),   # The same mixture.
    ((100, 50, 30, 20, 0), (20, 30, 50, 60, 40)),   # Reweighted.
    ((100, 100, 0, 0, 0), (0, 0, 100, 60, 40)),     # Disjoint supports.
])
def test_prd_from_embedding_on_fixed_clusters_equals_the_jax_package(
        eval_counts, ref_counts):
    """Where the data fixes the clustering, the port's seeded k-means and
    the JAX package's MiniBatchKMeans give the same histograms, so the
    curves agree to f64 rounding (1e-12) however each clusters."""
    eval_data = _blobs(eval_counts, 0)
    ref_data = _blobs(ref_counts, 1)
    got = prd_score.compute_prd_from_embedding(eval_data, ref_data,
                                               num_clusters=5, num_runs=2)
    want = jprd.compute_prd_from_embedding(eval_data, ref_data,
                                           num_clusters=5, num_runs=2)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-12, atol=1e-12)
    f8, f1_8 = prd_score.prd_to_max_f_beta_pair(*got)
    if eval_counts == ref_counts:
        assert f8 > 0.99 and f1_8 > 0.99
    if not any(e and r for e, r in zip(eval_counts, ref_counts)):
        assert f8 < 1e-4 and f1_8 < 1e-4


def test_kmeans_is_seeded_and_keeps_the_lowest_inertia():
    """The same generator seed gives the same labels; on 5 blobs the
    clustering is the blobs."""
    data = torch.from_numpy(_blobs((30, 30, 30, 30, 30), 4))
    labels = [prd_score.kmeans(data, 5, generator=torch.Generator()
                               .manual_seed(7)) for _ in range(2)]
    assert torch.equal(labels[0], labels[1])
    blocks = labels[0].reshape(5, 30)
    assert all(len(set(b.tolist())) == 1 for b in blocks)
    assert len(set(blocks[:, 0].tolist())) == 5
