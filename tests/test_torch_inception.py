"""The port's Inception, FID and IS against the JAX package's, f32 on the
CPU: the network on the shared `.npz` layout (weights from either
package's random init), the TF1 bilinear resize, and the f64 metrics on the
same activations."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_helpers as th

from compare_gan_tpu import eval_utils as jeval_utils
from compare_gan_tpu.metrics import fid_score as jfid
from compare_gan_tpu.metrics import inception_net as jnet
from compare_gan_tpu.metrics import inception_score as jis
from compare_gan_torch import eval_utils
from compare_gan_torch.metrics import fid_score, inception_net
from compare_gan_torch.metrics import inception_score

# Eager JAX compiles op by op, which is far slower on a CPU than one
# jitted program.
_jax_features = jax.jit(jnet.inception_features)


@pytest.fixture(autouse=True)
def _no_extractor(monkeypatch):
    monkeypatch.delenv(eval_utils.INCEPTION_NPZ_ENV, raising=False)
    eval_utils.set_inception_fn(None)
    yield
    eval_utils.set_inception_fn(None)


def _weights(made_by, tmp_path):
    """Random Inception weights written to the shared .npz by one package;
    returns (path, {name: numpy array})."""
    if made_by == "jax":
        params = {k: np.asarray(v) for k, v in
                  jnet.init_random(jax.random.PRNGKey(0)).items()}
    else:
        params = inception_net.init_random(torch.Generator().manual_seed(0))
    path = str(tmp_path / f"inception_{made_by}.npz")
    np.savez(path, **params)
    return path, params


def _assert_features_close(got, want):
    # f32 through ~95 convs on two CPU backends: 1e-4 of each output's
    # largest magnitude.
    for g, w in zip(got, want):
        w = np.asarray(w)
        th.assert_close(g, w, rtol=1e-4, atol=1e-4 * float(np.abs(w).max()))


def test_param_count_and_shapes_equal_the_jax_package():
    """The 2015-12-05 graph's ~23.9M parameters
    (tests/test_inception_eval.py::test_architecture_param_count), with
    the same names and HWIO shapes."""
    port = inception_net.init_random(torch.Generator().manual_seed(0))
    ref = jnet.init_random(jax.random.PRNGKey(0))
    assert {k: v.shape for k, v in port.items()} == \
        {k: tuple(v.shape) for k, v in ref.items()}
    total = sum(int(np.prod(v.shape)) for v in port.values())
    assert total == sum(int(np.prod(v.shape)) for v in ref.values())
    assert 23_000_000 < total < 25_000_000, total
    assert port["softmax/weights"].shape == (2048, 1008)


@pytest.mark.parametrize("size", [32, 128])
def test_resize_to_299_matches_tf1_legacy_bilinear(size):
    """The JAX package's TF1 resize (legacy scaling, not half-pixel):
    1e-5 relative, on [0, 255] pixels."""
    images = np.random.RandomState(size).rand(2, size, size, 3) * 255.0
    images = images.astype(np.float32)
    got = inception_net._resize_bilinear(torch.from_numpy(images), 299)
    want = jnet._resize_bilinear(jnp.asarray(images), 299)
    assert tuple(got.shape) == (2, 299, 299, 3)
    th.assert_close(got, want, rtol=1e-5, atol=1e-5 * 255)


@pytest.mark.parametrize("made_by", ["jax", "port"])
def test_features_match_the_jax_package_on_the_shared_npz(made_by,
                                                          tmp_path):
    """Both packages load the same .npz (HWIO kernels; the port transposes
    to OIHW) and give the same pool_3 and logits for 3 images at 107 px,
    the smallest size every stride of the stack fits comfortably."""
    path, params = _weights(made_by, tmp_path)
    with np.load(path) as data:
        port = inception_net.params_from_npz(
            {k: data[k] for k in data.files}, "cpu")
    assert tuple(port["conv/conv2d_params"].shape) == (32, 3, 3, 3)
    x = np.random.RandomState(1).uniform(-1, 1, (3, 107, 107, 3))
    x = x.astype(np.float32)
    with torch.no_grad():
        got = inception_net.inception_features(port, torch.from_numpy(x))
    want = _jax_features({k: jnp.asarray(v) for k, v in params.items()},
                         jnp.asarray(x))
    assert tuple(got[0].shape) == (3, 2048) and tuple(got[1].shape) == (
        3, 1008)
    _assert_features_close(got, want)


def test_feature_fn_at_299_matches_the_jax_package(tmp_path):
    """The whole extractor, pixels in [0, 255] at 128 px -> resize to 299
    -> (x - 128) / 128 -> Inception, through each package's
    make_feature_fn on the same .npz."""
    path, _ = _weights("jax", tmp_path)
    images = np.random.RandomState(2).rand(1, 128, 128, 3) * 255.0
    got = inception_net.make_feature_fn(path, "cpu")(images)
    want = jnet.make_feature_fn(path)(images)
    _assert_features_close(got, want)


def test_feature_fn_restores_the_tf32_flags():
    old = (torch.backends.cudnn.allow_tf32,
           torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with inception_net.full_f32():
            assert not torch.backends.cudnn.allow_tf32
            assert not torch.backends.cuda.matmul.allow_tf32
        assert torch.backends.cudnn.allow_tf32
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = old


def test_extractor_resolution(tmp_path, monkeypatch):
    """Test hook first, then $COMPARE_GAN_INCEPTION_NPZ on the asked
    device (one load per file and device); with neither, the JAX
    package's RuntimeError."""
    for module in (eval_utils, jeval_utils):
        with pytest.raises(RuntimeError,
                           match="No Inception feature extractor"):
            module.get_inception_fn()
    path, _ = _weights("port", tmp_path)
    monkeypatch.setenv(eval_utils.INCEPTION_NPZ_ENV, path)
    fn = eval_utils.get_inception_fn("cpu")
    assert eval_utils.get_inception_fn("cpu") is fn
    pool, logits = eval_utils.inception_transform_np(
        np.random.RandomState(0).rand(3, 75, 75, 3) * 255, batch_size=2,
        device="cpu")
    assert pool.shape == (3, 2048) and logits.shape == (3, 1008)
    hook = lambda images: (np.zeros((len(images), 4)),  # noqa: E731
                           np.zeros((len(images), 5)))
    eval_utils.set_inception_fn(hook)
    assert eval_utils.get_inception_fn("cpu") is hook
    with pytest.raises(eval_utils.NanFoundError):
        eval_utils.inception_transform_np(np.full((1, 8, 8, 3), np.nan))


def _activations(seed, n=300, d=24):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, d) @ rng.randn(d, d) * 0.3 + rng.randn(d)).astype(
        np.float32)


def test_fid_and_is_equal_the_jax_package():
    """Same f64 host formulas on the same activations and logits: 1e-10
    relative."""
    fake, real = _activations(0), _activations(1)
    np.testing.assert_allclose(
        fid_score.compute_fid_from_activations(fake, real),
        jfid.compute_fid_from_activations(fake, real), rtol=1e-10)
    logits = _activations(2, d=10) * 3
    np.testing.assert_allclose(
        inception_score.classifier_score_from_logits(logits),
        jis.classifier_score_from_logits(logits), rtol=1e-10)


def test_tasks_equal_the_jax_package():
    """FIDScoreTask and InceptionScoreTask on EvalDataSamples, and the
    4242 sentinel (or NaN) on the same failing activations."""
    def dsets(module, acts):
        out = []
        for a in acts:
            d = module.EvalDataSample(np.zeros((len(a), 2, 2, 3)))
            d.set_data(a, a[:, :10])
            out.append(d)
        return out

    for acts in ([_activations(3), _activations(4)],
                 [np.full((10, 4), np.nan)] * 2):
        got_f, got_r = dsets(eval_utils, acts)
        want_f, want_r = dsets(jeval_utils, acts)
        for port_task, jax_task in (
                (fid_score.FIDScoreTask(), jfid.FIDScoreTask()),
                (inception_score.InceptionScoreTask(),
                 jis.InceptionScoreTask())):
            assert port_task.metric_list() == jax_task.metric_list()
            got = port_task.run_after_session(got_f, got_r)
            want = jax_task.run_after_session(want_f, want_r)
            assert got.keys() == want.keys()
            for k in got:
                np.testing.assert_allclose(got[k], want[k], rtol=1e-10)
    assert fid_score.FAILED_FID == jfid.FAILED_FID == 4242.0


def test_fid_on_device_is_within_one_percent_of_f64():
    """As tests/test_metrics.py::test_fid_on_device_matches_host holds the
    JAX version: the f32 Newton-Schulz FID within 1% of the f64 value."""
    rng = np.random.RandomState(2)
    f = rng.randn(2000, 32) + 0.3
    r = rng.randn(2000, 32) @ (np.eye(32) * 1.2)
    host = fid_score.compute_fid_from_activations(f, r)
    dev = float(fid_score.fid_on_device(f, r, device="cpu"))
    np.testing.assert_allclose(dev, host, rtol=0.01)
    np.testing.assert_allclose(dev, float(jfid.fid_on_device(f, r)),
                               rtol=0.01)
