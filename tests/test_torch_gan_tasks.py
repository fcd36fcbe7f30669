"""The eval tasks that need G or D, against the JAX package's: the
Jacobian's conditioning (DCGAN at 28 px), D's accuracy and GILBO's
regressor, log-density, KL and one Adam step (DCGAN at 32 px), each on
the same weights (the port's, carried by interop.py) and the same z. The
port's own GILBO protocol is held in test_torch_gilbo.py."""


import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests import torch_helpers as th

from compare_gan_tpu import config as jgin
from compare_gan_tpu import core as jcore
from compare_gan_tpu import datasets as jdatasets
from compare_gan_tpu.gans import modular_gan as jmodular
from compare_gan_tpu.metrics import accuracy as jaccuracy
from compare_gan_tpu.metrics import gilbo as jgilbo
from compare_gan_tpu.metrics import jacobian_conditioning as jjacobian
from compare_gan_tpu.ops import rng as jrng
from compare_gan_torch import config as tgin
from compare_gan_torch import datasets, interop
from compare_gan_torch.gans import modular_gan
from compare_gan_torch.metrics import accuracy, gilbo, jacobian_conditioning

# dcgan_celeba64.gin's architecture settings.
DCGAN = """
G.batch_norm_fn = @batch_norm
standardize_batch.decay = 0.9
standardize_batch.epsilon = 1e-5
"""


@pytest.fixture(autouse=True)
def _setup():
    tgin.clear_config()
    jgin.clear_config()
    for module in (datasets, jdatasets):
        module.set_fake_dataset(True)
    yield
    for module in (datasets, jdatasets):
        module.set_fake_dataset(False)
    jgin.clear_config()
    tgin.clear_config()


def _gans(arch, dataset, z_dim, cfg=DCGAN):
    """(jgan, tgan, ts_j, ts_t): the two packages' GANs holding the port's
    initial weights, with BN moving moments moved off their init values."""
    jgin.parse_config(cfg)
    tgin.parse_config(cfg)
    parameters = {"architecture": arch, "z_dim": z_dim, "lambda": 1,
                  "disc_iters": 1}
    jgan = jmodular.ModularGAN(dataset=jdatasets.get_dataset(dataset),
                               parameters=parameters, model_dir="unused")
    tgan = modular_gan.ModularGAN(dataset=datasets.get_dataset(dataset),
                                  parameters=parameters, model_dir="unused",
                                  device="cpu")
    ts_t = tgan.init_state(seed=1)
    with torch.no_grad():
        for name, value in ts_t.state().items():
            if name.endswith("moving_mean"):
                value.uniform_(-0.2, 0.2)
            elif name.endswith("moving_variance"):
                value.uniform_(0.5, 1.5)
    return jgan, tgan, th.jax_train_state(jgan, ts_t), ts_t


# -- Jacobian ---------------------------------------------------------------


def test_jacobian_of_a_linear_map_is_exact():
    """f(z) = Az: every example's J is A; with A = I every log condition
    number is 0 (tests/test_metrics.py:187-215)."""
    a = np.random.RandomState(0).randn(6, 3).astype(np.float32)
    a_t = torch.from_numpy(a)
    z = torch.from_numpy(np.random.RandomState(1).randn(4, 3).astype(
        np.float32))
    jac = jacobian_conditioning.compute_jacobian(
        lambda zz: (zz @ a_t.T).reshape(len(zz), 2, 3, 1), z,
        rows_per_pass=4)
    assert jac.shape == (4, 6, 3)
    for i in range(4):
        np.testing.assert_allclose(jac[i], a, rtol=1e-6)
    ident = jacobian_conditioning.compute_jacobian(
        lambda zz: zz.reshape(len(zz), 1, 1, -1), z)
    out = jacobian_conditioning.analyze_jacobian(ident)
    np.testing.assert_allclose(
        out["metric_tensor"]["log_condition_number"], 0.0, atol=1e-4)


def test_generator_condition_number_matches_jax():
    """DCGAN at 28 px in eval mode (moving moments), z_dim 8, two examples:
    J (784 x 8 each) within 1e-4 of JAX's vmap(jacrev), the log condition
    numbers and log-determinants within 1e-4. The port's replicated batch needs G's eval
    forward to treat examples independently: G(z)[i] == G(z[i:i+1])."""
    jgan, tgan, ts_j, ts_t = _gans("dcgan_arch", "convex_polygons", 8)
    z = th.randn((2, 8), 3, scale=0.5)
    whole = tgan.sample(ts_t, z)
    for i in range(2):
        # Equal up to f32 rounding (oneDNN picks its algorithm by batch):
        # a batch-coupled norm would move them by far more.
        th.assert_close(tgan.sample(ts_t, z[i:i + 1])[0], whole[i],
                        rtol=0, atol=1e-6)

    def jax_g(zb):
        return jgan.sample(ts_j, zb)[0]

    want = jjacobian.compute_jacobian(jax_g, jnp.asarray(z))
    got = jacobian_conditioning.compute_jacobian(
        lambda zb: tgan.sample(ts_t, zb, differentiable=True),
        torch.from_numpy(z), rows_per_pass=300)
    assert got.shape == want.shape == (2, 784, 8)
    # f32 deconvs and their transposes on two CPU backends: 1e-4 of the
    # largest entry.
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())
    got_stats = jacobian_conditioning.analyze_jacobian(got)
    want_stats = jjacobian.analyze_jacobian(want)
    for which in ("metric_tensor", "mean_metric_tensor"):
        for k in ("log_condition_number", "logdet"):
            np.testing.assert_allclose(got_stats[which][k],
                                       want_stats[which][k], rtol=1e-4,
                                       atol=1e-4, err_msg=f"{which} {k}")


# -- Accuracy ---------------------------------------------------------------


def test_accuracy_matches_jax():
    """DCGAN at 32 px on fake CIFAR-10: the same train and test images,
    the same resampled train subsets (np.random.default_rng), the JAX
    package's z for every (repeat, batch); accuracies and f64 losses
    within 1e-6."""
    jgan, tgan, ts_j, ts_t = _gans("dcgan_arch", "cifar10", 8)
    test_images = jgan.dataset.load_eval_images(32)
    assert np.array_equal(test_images, tgan.dataset.load_eval_images(32))
    batch, seed = 16, 0

    def jax_z(rep, i):
        key = jax.random.fold_in(jax.random.fold_in(
            jax.random.PRNGKey(seed), rep), i)
        with jrng.rng_context(key):
            return np.asarray(jgan.z_generator([batch, 8],
                                               name="accuracy_z"))

    want = jaccuracy.AccuracyTask().run_with_gan(
        jgan, ts_j, test_images, num_repeat=2, batch_size=batch, seed=seed)
    task = accuracy.AccuracyTask()
    got = task.run_with_gan(tgan, ts_t, test_images, num_repeat=2,
                            batch_size=batch, seed=seed, draw=jax_z)
    assert set(got) == set(want) == task.metric_list()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-6,
                                   err_msg=k)
    with pytest.raises(ValueError, match="must be larger"):
        task.run_with_gan(tgan, ts_t, test_images, max_train_examples=10,
                          num_repeat=1)


# -- GILBO against the JAX package -------------------------------------------


def test_gilbo_regressor_log_density_and_kl_match_jax():
    """The regressor on carried weights, log q(z|x) and the Beta KL:
    1e-5."""
    rng = np.random.RandomState(0)
    x = rng.rand(4, 32, 32, 3).astype(np.float32)
    _, params, _ = jcore.init(lambda xx: jgilbo._regressor(xx, 8),
                              jax.random.PRNGKey(0), x)
    reg = gilbo.Regressor((32, 32, 3), 8)
    th.load_jax(reg, "", {k: np.asarray(v) for k, v in params.items()})
    (a_j, b_j), _ = jcore.apply(lambda xx: jgilbo._regressor(xx, 8),
                                params, {}, x)
    a_t, b_t = reg(torch.from_numpy(x))
    th.assert_close(a_t, a_j, rtol=1e-5, atol=1e-6)
    th.assert_close(b_t, b_j, rtol=1e-5, atol=1e-6)
    z = rng.uniform(-1, 1, (4, 8)).astype(np.float32)
    a, b = (rng.uniform(1, 5, (4, 8)).astype(np.float32) for _ in "ab")
    c, d = (rng.uniform(1, 5, (4, 8)).astype(np.float32) for _ in "cd")
    t = [torch.from_numpy(v) for v in (a, b, c, d)]
    th.assert_close(gilbo._log_qz(t[0], t[1], torch.from_numpy(z)),
                    jgilbo._log_qz(a, b, z), rtol=1e-5, atol=1e-5)
    th.assert_close(gilbo._beta_kl(*t), jgilbo._beta_kl(a, b, c, d),
                    rtol=1e-5, atol=1e-5)
    # KL(Beta(2, 2) || Beta(1, 1)) = ln 6 - 5/3; identical: 0.
    kl = gilbo._beta_kl(*(torch.tensor(v) for v in (2.0, 2.0, 1.0, 1.0)))
    assert abs(float(kl) - (np.log(6.0) - 5.0 / 3.0)) < 1e-5
    assert abs(float(gilbo._beta_kl(*(torch.tensor(v) for v in
                                      (2.5, 3.5, 2.5, 3.5))))) < 1e-6


def test_gilbo_adam_step_matches_jax():
    """One regressor step against DCGAN at 32 px: the same G weights, z,
    regressor weights and Adam (optax's, with an injected learning rate):
    the loss and the stepped regressor within 1e-5."""
    jgan, tgan, ts_j, ts_t = _gans("dcgan_arch", "cifar10", 8)
    batch, lr = 8, 4e-4
    tx = optax.inject_hyperparams(optax.adam)(learning_rate=lr)
    fwd, gen, train_step, *_ = jgilbo._make_gilbo_steps(jgan, 8, batch, tx)
    key = jax.random.PRNGKey(5)
    z = np.asarray(jax.random.uniform(key, (batch, 8), minval=-1.0,
                                      maxval=1.0))
    _, x0 = gen(ts_j, key)
    _, params, _ = jcore.init(fwd, jax.random.PRNGKey(1), x0)
    params = {k: jnp.array(v, copy=True) for k, v in params.items()}
    stepped, _, loss_j = train_step(ts_j, params, tx.init(params), key)

    g = gilbo._Gilbo(tgan, ts_t, batch, lr, seed=0, draw=lambda s, i: z)
    th.load_jax(g.regressor, "", {k: np.asarray(v)
                                  for k, v in params.items()})
    loss_t = g.train_step(0)
    th.assert_close(loss_t, loss_j, rtol=1e-5, atol=1e-5)
    got = {k: interop.to_jax(v) for k, v in g.params.items()}
    assert set(got) == set(stepped)
    # Adam's first step moves each weight by ~lr * sign(g) = 4e-4; where g
    # is rounding-sized, f32 sums in another order move a share of it.
    for k, v in stepped.items():
        th.assert_close(got[k], v, rtol=1e-5, atol=1e-5, what=k)
