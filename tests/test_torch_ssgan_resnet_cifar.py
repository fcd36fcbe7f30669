"""SSGAN's gradients on ResNet-CIFAR-32 at its published widths (G 256,
D 128 channels) against `jax.grad` of the JAX package, f32 on the CPU, for
each self-supervision mode, conditional and not.

Both packages start from the JAX init_state (converted by interop.py), take
the same batches and the same z / sampled labels (JAX's draws handed to the
port), and take two full train steps through `make_train_step` with a
test-local optimizer on both sides: plain SGD that keeps the gradients it
was given. The gradients of the D and the G sub-step of each step, the
losses, and the parameters, SN u vectors and BN moments after each step
are compared.

SGD rather than the configs' Adam: Adam's first update is ~lr * sign(g),
so a gradient entry that is rounding noise on both sides becomes a
parameter difference of the order of lr; under SGD it moves its parameter
by lr times the noise. The Adam steps of both classes are held to the JAX
package in tests/test_torch_ssgan_s3gan.py.

Tolerances. D's gradients: 1e-4 of each leaf's norm. G's: 3e-2 of each
leaf's norm. G's gradient reaches G through D's gradient with respect to
its input, and a ReLU whose input lies within f32 rounding of zero is
decided one way on one side and the other way on the other. In one G
sub-step from the JAX init_state (mode "none", unconditional), the port's
f32 and f64 forwards differ in the sign of 1 of the 65,536 inputs of D
B4's first ReLU (1.4e-7 against a typical 0.3). That one unit moves the
gradient at B4's input by 3.4e-3 of its norm and the gradient at D's input
by 5.2e-3, and G's backward carries it to 3.5e-3 of G's leaves, while the
JAX package's f32 gradient lies within 5e-6 of the port's f64. Over the
six cases here G's leaves differ by up to 1.2e-2. Fakes rotated the wrong
way round (rot90 by 3, 2, 1 quarter turns) move them by 4e-2 at step 1 of
"rotation_gan", and c_fake_loss by 1e-3, beyond the losses' 1e-4. D's own
gradients sum over the rows, where one unit weighs less: they agree to
7e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests import torch_helpers as th

from compare_gan_tpu import config as jgin
from compare_gan_tpu import datasets as jdatasets
from compare_gan_tpu.gans import ssgan as jssgan
from compare_gan_torch import config as tgin
from compare_gan_torch import datasets, interop
from compare_gan_torch.gans import ssgan

LR = 0.05
# ssgan32_polygons_oriented.gin's GAN and architecture options.
CFG = """
loss.fn = @hinge
penalty.fn = @no_penalty
weights.initializer = "orthogonal"
spectral_norm.singular_value = "auto"
standardize_batch.decay = 0.9
standardize_batch.epsilon = 1e-5
z.distribution_fn = @tf.random.normal
D.spectral_norm = True
"""
VARIANTS = {
    "unconditional": """
G.batch_norm_fn = @batch_norm
""",
    "conditional": """
G.batch_norm_fn = @conditional_batch_norm
resnet_cifar.Generator.hierarchical_z = True
resnet_cifar.Generator.embed_z = True
resnet_cifar.Generator.embed_y = True
resnet_cifar.Discriminator.project_y = True
""",
    # D's layer norm and the unfused scale convs (unpool + conv in G,
    # conv + avg_pool in D) on the config's unconditional model.
    "layer_norm_unfused": """
G.batch_norm_fn = @batch_norm
D.layer_norm = True
resnet_ops.fused_scale_convs = False
""",
}


@pytest.fixture(autouse=True)
def _setup():
    tgin.clear_config()
    jdatasets.set_fake_dataset(True)
    datasets.set_fake_dataset(True)
    yield
    datasets.set_fake_dataset(False)
    jdatasets.set_fake_dataset(False)
    tgin.clear_config()


def _jax_sgd(lr):
    """optax SGD whose state is the last gradients it was given."""
    return optax.GradientTransformation(
        lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
        lambda grads, state, params=None: (
            jax.tree_util.tree_map(lambda g: -lr * g, grads), grads))


class _PortSGD:
    """The port's counterpart: p -= lr * g in place, keeping g."""

    def __init__(self, lr):
        self.lr = lr
        self.grads = None

    def init(self, params):
        return None

    @torch.no_grad()
    def step(self, params, grads, state):
        self.grads = {k: g.detach().clone() for k, g in grads.items()}
        for k, p in params.items():
            p.sub_(grads[k], alpha=self.lr)


def _assert_grads_close(got, want, what, rtol):
    """Each leaf within `rtol` of its own norm, ||g_port - g_jax|| <= rtol
    ||g_jax||. A leaf whose exact gradient is zero (a bias that feeds a
    batch norm) holds rounding noise on both sides, within 1e-6 of the
    sub-step's largest entry; one that no loss reads is exactly zero on
    both."""
    assert set(got) == set(want), what
    scale = max(float(np.abs(np.asarray(v)).max()) for v in want.values())
    bad = []
    for name, g in got.items():
        g, w = interop.to_jax(g), np.asarray(want[name])
        if name in th.G_BN_FED_BIASES:
            if max(np.abs(g).max(), np.abs(w).max()) > 1e-6 * scale:
                bad.append(name)
        elif not w.any():
            if g.any():
                bad.append(name)
        else:
            err = np.linalg.norm(g - w) / np.linalg.norm(w)
            if err > rtol:
                bad.append(f"{name} ({err:.2e})")
    assert not bad, f"{what}: {bad}"


def _assert_moved_alike(got, want, start, what):
    """G's gradient tolerance (3e-2) on the distance a G variable moved
    from the common start."""
    moved = np.asarray(want) - np.asarray(start)
    err = np.linalg.norm(np.asarray(got) - want) / np.linalg.norm(moved)
    assert err <= 3e-2, f"{what}: {err:.2e} of the distance moved"


@pytest.mark.parametrize("self_supervision,variant", [
    (mode, variant) for variant in ("unconditional", "conditional")
    for mode in ("rotation_gan", "rotation_only", "none")] + [
    ("rotation_gan", "layer_norm_unfused")])
def test_ssgan_gradients_match_jax_on_resnet_cifar(self_supervision,
                                                   variant):
    """Batch 4 per sub-step with 8 rotated examples (2 per rotation): D
    sees 2 * (4 + 6) = 20 rows; disc_iters 1, so the optimizer state after
    a step holds that step's only D gradients."""
    cfg = CFG + VARIANTS[variant]
    conditional = variant == "conditional"
    jgin.parse_config(cfg)
    tgin.parse_config(cfg)
    params = {"architecture": "resnet_cifar_arch", "z_dim": 16, "lambda": 1,
              "disc_iters": 1}
    kwargs = dict(parameters=params, model_dir="unused",
                  conditional=conditional, self_supervision=self_supervision,
                  rotated_batch_size=8, g_optimizer_fn=_jax_sgd, g_lr=LR)
    jgan = jssgan.SSGAN(dataset=jdatasets.get_dataset("cifar10"), **kwargs)
    g_sgd, d_sgd = _PortSGD(LR), _PortSGD(LR)
    kwargs.update(g_optimizer_fn=lambda lr: g_sgd,
                  d_optimizer_fn=lambda lr: d_sgd)
    tgan = ssgan.SSGAN(dataset=datasets.get_dataset("cifar10"),
                       device="cpu", **kwargs)

    batch_size = 4
    ts_j = jax.jit(lambda key: jgan.init_state(key, batch_size))(
        jax.random.PRNGKey(0))
    ts_t = tgan.init_state(seed=1)
    interop.load_state_dict(ts_t, interop.params_from_jax(
        ts_j.params, ts_j.state, ts_j.ema_params))
    init = {**ts_j.params, **ts_j.state}
    step_j = jax.jit(jgan.make_train_step(batch_size))
    step_t = tgan.make_train_step(batch_size)
    for step in (1, 2):
        rng = np.random.RandomState(step)
        batch = {"images": rng.rand(2 * batch_size, 32, 32, 3).astype(
                     np.float32),
                 "labels": rng.randint(0, 10, 2 * batch_size).astype(
                     np.int32)}
        draws = th.jax_draws(jgan, ts_j, batch["labels"], batch_size)
        params_before = dict(ts_j.params)
        ts_j, metrics_j = step_j(ts_j, batch)
        ts_t, metrics_t = step_t(ts_t, batch, draws=draws)

        # Losses: f32 forwards of ~20 layers on two CPU backends, 1e-4.
        assert set(metrics_t) == set(metrics_j)
        for k in metrics_j:
            th.assert_close(metrics_t[k], metrics_j[k], rtol=1e-4,
                            atol=1e-5, what=f"step {step} {k}")
        _assert_grads_close(d_sgd.grads, ts_j.d_opt, f"step {step} D",
                            rtol=1e-4)
        _assert_grads_close(g_sgd.grads, ts_j.g_opt, f"step {step} G",
                            rtol=3e-2)
        # Most parameters moved, and both packages moved them alike.
        params_t, state_t, _ = interop.params_to_jax(
            interop.state_dict(ts_t))
        assert set(params_t) == set(ts_j.params)
        moved = sum(not np.array_equal(params_before[k], ts_j.params[k])
                    for k in ts_j.params)
        assert moved > len(ts_j.params) // 2
        for name, want in ts_j.params.items():
            if name.startswith("generator/") and \
                    name not in th.G_BN_FED_BIASES:
                _assert_moved_alike(params_t[name], want, init[name],
                                    f"step {step} {name}")
            else:
                th.assert_close(params_t[name], want, rtol=1e-4, atol=1e-5,
                                what=f"step {step} {name}")
        # SN u vectors: unit vectors from a power iteration, 1e-4. G's BN
        # moving moments follow G's parameters.
        assert set(state_t) == set(ts_j.state)
        for name, want in ts_j.state.items():
            if name.startswith("generator/") and "/moving_" in name:
                _assert_moved_alike(state_t[name], want, init[name],
                                    f"step {step} {name}")
            else:
                th.assert_close(state_t[name], want, rtol=1e-4, atol=1e-5,
                                what=f"step {step} {name}")
    if self_supervision == "none":  # The rotation head is read by no loss.
        assert not any(np.asarray(g).any() for k, g in ts_j.d_opt.items()
                       if k.startswith("discriminator_rotation"))
