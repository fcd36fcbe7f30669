"""The port's main-path ops against the JAX package's, on the same weights
(carried across by interop.py) and the same inputs, f32 on the CPU:
spectral norm (both modes), conv2d, up_conv2d, down_conv2d,
standardize_batch (both modes), conditional_batch_norm, layer_norm and
non_local_block (through the differentiable reference attention, the
port's CPU path, on the port's side and the Pallas kernel in interpret mode
on the JAX side)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_helpers as th

from compare_gan_tpu import config as jgin
from compare_gan_tpu import core as jcore
from compare_gan_tpu.ops import arch_ops as jops
from compare_gan_tpu.ops import pallas_attention
from compare_gan_torch import config as tgin
from compare_gan_torch import core, interop
from compare_gan_torch.ops import arch_ops as ops

# f32 convolutions and matmuls on two CPU backends (XLA, oneDNN): the same
# sums in another order, ~1e-6 relative; 1e-4 leaves room for the
# accumulation over up to 3*3*16 taps.
RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(autouse=True)
def _setup():
    tgin.clear_config()
    pallas_attention._INTERPRET = True
    yield
    pallas_attention._INTERPRET = False
    tgin.clear_config()


def _jax_run(fn, state=None, params=None):
    """(out, params, state, new_state): init, then one apply."""
    _, p, s = jcore.init(fn, jax.random.PRNGKey(0))
    p = p if params is None else params(p)
    s = s if state is None else state(s)
    out, new_s = jcore.apply(fn, p, s)
    return out, p, s, new_s


def _port(module, prefix, params, state):
    core.assign_scopes(module, prefix)
    th.load_jax(module, prefix, params, state)
    return module


@pytest.mark.parametrize("mode", ["left", "right"])
def test_spectral_norm_sigma_and_u(mode):
    """sigma and the updated u of one power iteration, on a conv kernel:
    the port flattens its OIHW kernel in HWIO order, as `u` expects."""
    w = jnp.asarray(th.randn((3, 3, 4, 6), 1))
    u0 = jnp.asarray(th.randn((36, 1) if mode == "left" else (1, 6), 2))

    def fn():
        return jops.spectral_norm_sigma(w, singular_value=mode,
                                        state_name="kernel/u_var")

    sigma, _, _, new_s = _jax_run(fn, state=lambda s: {"kernel/u_var": u0})
    tgin.bind("spectral_norm.singular_value", mode)
    conv = _port(ops.Conv2d(4, 6, 3, 3, use_sn=True, use_bias=False), "",
                 {"kernel": w}, {"kernel/u_var": u0})
    got = conv._sigma(None)
    # The power iteration is a few f32 dot products: 1e-5.
    th.assert_close(got, sigma, rtol=1e-5, atol=1e-6)
    th.assert_close(conv._buffers["kernel/u_var"], new_s["kernel/u_var"],
                    rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("op,k", [("conv2d", 3), ("conv2d", 1),
                                  ("up_conv2d", 3), ("up_conv2d", 1),
                                  ("down_conv2d", 3), ("down_conv2d", 1)])
def test_conv_ops(op, k):
    x_np = th.randn((2, 8, 8, 5), 3)
    x = jnp.asarray(x_np)
    tgin.bind("spectral_norm.singular_value", "auto")
    jgin.bind("spectral_norm.singular_value", "auto")
    if op == "conv2d":
        fn = lambda: jops.conv2d(x, 7, k, k, 1, 1, name="c",  # noqa: E731
                                 use_sn=True)
        module = ops.Conv2d(5, 7, k, k, use_sn=True)
    else:
        jfn = getattr(jops, op)
        fn = lambda: jfn(x, 7, k, k, name="c", use_sn=True)  # noqa: E731
        module = {"up_conv2d": ops.UpConv2d,
                  "down_conv2d": ops.DownConv2d}[op](5, 7, k, k, use_sn=True)
    # Nonzero bias, so the bias path is compared too.
    out, p, s, new_s = _jax_run(fn, params=lambda p: {
        **p, "c/bias": jnp.asarray(th.randn((7,), 4))})
    module = _port(module, "c", p, s)
    got = module(torch.from_numpy(x_np))
    assert tuple(got.shape) == out.shape
    th.assert_close(got, out, rtol=RTOL, atol=ATOL)
    th.assert_close(module._buffers["kernel/u_var"], new_s["c/kernel/u_var"],
                    rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("moving", [True, False])
@pytest.mark.parametrize("training", [True, False])
def test_standardize_batch(moving, training):
    x_np = th.randn((4, 3, 3, 6), 5, scale=2.0) + 0.5
    x = jnp.asarray(x_np)

    def fn():
        with jcore.scope("bn"):
            return jops.standardize_batch(
                x, is_training=training, decay=0.9, epsilon=1e-5,
                use_moving_averages=moving)

    def state(s):
        # Non-trivial stats; in accumulator mode, switch accumulation on.
        s = dict(s)
        for k, v in s.items():
            if v.dtype == jnp.int32:
                s[k] = jnp.ones_like(v)
            elif v.ndim:
                s[k] = jnp.asarray(np.abs(th.randn(v.shape, 6)) + 0.5)
        return s

    out, p, s, new_s = _jax_run(fn, state=state)
    module = _port(ops.StandardizeBatch(6, decay=0.9, epsilon=1e-5,
                                        use_moving_averages=moving),
                   "bn", p, s)
    with core.collect_tags() as tags:
        got = module(torch.from_numpy(x_np), is_training=training)
    assert (tags == {"bn/batch_coupled"}) == training
    # f32 moments over 36 values per channel: 1e-5.
    th.assert_close(got, out, rtol=1e-5, atol=1e-5)
    port_state = core.named_variables(module, "bn")[1]
    assert set(port_state) == set(new_s)
    for name, value in new_s.items():
        th.assert_close(port_state[name], value, rtol=1e-6, atol=1e-6,
                        what=name)


def test_conditional_batch_norm():
    x_np = th.randn((4, 4, 4, 8), 7)
    y_np = th.randn((4, 10), 8)
    jgin.parse_config("standardize_batch.use_moving_averages = False")
    tgin.parse_config("standardize_batch.use_moving_averages = False")

    def fn():
        return jops.conditional_batch_norm(
            jnp.asarray(x_np), jnp.asarray(y_np), is_training=True,
            use_sn=True, name="bn")

    out, p, s, new_s = _jax_run(fn)
    module = _port(ops.ConditionalBatchNorm(8, 10, use_sn=True), "bn", p, s)
    got = module(torch.from_numpy(x_np), is_training=True,
                 y=torch.from_numpy(y_np))
    th.assert_close(got, out, rtol=RTOL, atol=ATOL)
    port_state = core.named_variables(module, "bn")[1]
    for name, value in new_s.items():
        th.assert_close(port_state[name], value, rtol=1e-5, atol=1e-6,
                        what=name)


def test_non_local_block_forward_and_gradients():
    """The block with the attention on both sides (JAX: Pallas in
    interpret mode; port: its CPU path, the reference), a nonzero gate,
    and the gradient of sum(sin(out)) w.r.t. x and every parameter."""
    jgin.parse_config("attention.use_pallas = True")
    x_np = th.randn((2, 8, 8, 32), 9)

    def block(xx):
        return jops.non_local_block(xx, "non_local_block", use_sn=True)

    _, p, s = jax.jit(lambda key: jcore.init(
        lambda: block(jnp.asarray(x_np)), key))(jax.random.PRNGKey(0))
    p = {**p, "non_local_block/sigma": jnp.float32(0.7)}

    def loss(params, xx):
        out, new_s = jcore.apply(lambda: block(xx), params, s)
        return jnp.sum(jnp.sin(out)), (out, new_s)

    # Jitted: one compile instead of one per eager op.
    (_, (out, new_s)), (g_p, g_x) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(p, jnp.asarray(x_np))

    module = _port(ops.NonLocalBlock(32, use_sn=True), "non_local_block", p,
                   s)
    x = torch.tensor(x_np, requires_grad=True)
    got = module(x)
    torch.sin(got).sum().backward()
    th.assert_close(got, out, rtol=RTOL, atol=ATOL)
    th.assert_close(x.grad, g_x, rtol=1e-4, atol=1e-5)
    params, state = core.named_variables(module, "non_local_block")
    for name, param in params.items():
        # Kernel gradients sum 128 products of terms far larger than some
        # of the sums: absolute rounding error scales with the tensor's
        # magnitude, so atol is 1e-5 of its largest entry.
        want = np.asarray(g_p[name])
        th.assert_close(interop.to_jax(param.grad), want, rtol=1e-4,
                        atol=1e-5 * float(np.abs(want).max()), what=name)
    for name, value in new_s.items():
        th.assert_close(state[name], value, rtol=1e-5, atol=1e-6, what=name)


@pytest.mark.parametrize("shape", [(4, 6, 6, 5), (3, 7)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm(shape, dtype):
    """layer_norm (arch_ops.py:517-530) on non-unit gamma/beta: f32 moments
    over every non-batch axis, output in the input's type (bf16: both
    sides round one f32 result, so at most one bf16 ulp apart)."""
    x = th.randn(shape, 3, scale=2.0) + 0.5

    def fn():
        return jops.layer_norm(jnp.asarray(x, dtype), is_training=True,
                               scope="ln")

    def params(p):
        return {k: v * 1.5 + 0.25 for k, v in p.items()}

    out, p, _, _ = _jax_run(fn, params=params)
    module = _port(ops.LayerNorm(shape[-1]), "ln", p, {})
    got = module(torch.from_numpy(x).to(getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype)
    tol = 1e-5 if dtype == "float32" else 8e-3
    th.assert_close(got, out, rtol=tol, atol=tol)
