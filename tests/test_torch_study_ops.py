"""The port's ops of the study architectures against the JAX package's, on
the same weights (carried across by interop.py) and the same inputs, f32 on
the CPU: deconv2d (TF's output_shape rule, odd and even sizes, with and
without spectral norm), lrelu, self-modulated, rank-2 and no batch norm;
and the second-order gradient through the non-local block, which the
gradient penalties take, against the JAX package's reference attention."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_helpers as th

from compare_gan_tpu import config as jgin
from compare_gan_tpu import core as jcore
from compare_gan_tpu.ops import arch_ops as jops
from compare_gan_torch import config as tgin
from compare_gan_torch import core, interop
from compare_gan_torch.ops import arch_ops as ops
from compare_gan_torch.ops import fused_attention as fa

# f32 convolutions and matmuls on two CPU backends (XLA, oneDNN): the same
# sums in another order, ~1e-6 relative; 1e-5 as the other ops' tests
# target, on outputs of order one.
TOL = 1e-5


@pytest.fixture(autouse=True)
def _setup():
    tgin.clear_config()
    jgin.clear_config()
    yield
    jgin.clear_config()
    tgin.clear_config()


def _jax_run(fn, params=None):
    """(out, params, state, new_state): init, then one apply."""
    _, p, s = jcore.init(fn, jax.random.PRNGKey(0))
    p = p if params is None else params(p)
    out, new_s = jcore.apply(fn, p, s)
    return out, p, s, new_s


def _port(module, prefix, params, state):
    core.assign_scopes(module, prefix)
    th.load_jax(module, prefix, params, state)
    return module


@pytest.mark.parametrize("use_sn", [False, True])
@pytest.mark.parametrize("k", [3, 4, 5])
@pytest.mark.parametrize("stride,in_size,out_size", [
    (2, 4, 7), (2, 7, 14), (2, 8, 16), (1, 7, 7), (1, 8, 8)])
def test_deconv2d(stride, in_size, out_size, k, use_sn):
    """Output, the gradients w.r.t. x and the kernel, and the SN u: 4 -> 7
    at stride 2 is DCGAN's 28 px schedule (an asymmetric SAME preimage),
    k 4 at stride 2 is InfoGAN's and SNDCGAN's, k 3 at stride 1
    SNDCGAN's last layer."""
    x_np = th.randn((2, in_size, in_size, 5), 1)
    out_hw = (out_size, out_size)
    tgin.bind("spectral_norm.singular_value", "auto")
    jgin.bind("spectral_norm.singular_value", "auto")
    w_np = th.randn((k, k, 3, 5), 2, scale=0.3)

    def fn(xx):
        return jops.deconv2d(xx, [2, out_hw[0], out_hw[1], 3], k, k,
                             stride, stride, name="dc", use_sn=use_sn)

    def params(p):
        return {"dc/kernel": jnp.asarray(w_np),
                "dc/bias": jnp.asarray(th.randn((3,), 3))}

    x = jnp.asarray(x_np)
    out, p, s, new_s = _jax_run(lambda: fn(x), params=params)

    def loss(pp, xx):
        o, _ = jcore.apply(lambda: fn(xx), pp, s)
        return jnp.sum(jnp.sin(o))

    g_p, g_x = jax.grad(loss, argnums=(0, 1))(p, x)

    module = _port(ops.Deconv2d(5, 3, k, k, stride, stride, use_sn=use_sn),
                   "dc", p, s)
    # The IOHW kernel conv_transpose2d takes, from the HWOI one.
    assert tuple(module.kernel.shape) == (5, 3, k, k)
    xt = torch.tensor(x_np, requires_grad=True)
    got = module(xt, out_hw)
    assert tuple(got.shape) == out.shape == (2,) + out_hw + (3,)
    th.assert_close(got, out, rtol=TOL, atol=TOL)
    torch.sin(got).sum().backward()
    th.assert_close(xt.grad, g_x, rtol=1e-4, atol=TOL)
    th.assert_close(interop.to_jax(module.kernel.grad), g_p["dc/kernel"],
                    rtol=1e-4, atol=TOL)
    if use_sn:
        th.assert_close(module._buffers["kernel/u_var"],
                        new_s["dc/kernel/u_var"], rtol=TOL, atol=1e-6)


def test_deconv2d_refuses_a_size_that_is_no_preimage():
    with pytest.raises(ValueError, match="not a stride-2 SAME preimage"):
        ops.Deconv2d(5, 3, 4, 4, 2, 2)(torch.zeros(1, 4, 4, 5), (9, 8))


def test_lrelu_value_and_gradient_at_ties():
    """max(x, leak*x) as jnp.maximum, whose gradient at x = 0 is split
    between the two sides (0.5 + 0.5 * leak); F.leaky_relu's is not."""
    x_np = np.array([-2.0, -0.0, 0.0, 1e-30, 3.0], np.float32)
    for leak in (0.2, 0.1):
        x = torch.tensor(x_np, requires_grad=True)
        ops.lrelu(x, leak).sum().backward()
        want = jax.grad(lambda v: jnp.sum(jops.lrelu(v, leak)))(
            jnp.asarray(x_np))
        th.assert_close(ops.lrelu(x, leak), jops.lrelu(jnp.asarray(x_np),
                                                       leak), 0, 0)
        th.assert_close(x.grad, want, 0, 0)
    assert x.grad[2].item() == pytest.approx(0.55)


@pytest.mark.parametrize("num_hidden", [32, 0])
@pytest.mark.parametrize("training", [True, False])
def test_self_modulated_batch_norm(num_hidden, training):
    """gamma/beta = MLP(z) under `sbn/` (arch_ops.py:469-491), spectral
    norm on its layers, moving averages committed in training."""
    x_np = th.randn((4, 3, 3, 6), 4, scale=2.0) + 0.5
    z_np = th.randn((4, 10), 5)
    tgin.bind("spectral_norm.singular_value", "auto")
    jgin.bind("spectral_norm.singular_value", "auto")

    def fn():
        return jops.self_modulated_batch_norm(
            jnp.asarray(x_np), jnp.asarray(z_np), is_training=training,
            use_sn=True, name="bn", num_hidden=num_hidden)

    out, p, s, new_s = _jax_run(fn, params=lambda p: {
        k: v + 0.1 * jnp.asarray(th.randn(v.shape, 6)) for k, v in p.items()})
    module = _port(ops.SelfModulatedBatchNorm(6, 10, use_sn=True,
                                              num_hidden=num_hidden),
                   "bn", p, s)
    got = module(torch.from_numpy(x_np), is_training=training,
                 z=torch.from_numpy(z_np))
    th.assert_close(got, out, rtol=1e-4, atol=TOL)
    port_state = core.named_variables(module, "bn")[1]
    assert set(port_state) == set(new_s)
    for name, value in new_s.items():
        th.assert_close(port_state[name], value, rtol=TOL, atol=1e-6,
                        what=name)
    with pytest.raises(ValueError, match="provide z"):
        ops.SelfModulatedBatchNorm(6, None, use_sn=False)


@pytest.mark.parametrize("training", [True, False])
def test_batch_norm_on_rank_2(training):
    """batch_norm on [B, C] (InfoGAN's and SNDCGAN's linear outputs): the
    moments over the batch, as the JAX package's reshape to [B, 1, 1, C]
    takes them."""
    x_np = th.randn((5, 7), 7, scale=3.0) - 1.0

    def fn():
        return jops.batch_norm(jnp.asarray(x_np), is_training=training,
                               name="bn")

    out, p, s, new_s = _jax_run(fn, params=lambda p: {
        k: v * 1.5 + 0.25 for k, v in p.items()})
    module = _port(ops.BatchNorm(7), "bn", p, s)
    got = module(torch.from_numpy(x_np), is_training=training)
    assert tuple(got.shape) == (5, 7)
    th.assert_close(got, out, rtol=TOL, atol=TOL)
    port_state = core.named_variables(module, "bn")[1]
    for name, value in new_s.items():
        th.assert_close(port_state[name], value, rtol=1e-6, atol=1e-6,
                        what=name)


def test_no_batch_norm():
    x = torch.from_numpy(th.randn((2, 3, 3, 4), 8))
    module = ops.NoBatchNorm(num_channels=4, y_dim=None)
    assert module(x, is_training=True, y=None) is x
    assert not list(module.parameters()) and not list(module.buffers())
    th.assert_close(module(x), jops.no_batch_norm(jnp.asarray(x.numpy())),
                    0, 0)


def test_second_order_through_the_non_local_block():
    """d/d(params) of ||d sum(sin(out))/dx||^2 through the block (the
    second order a gradient penalty takes) against the JAX package's block
    on its reference attention, as it runs off the TPU. The port's CPU path
    is the differentiable reference; a Function with the kernels' saved row
    statistics gave dtheta off by more than its largest entry."""
    jgin.parse_config("attention.use_pallas = False")
    x_np = th.randn((2, 8, 8, 16), 9)

    def block(xx):
        return jops.non_local_block(xx, "non_local_block", use_sn=True)

    _, p, s = jax.jit(lambda key: jcore.init(
        lambda: block(jnp.asarray(x_np)), key))(jax.random.PRNGKey(0))
    p = {**p, "non_local_block/sigma": jnp.float32(0.7)}

    def penalty(params, xx):
        def out_sum(v):
            return jnp.sum(jnp.sin(jcore.apply(lambda: block(v), params,
                                               s)[0]))
        g = jax.grad(out_sum)(xx)
        return jnp.sum(jnp.square(g))

    value, g_p = jax.jit(jax.value_and_grad(penalty))(p, jnp.asarray(x_np))

    module = _port(ops.NonLocalBlock(16, use_sn=True), "non_local_block", p,
                   s)
    x = torch.tensor(x_np, requires_grad=True)
    with core.no_state_updates():
        g, = torch.autograd.grad(torch.sin(module(x)).sum(), x,
                                 create_graph=True)
    got = g.square().sum()
    got.backward()
    # Second-order f32 gradients through softmax and two 1x1 convs: 1e-4
    # relative, and 1e-5 of each tensor's largest entry.
    th.assert_close(got, value, rtol=1e-4, atol=1e-5)
    params, _ = core.named_variables(module, "non_local_block")
    for name, param in params.items():
        want = np.asarray(g_p[name])
        th.assert_close(interop.to_jax(param.grad), want, rtol=1e-4,
                        atol=1e-5 * float(np.abs(want).max()), what=name)


def test_second_order_through_the_kernel_function_raises():
    """FusedAttention, what a CUDA tensor goes through, has a first-order
    gradient only: asking for its gradient with create_graph, as a gradient
    penalty does, raises an error that names the attention (held here on
    its CPU path)."""
    theta = torch.tensor(th.randn((2, 16, 4), 10), requires_grad=True)
    phi = torch.tensor(th.randn((2, 4, 4), 11), requires_grad=True)
    g = torch.tensor(th.randn((2, 4, 8), 12), requires_grad=True)
    out = fa.FusedAttention.apply(theta, phi, g)
    with pytest.raises(RuntimeError, match="fused attention kernel"):
        torch.autograd.grad(out.square().sum(), theta, create_graph=True)
    # First order is untouched.
    out = fa.FusedAttention.apply(theta, phi, g)
    want, = torch.autograd.grad(fa.reference_attention(theta, phi, g).sum(),
                                theta)
    got, = torch.autograd.grad(out.sum(), theta)
    th.assert_close(got, want, rtol=1e-5, atol=1e-6)
