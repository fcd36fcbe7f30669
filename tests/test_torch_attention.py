"""The port's fused attention on the CPU (plain path of the CUDA kernels)
against the JAX package's Pallas kernel in interpret mode and its einsum
reference: forward, gradients, multi-tile and bf16 cases, the wrapper's
input checks, and the CUDA kernels' tiled algorithm emulated in torch.
The CUDA kernels themselves are compared with the plain path on the card
(tests/test_torch_kernels_gpu.py, chip_smoke.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_helpers as th

from compare_gan_tpu.ops import pallas_attention
from compare_gan_torch import config as tgin
from compare_gan_torch.ops import fused_attention as fa


@pytest.fixture(autouse=True)
def _setup():
    tgin.clear_config()
    pallas_attention._INTERPRET = True
    yield
    pallas_attention._INTERPRET = False
    tgin.clear_config()


def _inputs(b=2, n=64, m=16, c=8, cg=12, seed=0):
    return (th.randn((b, n, c), seed), th.randn((b, m, c), seed + 1),
            th.randn((b, m, cg), seed + 2))


def _torch(arrays, dtype=torch.float32, grad=False):
    return [torch.tensor(a, dtype=dtype, requires_grad=grad) for a in arrays]


# f32 on both sides, same math in another order: 1e-5, the JAX package's
# own Pallas-vs-einsum tolerance (tests/test_pallas_attention.py).
@pytest.mark.parametrize("n,m", [(64, 16), (128, 32), (96, 24)])
def test_forward_matches_pallas_and_reference(n, m):
    arrays = _inputs(n=n, m=m)
    out = fa.fused_attention(*_torch(arrays))
    pallas = pallas_attention.fused_attention(*map(jnp.asarray, arrays))
    ref = pallas_attention.reference_attention(*map(jnp.asarray, arrays))
    assert tuple(out.shape) == (2, n, 12)
    th.assert_close(out, pallas, rtol=1e-5, atol=1e-5)
    th.assert_close(out, ref, rtol=1e-5, atol=1e-5)


def test_forward_statistics_match_pallas_kernel():
    """mx and den, which the backward reuses, are the TPU kernel's."""
    arrays = _inputs(n=128, m=32, seed=5)
    out, mx, den = fa.attention_fwd(*_torch(arrays))
    j_out, j_mx, j_den = pallas_attention._attention_fwd_pallas(
        *map(jnp.asarray, arrays))
    assert tuple(mx.shape) == tuple(den.shape) == (2, 128, 1)
    th.assert_close(out, j_out, rtol=1e-5, atol=1e-5)
    th.assert_close(mx, j_mx, rtol=1e-6, atol=1e-6)
    th.assert_close(den, j_den, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n,m", [(32, 8), (128, 16)])
def test_gradients_match_pallas_and_reference(n, m):
    """Gradients of sum(sin(out)); n=128 spans several TPU row tiles, so
    the Pallas side accumulates dphi/dg across its grid."""
    arrays = _inputs(n=n, m=m, seed=3)
    t = _torch(arrays, grad=True)
    torch.sin(fa.fused_attention(*t)).sum().backward()

    def loss(fn):
        return lambda a, b, c: jnp.sum(jnp.sin(fn(a, b, c)))

    jargs = tuple(map(jnp.asarray, arrays))
    g_pallas = jax.grad(loss(pallas_attention.fused_attention),
                        argnums=(0, 1, 2))(*jargs)
    g_ref = jax.grad(loss(pallas_attention.reference_attention),
                     argnums=(0, 1, 2))(*jargs)
    # f32 gradients through exp/softmax: 1e-4 relative, as the JAX
    # package's own gradient test.
    for got, want_p, want_r in zip(t, g_pallas, g_ref):
        th.assert_close(got.grad, want_p, rtol=1e-4, atol=1e-5)
        th.assert_close(got.grad, want_r, rtol=1e-4, atol=1e-5)


def test_torch_reference_matches_jax_reference():
    arrays = _inputs(n=96, m=24, seed=7)
    th.assert_close(fa.reference_attention(*_torch(arrays)),
                    pallas_attention.reference_attention(
                        *map(jnp.asarray, arrays)), rtol=1e-5, atol=1e-5)


def test_bf16_inputs():
    """bf16 in, bf16 out; the port rounds the same f32 result once, JAX
    (Pallas, interpret) likewise: 2e-2 as the JAX package's bf16 test."""
    arrays = [a.astype(np.float32) for a in _inputs(seed=9)]
    t = _torch(arrays, dtype=torch.bfloat16)
    out = fa.fused_attention(*t)
    assert out.dtype == torch.bfloat16
    jb = [jnp.asarray(a, jnp.bfloat16) for a in arrays]
    pallas = pallas_attention.fused_attention(*jb)
    th.assert_close(out, pallas, rtol=2e-2, atol=2e-2)
    # Gradients come back in the input type (dphi/dg cast from f32).
    t = _torch(arrays, dtype=torch.bfloat16, grad=True)
    fa.fused_attention(*t).float().pow(2).sum().backward()
    assert all(x.grad.dtype == torch.bfloat16 for x in t)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    theta, phi, g = _torch(_inputs())
    with pytest.raises(TypeError):
        fa.attention_fwd(theta.double(), phi.double(), g.double())
    with pytest.raises(TypeError):
        fa.attention_fwd(theta.half(), phi.half(), g.half())
    with pytest.raises(TypeError):
        fa.attention_fwd(theta, phi.bfloat16(), g)
    with pytest.raises(ValueError):
        fa.attention_fwd(theta.transpose(1, 2).contiguous().transpose(1, 2),
                         phi, g)
    with pytest.raises(ValueError):
        fa.attention_fwd(theta[:, :, :4], phi, g)
    with pytest.raises(ValueError):
        wide = torch.zeros(2, 16, fa.MAX_CG + 1)
        fa.attention_fwd(theta, phi, wide)
    out, mx, den = fa.attention_fwd(theta, phi, g)
    with pytest.raises(ValueError):
        fa.attention_bwd(theta, phi, g, out, mx.squeeze(-1), den)


def test_cpu_path_launches_no_kernel():
    before = (fa.launches_fwd, fa.launches_bwd)
    t = _torch(_inputs(), grad=True)
    fa.fused_attention(*t).sum().backward()
    assert (fa.launches_fwd, fa.launches_bwd) == before


def _kernel_algorithm(theta, phi, g, dout, tile=64, chunk=16):
    """The CUDA kernels' algorithm in torch, f32 (csrc/attention.cu): an
    online softmax over key tiles and chunks for the forward; for the
    backward a row pass forming dtheta in one sweep as
    sum(attn*dattn*phi) - row*sum(attn*phi), then a column pass over all
    rows for dphi and dg."""
    b, n, _ = theta.shape
    m = phi.shape[1]
    mx = torch.full((b, n, 1), -float("inf"))
    den = torch.zeros(b, n, 1)
    acc = torch.zeros(b, n, g.shape[2])
    for j0 in range(0, m, tile):
        for k0 in range(j0, min(j0 + tile, m), chunk):
            k1 = min(k0 + chunk, j0 + tile, m)
            s = theta @ phi[:, k0:k1].transpose(1, 2)
            new_mx = torch.maximum(mx, s.amax(-1, keepdim=True))
            scale = torch.exp(mx - new_mx)
            p = torch.exp(s - new_mx)
            den = den * scale + p.sum(-1, keepdim=True)
            acc = acc * scale + p @ g[:, k0:k1]
            mx = new_mx
    out = acc / den
    a_acc = torch.zeros_like(theta)
    b_acc = torch.zeros_like(theta)
    row = torch.zeros(b, n, 1)
    for j0 in range(0, m, tile):
        ph, gg = phi[:, j0:j0 + tile], g[:, j0:j0 + tile]
        attn = torch.exp(theta @ ph.transpose(1, 2) - mx) / den
        t = attn * (dout @ gg.transpose(1, 2))
        row = row + t.sum(-1, keepdim=True)
        a_acc = a_acc + t @ ph
        b_acc = b_acc + attn @ ph
    dtheta = a_acc - row * b_acc
    dphi = torch.zeros_like(phi)
    dg = torch.zeros_like(g)
    for i0 in range(0, n, tile):
        th_, do_ = theta[:, i0:i0 + tile], dout[:, i0:i0 + tile]
        attn = torch.exp(th_ @ phi.transpose(1, 2) - mx[:, i0:i0 + tile]) \
            / den[:, i0:i0 + tile]
        ds = attn * (do_ @ g.transpose(1, 2) - row[:, i0:i0 + tile])
        dphi = dphi + ds.transpose(1, 2) @ th_
        dg = dg + attn.transpose(1, 2) @ do_
    return (out, mx, den), (dtheta, dphi, dg)


def test_kernel_algorithm_matches_pallas_kernels():
    """The tiling of the CUDA kernels, run in torch on the CPU, against the
    Pallas forward and backward kernels (interpret mode) on ragged tiles:
    n = 200 and m = 150 leave partial tiles and chunks. f32, 1e-5 for the
    forward, 1e-4 for the gradients, as above."""
    theta, phi, g = _inputs(b=2, n=200, m=150, c=8, cg=12, seed=11)
    dout = th.randn((2, 200, 12), 12)
    fwd, bwd = _kernel_algorithm(*_torch((theta, phi, g)),
                                 torch.from_numpy(dout))
    jargs = tuple(map(jnp.asarray, (theta, phi, g)))
    j_fwd = pallas_attention._attention_fwd_pallas(*jargs)
    j_bwd = pallas_attention._attention_bwd_pallas(
        *jargs, jnp.asarray(dout), j_fwd[1], j_fwd[2])
    for got, want in zip(fwd, j_fwd):
        th.assert_close(got, want, rtol=1e-5, atol=1e-5)
    for got, want in zip(bwd, j_bwd):
        th.assert_close(got, want, rtol=1e-4, atol=1e-5)
