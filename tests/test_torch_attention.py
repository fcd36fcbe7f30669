"""The port's fused attention on the CPU against the JAX package's Pallas
kernel in interpret mode and its einsum reference: forward and gradients
of `fused_attention` (the reference on CPU tensors) and of
`FusedAttention` (the kernels' Function, on its plain CPU path),
multi-tile and bf16 cases, the wrapper's input checks, and the CUDA
kernels' tiled algorithm emulated in torch.
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
    pallas = pallas_attention.fused_attention(*map(jnp.asarray, arrays))
    ref = pallas_attention.reference_attention(*map(jnp.asarray, arrays))
    for fn in (fa.fused_attention, fa.FusedAttention.apply):
        out = fn(*_torch(arrays))
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

    def loss(fn):
        return lambda a, b, c: jnp.sum(jnp.sin(fn(a, b, c)))

    jargs = tuple(map(jnp.asarray, arrays))
    g_pallas = jax.grad(loss(pallas_attention.fused_attention),
                        argnums=(0, 1, 2))(*jargs)
    g_ref = jax.grad(loss(pallas_attention.reference_attention),
                     argnums=(0, 1, 2))(*jargs)
    # f32 gradients through exp/softmax: 1e-4 relative, as the JAX
    # package's own gradient test.
    for fn in (fa.fused_attention, fa.FusedAttention.apply):
        t = _torch(arrays, grad=True)
        torch.sin(fn(*t)).sum().backward()
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
    with pytest.raises(ValueError):  # past the kernels' 2**31 indexing
        n = 2 ** 31 // 64
        fa.attention_fwd(*(torch.empty(1, rows, 64, device="meta")
                           for rows in (n, 16, 16)))
    with pytest.raises(ValueError):  # no columns of C
        fa.attention_fwd(*(torch.zeros(1, 4, w) for w in (0, 0, 8)))
    # A C past one chunk of the kernels' C (C_CHUNK + 1, which they take
    # in two chunks) is taken, as the Pallas kernel takes any C: the CPU
    # path gives the plain forward.
    wide = _torch(_inputs(b=1, n=4, m=2, c=fa.C_CHUNK + 1, cg=8))
    for got, want in zip(fa.attention_fwd(*wide),
                         fa.attention_fwd_plain(*wide)):
        assert torch.equal(got, want)
    out, mx, den = fa.attention_fwd(theta, phi, g)
    with pytest.raises(ValueError):
        fa.attention_bwd(theta, phi, g, out, mx.squeeze(-1), den)


def test_cpu_path_launches_no_kernel():
    before = (fa.launches_fwd, fa.launches_bwd)
    t = _torch(_inputs(), grad=True)
    fa.fused_attention(*t).sum().backward()
    assert (fa.launches_fwd, fa.launches_bwd) == before


def _split_bf16(x):
    """x as bf16 hi + lo parts, both held in f32."""
    hi = x.bfloat16().float()
    return hi, (x - hi).bfloat16().float()


def _kernel_algorithm(theta, phi, g, dout, mode="f32", tile=64):
    """The CUDA kernels' algorithm in torch (csrc/attention.cu), on f32
    tensors: the forward's online softmax over 64-key tiles; the backward's
    row pass, which sweeps 64-key tiles and forms dtheta as
    (P*dP).phi - row*(P.phi); and its column pass over 64-row tiles of all
    rows for dphi and dg.

    `mode` is where the kernels round: "f32" rounds nothing; "bf16" (the
    inputs hold bf16 values) rounds P to bf16 before P.g in the forward and
    before dg = P^T.dout in the backward, as the kernels' bf16 path feeds P
    (its hi part alone) to the tensor cores there, and keeps P and P*dP
    (row pass) and dS (column pass) as bf16 hi + lo parts, whose sums
    cancel where the attention is peaked. "split" takes every product as
    four bf16 products of hi and lo parts, as the kernels' f32 path does.
    Row sums stay in f32 in every mode."""
    if mode == "split":
        def mm(a, b):
            (ah, al), (bh, bl) = _split_bf16(a), _split_bf16(b)
            return al @ bl + al @ bh + ah @ bl + ah @ bh
    else:
        mm = torch.matmul

    def rnd(x):
        return x.bfloat16().float() if mode == "bf16" else x

    def hi_lo(x):
        return sum(_split_bf16(x)) if mode == "bf16" else x

    b, n, _ = theta.shape
    m = phi.shape[1]
    mx = torch.full((b, n, 1), -float("inf"))
    den = torch.zeros(b, n, 1)
    acc = torch.zeros(b, n, g.shape[2])
    for j0 in range(0, m, tile):
        s = mm(theta, phi[:, j0:j0 + tile].transpose(1, 2))
        new_mx = torch.maximum(mx, s.amax(-1, keepdim=True))
        scale = torch.exp(mx - new_mx)
        p = torch.exp(s - new_mx)
        den = den * scale + p.sum(-1, keepdim=True)
        acc = acc * scale + mm(rnd(p), g[:, j0:j0 + tile])
        mx = new_mx
    out = acc / den
    a_acc = torch.zeros_like(theta)
    b_acc = torch.zeros_like(theta)
    row = torch.zeros(b, n, 1)
    for k0 in range(0, m, tile):
        ph, gg = phi[:, k0:k0 + tile], g[:, k0:k0 + tile]
        attn = torch.exp(mm(theta, ph.transpose(1, 2)) - mx) / den
        t = attn * mm(dout, gg.transpose(1, 2))
        row = row + t.sum(-1, keepdim=True)
        a_acc = a_acc + mm(hi_lo(t), ph)
        b_acc = b_acc + mm(hi_lo(attn), ph)
    dtheta = a_acc - row * b_acc
    dphi = torch.zeros_like(phi)
    dg = torch.zeros_like(g)
    for i0 in range(0, n, tile):
        th_, do_ = theta[:, i0:i0 + tile], dout[:, i0:i0 + tile]
        attn = torch.exp(mm(th_, phi.transpose(1, 2)) - mx[:, i0:i0 + tile]) \
            / den[:, i0:i0 + tile]
        ds = attn * (mm(do_, g.transpose(1, 2)) - row[:, i0:i0 + tile])
        dphi = dphi + mm(hi_lo(ds).transpose(1, 2), th_)
        dg = dg + mm(rnd(attn).transpose(1, 2), do_)
    return (out, mx, den), (dtheta, dphi, dg)


# (n, m, c, cg) of the algorithm's comparisons: n = 200 and m = 150 leave
# partial 64-row and 64-key tiles; then the main path's widths, BigGAN-128's
# G after B4 (24, 96) and D after B1 (12, 48), on small maps that leave
# partial tiles too.
ALGORITHM_CASES = [pytest.param(200, 150, 8, 12, id="c8_cg12"),
                   pytest.param(136, 80, 24, 96, id="G_B4_widths"),
                   pytest.param(136, 80, 12, 48, id="D_B1_widths")]


def _algorithm_vs_pallas(mode, jdtype, n, m, c, cg, scale=1.0):
    """(kernel algorithm, Pallas kernels) on the same inputs."""
    theta, phi, g = _inputs(b=2, n=n, m=m, c=c, cg=cg, seed=11)
    theta, phi = theta * scale, phi * scale
    dout = th.randn((2, n, cg), 12)
    jargs = [jnp.asarray(a, jdtype) for a in (theta, phi, g, dout)]
    # The same (possibly bf16-rounded) values on both sides, in f32.
    t = [torch.from_numpy(np.array(a.astype(jnp.float32))) for a in jargs]
    fwd, bwd = _kernel_algorithm(*t, mode=mode)
    j_fwd = pallas_attention._attention_fwd_pallas(*jargs[:3])
    j_bwd = pallas_attention._attention_bwd_pallas(*jargs, j_fwd[1],
                                                   j_fwd[2])
    return fwd, bwd, j_fwd, j_bwd


@pytest.mark.parametrize("n,m,c,cg", ALGORITHM_CASES)
def test_kernel_algorithm_matches_pallas_kernels(n, m, c, cg):
    """The tiling of the CUDA kernels, run in torch on the CPU in f32,
    against the Pallas forward and backward kernels (interpret mode). f32,
    1e-5 for the forward, 1e-4 for the gradients, as above."""
    fwd, bwd, j_fwd, j_bwd = _algorithm_vs_pallas("f32", jnp.float32, n, m,
                                                  c, cg)
    for got, want in zip(fwd, j_fwd):
        th.assert_close(got, want, rtol=1e-5, atol=1e-5)
    for got, want in zip(bwd, j_bwd):
        th.assert_close(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("n,m,c,cg", ALGORITHM_CASES)
def test_kernel_f32_split_matches_pallas_kernels(n, m, c, cg):
    """The kernels' f32 path (every product as hi/lo bf16 parts on the
    tensor cores) against the Pallas kernels in f32: 1e-4, the tolerance of
    the f32 kernels against their plain versions on the card. theta and phi
    are scaled by C**-0.25, as there, so the scores are unit normal."""
    fwd, bwd, j_fwd, j_bwd = _algorithm_vs_pallas(
        "split", jnp.float32, n, m, c, cg, scale=c ** -0.25)
    for got, want in zip(fwd + bwd, j_fwd + j_bwd):
        th.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("n,m,c,cg", ALGORITHM_CASES)
def test_kernel_bf16_rounding_matches_pallas_kernels(n, m, c, cg):
    """The kernels' bf16 path rounds P to bf16 before the forward's P.g and
    the backward's P^T.dout, and keeps P, P*dP and dS as hi + lo parts in
    the backward's other products; nothing else rounds beyond f32 sums.
    Unit-normal theta and phi (C >= 8), so the attention is peaked and the
    backward's sums cancel. Against the Pallas kernels fed the same bf16
    inputs: out and the gradients at 2e-2, the bf16 tolerance of the JAX
    package's tests; mx and den at 1e-4, since the products of bf16 inputs
    are exact in f32 and den sums the unrounded P."""
    fwd, bwd, j_fwd, j_bwd = _algorithm_vs_pallas("bf16", jnp.bfloat16, n, m,
                                                  c, cg)
    (out, mx, den), (j_out, j_mx, j_den) = fwd, j_fwd
    th.assert_close(out.bfloat16(), j_out, rtol=2e-2, atol=2e-2)
    th.assert_close(mx, j_mx, rtol=1e-4, atol=1e-4)
    th.assert_close(den, j_den, rtol=1e-4, atol=1e-4)
    dtheta, dphi, dg = bwd
    th.assert_close(dtheta.bfloat16(), j_bwd[0], rtol=2e-2, atol=2e-2)
    th.assert_close(dphi, j_bwd[1], rtol=2e-2, atol=2e-2)
    th.assert_close(dg, j_bwd[2], rtol=2e-2, atol=2e-2)
