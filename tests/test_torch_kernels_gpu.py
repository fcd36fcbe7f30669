"""The port's CUDA attention kernels against their plain PyTorch versions on
the card. Every test skips without a CUDA device.

This file imports neither jax nor the conftest's JAX set-up, so it runs on a
machine without JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py
"""

import pytest
import torch

from compare_gan_torch.ops import fused_attention as fa

pytestmark = pytest.mark.gpu
# One host thread: the CPU runs of the suite use several workers. (This file
# does not import tests/torch_helpers.py: `tests` is a namespace package,
# which any installed package named `tests` shadows.)
torch.set_num_threads(1)

# (B, N, M, C, Cg): the two main-path shapes at a small batch and at the G
# sub-step's batch of 16; S3GAN's D batch of 38 (16 real, 16 fake and 3
# rotations of one example each), not a multiple of 16; a ragged shape that takes the zero-padded
# instantiation with rows too narrow for cp.async; BigGAN-deep-128's width
# (C = 32, Cg = 128, one column chunk); BigGAN-512's G block (48, 192) and
# BigGAN-deep-256/512's (64, 256), two column chunks each; a ragged wide
# shape (C 40 padded to 48, Cg 200 in two chunks of 100) and the widest C
# with three ragged chunks of Cg (86, 86, 85 columns, rows too odd for
# cp.async); and one row block over fewer keys than one MMA tile. Past C
# 64, the kernels that loop over chunks of 64 columns of C: BigGAN-128's G
# block B1 with the attention on the 8x8 map (192, 768: three C chunks,
# six of Cg), C 256 (four, eight), and a ragged C 72 (64 + 8 columns, the
# last zero-padded to 16) over partial tiles and two chunks of Cg.
SHAPES = {
    "G_B4": (2, 4096, 1024, 24, 96),
    "D_B1": (2, 4096, 1024, 12, 48),
    "G_B4_b16": (16, 4096, 1024, 24, 96),
    "D_B1_b16": (16, 4096, 1024, 12, 48),
    "D_B1_s3gan": (38, 4096, 1024, 12, 48),
    "ragged": (3, 200, 70, 7, 20),
    "widest": (2, 300, 130, 32, 128),
    "G_B4_512": (2, 4096, 1024, 48, 192),
    "deep_512": (2, 4096, 1024, 64, 256),
    "ragged_wide": (2, 200, 150, 40, 200),
    "three_chunks": (2, 300, 130, 64, 257),
    "tiny": (1, 5, 3, 1, 1),
    "G_B1_feat8": (2, 64, 16, 192, 768),
    "c256": (2, 64, 16, 256, 1024),
    "ragged_c": (2, 200, 150, 72, 200),
}
# f32: the same f32 math summed in another order. bf16: both sides round
# one f32 result to bf16 (dphi/dg stay f32 but come from bf16 inputs).
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(shape, dtype, device, seed=0, scale=None):
    """theta and phi scaled by C**-0.25 unless `scale` is given, so the
    scores are unit normal: with unit-normal theta and phi the scores reach
    |s| ~ 20 at C = 24, where the f32 rounding of s alone moves
    exp(s - mx) by ~2e-5 relative on either side, beyond the 1e-4 absolute
    tolerance of the gradients."""
    b, n, m, c, cg = shape
    gen = torch.Generator(device="cpu").manual_seed(seed)
    make = lambda *s: torch.randn(*s, generator=gen)  # noqa: E731
    scale = c ** -0.25 if scale is None else scale
    return tuple(t.to(device, dtype) for t in (
        make(b, n, c) * scale, make(b, m, c) * scale, make(b, m, cg)))


def _close(got, want, tol, what):
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol,
                               msg=lambda m: f"{what}: {m}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("name", list(SHAPES))
def test_forward_matches_plain(cuda, name, dtype):
    theta, phi, g = _inputs(SHAPES[name], dtype, cuda)
    out, mx, den = fa.attention_fwd(theta, phi, g)
    torch.cuda.synchronize()
    p_out, p_mx, p_den = fa.attention_fwd_plain(theta, phi, g)
    assert out.dtype == dtype and mx.dtype == den.dtype == torch.float32
    _close(out, p_out, TOL[dtype], "out")
    _close(mx, p_mx, 1e-4, "mx")
    _close(den, p_den, 1e-4, "den")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("name", list(SHAPES))
def test_backward_matches_plain(cuda, name, dtype):
    theta, phi, g = _inputs(SHAPES[name], dtype, cuda)
    b, n, _, _, cg = SHAPES[name]
    dout = torch.randn(b, n, cg, generator=torch.Generator().manual_seed(2)
                       ).to(cuda, dtype)
    _, mx, den = fa.attention_fwd_plain(theta, phi, g)
    got = fa.attention_bwd(theta, phi, g, dout, mx, den)
    torch.cuda.synchronize()
    want = fa.attention_bwd_plain(theta, phi, g, dout, mx, den)
    for what, a, b in zip(("dtheta", "dphi", "dg"), got, want):
        _close(a, b, TOL[dtype], what)


def test_bf16_backward_matches_plain_on_peaked_attention(cuda):
    """Unit-normal theta and phi at C = 24: scores of |s| ~ 20, so most
    rows put nearly all their weight on one key and the row pass's
    dtheta = (P*dP).phi - row*(P.phi) cancels; bf16 at 2e-2 as above."""
    theta, phi, g = _inputs(SHAPES["G_B4"], torch.bfloat16, cuda, seed=4,
                            scale=1.0)
    b, n, _, _, cg = SHAPES["G_B4"]
    dout = torch.randn(b, n, cg, generator=torch.Generator().manual_seed(5)
                       ).to(cuda, torch.bfloat16)
    out, mx, den = fa.attention_fwd(theta, phi, g)
    p_out, p_mx, p_den = fa.attention_fwd_plain(theta, phi, g)
    _close(out, p_out, 2e-2, "out")
    _close(mx, p_mx, 1e-4, "mx")
    _close(den, p_den, 1e-4, "den")
    got = fa.attention_bwd(theta, phi, g, dout, mx, den)
    torch.cuda.synchronize()
    want = fa.attention_bwd_plain(theta, phi, g, dout, mx, den)
    for what, a, b in zip(("dtheta", "dphi", "dg"), got, want):
        _close(a, b, 2e-2, what)


def test_autograd_matches_reference(cuda):
    """Gradients through FusedAttention against autograd through
    reference_attention, f32, G_B4 shape."""
    theta, phi, g = (x.requires_grad_() for x in _inputs(
        SHAPES["G_B4"], torch.float32, cuda))
    before = (fa.launches_fwd, fa.launches_bwd)
    torch.sin(fa.fused_attention(theta, phi, g)).sum().backward()
    assert (fa.launches_fwd, fa.launches_bwd) == (before[0] + 1,
                                                  before[1] + 1)
    got = [x.grad.clone() for x in (theta, phi, g)]
    for x in (theta, phi, g):
        x.grad = None
    torch.sin(fa.reference_attention(theta, phi, g)).sum().backward()
    for what, a, x in zip(("dtheta", "dphi", "dg"), got, (theta, phi, g)):
        _close(a, x.grad, 1e-4, what)


@pytest.mark.parametrize("name", ["D_B1", "D_B1_s3gan"])
def test_backward_is_deterministic(cuda, name):
    """Bitwise equal gradients from two calls, at the main path's D shape
    and at S3GAN's D batch of 38 (full N and M), whose column pass takes
    more blocks than one wave."""
    theta, phi, g = _inputs(SHAPES[name], torch.bfloat16, cuda)
    out, mx, den = fa.attention_fwd(theta, phi, g)
    dout = torch.randn_like(out)
    first = fa.attention_bwd(theta, phi, g, dout, mx, den)
    second = fa.attention_bwd(theta, phi, g, dout, mx, den)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_wrapper_raises_on_cuda_inputs_it_does_not_take(cuda):
    theta, phi, g = _inputs(SHAPES["ragged"], torch.float32, cuda)
    with pytest.raises(TypeError):
        fa.attention_fwd(theta.half(), phi.half(), g.half())
    with pytest.raises(ValueError):
        fa.attention_fwd(theta, phi.cpu(), g)
    with pytest.raises(ValueError):
        fa.attention_fwd(theta[:, ::2], phi, g)
