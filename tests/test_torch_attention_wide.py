"""The port's attention at the widths of the 256 and 512 px models and
past C 64, on the CPU, against the JAX package: the CUDA kernels'
algorithm with Cg cut into column chunks and C into chunks of 64
(csrc/attention.cu), and the plain versions, against the Pallas kernels in
interpret mode at (C, Cg) = (48, 192) (BigGAN-512's G block), (64, 256)
(BigGAN-deep-256/512's blocks), a ragged (40, 200), and with the attention
on the 8x8 or 16x16 maps (the SAGAN paper's feat8 / feat16 placements at
BigGAN-128's width) (192, 768) (G's block B1) and (96, 384) (D's B4, G's
B2), and a ragged (72, 200); `fused_attention` at those widths; and
BigGAN-512's and BigGAN-deep-256's G and D forwards from the same
numpy-drawn parameters, carried by interop.py. The kernels themselves are
held to the plain versions at these widths on the card
(tests/test_torch_kernels_gpu.py, chip_smoke.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_helpers as th
from tests.test_torch_attention import _split_bf16

from compare_gan_tpu import config as jgin
from compare_gan_tpu import core as jcore
from compare_gan_tpu import datasets as jdatasets
from compare_gan_tpu.architectures import DISCRIMINATORS as JDISCRIMINATORS
from compare_gan_tpu.architectures import GENERATORS as JGENERATORS
from compare_gan_tpu.ops import pallas_attention
from compare_gan_torch import config as tgin
from compare_gan_torch import core, datasets, interop
from compare_gan_torch import gans  # noqa: F401 (gin)
from compare_gan_torch.architectures import DISCRIMINATORS, GENERATORS
from compare_gan_torch.gans import consts as c
from compare_gan_torch.ops import fused_attention as fa

# (B, N, M, C, Cg): the two widths at a 16x16 map (N 256) against 64 keys,
# and a ragged width over partial tiles and chunks (N 200, M 150); past C
# 64, BigGAN-128's G block B1 on the 8x8 map (N 64, M 16: three chunks of
# C, six of Cg), (96, 384) on the 16x16 map (two of C, three of Cg), and a
# ragged C 72 (64 + 8 columns) over partial tiles and chunks.
SHAPES = {"G_B4_512": (2, 256, 64, 48, 192),
          "deep_512": (2, 256, 64, 64, 256),
          "ragged": (2, 200, 150, 40, 200),
          "G_B1_feat8": (2, 64, 16, 192, 768),
          "feat16": (2, 256, 64, 96, 384),
          "ragged_c": (2, 200, 150, 72, 200)}


@pytest.fixture(autouse=True)
def _setup():
    tgin.clear_config()
    jgin.clear_config()
    pallas_attention._INTERPRET = True
    for module in (datasets, jdatasets):
        module.set_fake_dataset(True)
    yield
    for module in (datasets, jdatasets):
        module.set_fake_dataset(False)
    pallas_attention._INTERPRET = False
    jgin.clear_config()
    tgin.clear_config()


def _chunked_algorithm(theta, phi, g, dout, mode, tile=64, step=16):
    """The CUDA kernels' algorithm in torch, on f32 tensors, with Cg in
    the column chunks of `fa.cg_chunk`: per chunk z the forward's online
    softmax over 64-key tiles (out's columns of the chunk; mx and den from
    chunk 0), the row pass's parts row_z = sum P*dP_z and dtheta_z =
    (P*dP_z).phi - row_z*(P.phi) over 16-key steps, and the column pass's
    dg columns and dphi part from dS_z = P*(dP_z - [z = 0] row) over 16-row
    steps; the parts summed in chunk order. Past C_CHUNK, C goes in chunks
    of C_CHUNK columns: every score product is the sum of the chunks'
    products (the kernels' loop over C), and dtheta and dphi are put
    together from their chunks' columns, each computed from the whole S
    (one block per chunk of C). `mode` is where the kernels round, as in
    test_torch_attention.py's `_kernel_algorithm`: "f32" nowhere, "bf16" P
    before P.g and the backward's P, P*dP and dS as hi + lo parts, "split"
    every product as four bf16 products."""
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

    c_chunks = [slice(c0, c0 + fa.C_CHUNK)
                for c0 in range(0, theta.shape[2], fa.C_CHUNK)]

    def scores(a, b):
        return sum(mm(a[..., cs], b[..., cs].transpose(1, 2))
                   for cs in c_chunks)

    def by_c_chunks(a, b):
        return torch.cat([mm(a, b[..., cs]) for cs in c_chunks], -1)

    b, n, _ = theta.shape
    m, cg = g.shape[1], g.shape[2]
    chunk = fa.cg_chunk(cg)
    outs, stats = [], None
    dtheta, row = torch.zeros_like(theta), torch.zeros(b, n, 1)
    for c0 in range(0, cg, chunk):
        gz = g[:, :, c0:c0 + chunk]
        mx = torch.full((b, n, 1), -float("inf"))
        den = torch.zeros(b, n, 1)
        acc = torch.zeros(b, n, gz.shape[2])
        for j0 in range(0, m, tile):
            s = scores(theta, phi[:, j0:j0 + tile])
            new_mx = torch.maximum(mx, s.amax(-1, keepdim=True))
            scale = torch.exp(mx - new_mx)
            p = torch.exp(s - new_mx)
            den = den * scale + p.sum(-1, keepdim=True)
            acc = acc * scale + mm(rnd(p), gz[:, j0:j0 + tile])
            mx = new_mx
        outs.append(acc / den)
        stats = stats or (mx, den)
    mx, den = stats
    parts = []
    for c0 in range(0, cg, chunk):
        gz, dz = g[:, :, c0:c0 + chunk], dout[:, :, c0:c0 + chunk]
        a_acc, b_acc = torch.zeros_like(theta), torch.zeros_like(theta)
        row_z = torch.zeros(b, n, 1)
        for k0 in range(0, m, step):
            ph = phi[:, k0:k0 + step]
            attn = torch.exp(scores(theta, ph) - mx) / den
            t = attn * mm(dz, gz[:, k0:k0 + step].transpose(1, 2))
            row_z = row_z + t.sum(-1, keepdim=True)
            a_acc = a_acc + by_c_chunks(hi_lo(t), ph)
            b_acc = b_acc + by_c_chunks(hi_lo(attn), ph)
        parts.append((a_acc - row_z * b_acc, row_z))
    for dtheta_z, row_z in parts:
        dtheta, row = dtheta + dtheta_z, row + row_z
    dphi, dgs = torch.zeros_like(phi), []
    for z, c0 in enumerate(range(0, cg, chunk)):
        gz, dz = g[:, :, c0:c0 + chunk], dout[:, :, c0:c0 + chunk]
        dphi_z, dg_z = torch.zeros_like(phi), torch.zeros_like(gz)
        for i0 in range(0, n, step):
            th_, do_ = theta[:, i0:i0 + step], dz[:, i0:i0 + step]
            attn = torch.exp(scores(th_, phi)
                             - mx[:, i0:i0 + step]) / den[:, i0:i0 + step]
            ds = attn * (mm(do_, gz.transpose(1, 2))
                         - (row[:, i0:i0 + step] if z == 0 else 0.0))
            dphi_z = dphi_z + by_c_chunks(hi_lo(ds).transpose(1, 2), th_)
            dg_z = dg_z + mm(hi_lo(attn).transpose(1, 2), do_)
        dphi, dgs = dphi + dphi_z, dgs + [dg_z]
    return (torch.cat(outs, -1), mx, den), (dtheta, dphi, torch.cat(dgs, -1))


def _inputs(shape, scale):
    b, n, m, c, cg = shape
    return (th.randn((b, n, c), 0, scale), th.randn((b, m, c), 1, scale),
            th.randn((b, m, cg), 2), th.randn((b, n, cg), 3))


def _pallas(arrays, jdtype):
    jargs = [jnp.asarray(a, jdtype) for a in arrays]
    fwd = pallas_attention._attention_fwd_pallas(*jargs[:3])
    bwd = pallas_attention._attention_bwd_pallas(*jargs, fwd[1], fwd[2])
    # The same (possibly bf16-rounded) values, in f32, for the port.
    return [torch.from_numpy(np.array(a.astype(jnp.float32)))
            for a in jargs], fwd, bwd


@pytest.mark.parametrize("name", list(SHAPES))
def test_chunk_widths_are_equal_but_the_last(name):
    """Cg = 192, 256 and 200 go in two chunks of 96, 128 and 100 columns,
    768 in six and 384 in three of 128, each within the kernels' widest GP
    of 128; C past 64 in chunks of 64: 192 in three, 96 and 72 in two."""
    c, cg = SHAPES[name][3:]
    chunk = fa.cg_chunk(cg)
    assert (chunk, -(-cg // chunk)) == {192: (96, 2), 256: (128, 2),
                                        200: (100, 2), 768: (128, 6),
                                        384: (128, 3)}[cg]
    assert chunk <= fa.CG_CHUNK
    assert -(-c // fa.C_CHUNK) == {40: 1, 48: 1, 64: 1, 72: 2, 96: 2,
                                   192: 3}[c]


@pytest.mark.parametrize("mode", ["f32", "split", "bf16"])
@pytest.mark.parametrize("name", list(SHAPES))
def test_chunked_algorithm_matches_pallas_kernels(name, mode):
    """The chunked kernels' algorithm against the Pallas forward and
    backward (interpret mode). theta and phi scaled by C**-0.25 (unit-
    normal scores), as on the card. "f32": 1e-5 forward and 1e-4
    gradients, the JAX package's own Pallas-vs-einsum tolerances; "split"
    (the f32 kernels' hi/lo products): 1e-4, their tolerance against the
    plain version on the card; "bf16" (Pallas fed the same bf16 inputs):
    out and gradients at 2e-2, the JAX package's bf16 tolerance, mx and
    den at 1e-4 (bf16 products are exact in f32)."""
    shape = SHAPES[name]
    arrays = _inputs(shape, shape[3] ** -0.25)
    t, j_fwd, j_bwd = _pallas(arrays,
                              jnp.bfloat16 if mode == "bf16" else jnp.float32)
    fwd, bwd = _chunked_algorithm(*t, mode=mode)
    if mode == "bf16":
        tols = (2e-2, 1e-4, 1e-4, 2e-2, 2e-2, 2e-2)
        fwd = (fwd[0].bfloat16(),) + fwd[1:]
        bwd = (bwd[0].bfloat16(),) + bwd[1:]
    else:
        tols = (1e-5,) * 3 + (1e-4,) * 3 if mode == "f32" else (1e-4,) * 6
    for what, got, want, tol in zip(
            ("out", "mx", "den", "dtheta", "dphi", "dg"), fwd + bwd,
            tuple(j_fwd) + tuple(j_bwd), tols):
        th.assert_close(got, want, rtol=tol, atol=tol, what=what)


@pytest.mark.parametrize("name", list(SHAPES))
def test_plain_versions_match_pallas_kernels(name):
    """The CPU path of the wrappers (the plain versions, the same ones the
    card compares its kernels with) at these widths, f32: 1e-5 forward,
    1e-4 gradients."""
    shape = SHAPES[name]
    arrays = _inputs(shape, shape[3] ** -0.25)
    t, j_fwd, j_bwd = _pallas(arrays, jnp.float32)
    fwd = fa.attention_fwd(*t[:3])
    bwd = fa.attention_bwd(*t, fwd[1], fwd[2])
    for got, want in zip(fwd, j_fwd):
        th.assert_close(got, want, rtol=1e-5, atol=1e-5)
    for got, want in zip(bwd, j_bwd):
        th.assert_close(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("name", ["G_B4_512", "deep_512", "G_B1_feat8",
                                  "feat16", "ragged_c"])
def test_fused_attention_takes_the_wide_widths(name):
    """What the non-local block calls, on CPU tensors, at (48, 192),
    (64, 256), (192, 768), (96, 384) and (72, 200): the forward and
    gradients of sum(sin(out)) against the Pallas kernel's custom_vjp
    (interpret mode); f32, 1e-5 and 1e-4."""
    b, n, m, c, cg = SHAPES[name]
    arrays = _inputs((b, n, m, c, cg), c ** -0.25)[:3]
    jargs = tuple(map(jnp.asarray, arrays))
    want = pallas_attention.fused_attention(*jargs)
    grads = jax.grad(lambda *a: jnp.sum(jnp.sin(
        pallas_attention.fused_attention(*a))), argnums=(0, 1, 2))(*jargs)
    for fn in (fa.fused_attention, fa.FusedAttention.apply):
        t = [torch.tensor(a, requires_grad=True) for a in arrays]
        out = fn(*t)
        assert tuple(out.shape) == (b, n, cg)
        th.assert_close(out, want, rtol=1e-5, atol=1e-5)
        torch.sin(out).sum().backward()
        for x, want_grad in zip(t, grads):
            th.assert_close(x.grad, want_grad, rtol=1e-4, atol=1e-5)


# The architecture part of example_configs/biggan_imagenet128.gin, ch 8,
# with the published recipes' attention placement and z_dim
# (tests/test_architectures.py); moving-average BN is not needed (training
# mode only).
RECIPE = """
weights.initializer = "orthogonal"
spectral_norm.singular_value = "auto"
standardize_batch.decay = 0.9
standardize_batch.epsilon = 1e-5
standardize_batch.use_moving_averages = False
G.batch_norm_fn = @conditional_batch_norm
G.spectral_norm = True
D.spectral_norm = True
resnet_biggan.Generator.ch = 8
resnet_biggan.Discriminator.ch = 8
resnet_biggan_deep.Generator.ch = 8
resnet_biggan_deep.Discriminator.ch = 8
"""
MODELS = {
    "biggan512": (c.RESNET_BIGGAN_ARCH, 512, 160, """
resnet_biggan.Generator.blocks_with_attention = "B4"
resnet_biggan.Discriminator.blocks_with_attention = "B3"
"""),
    "biggan_deep256": (c.RESNET_BIGGAN_DEEP_ARCH, 256, 140, ""),
}


def _numpy_parameters(module, seed):
    """Every parameter of the port module redrawn from numpy (seeded) with
    its initial mean and spread (0.1 where the init is constant, as BN's
    gammas and the attention gate), then carried to the JAX layout."""
    rng = np.random.RandomState(seed)
    params, state = (
        {k: np.array(interop.to_jax(v), copy=True) for k, v in tree.items()}
        for tree in module.jax_variables())
    for k in sorted(params):
        v = params[k]
        spread = float(v.std()) if v.size > 1 and v.std() > 0 else 0.1
        params[k] = (v.mean() + spread * rng.standard_normal(v.shape)
                     ).astype(np.float32)
    th.load_jax(module, module.name, params, state)
    return ({k: jnp.asarray(v) for k, v in params.items()},
            {k: jnp.asarray(np.array(v)) for k, v in state.items()})


@pytest.mark.parametrize("name", list(MODELS))
def test_high_resolution_forward_parity(name):
    """G at the model's resolution, batch 2, conditional, training mode,
    then D on G's images: the port against the JAX package from the same
    numpy-drawn parameters (JAX's attention through its einsum reference,
    its CPU default; the port's through `reference_attention`). f32 through
    ~20-50 conv/BN layers on two CPU backends: 1e-4 relative."""
    arch, resolution, z_dim, cfg = MODELS[name]
    jgin.parse_config(RECIPE + cfg + "attention.use_pallas = False\n")
    tgin.parse_config(RECIPE + cfg)
    shape = (resolution, resolution, 3)
    gen = GENERATORS[arch](image_shape=shape, z_dim=z_dim, num_classes=10)
    disc = DISCRIMINATORS[arch](image_shape=shape, num_classes=10)
    variables = {}
    for seed, module in enumerate((gen, disc)):
        core.assign_scopes(module, module.name)
        core.initialize(module, module.name, seed)
        variables[module.name] = _numpy_parameters(module, seed)
    for module in (gen, disc):
        assert any(k.endswith("non_local_block/sigma")
                   for k in variables[module.name][0])
    jgen = JGENERATORS[arch](image_shape=shape)
    jdisc = JDISCRIMINATORS[arch]()
    z = th.randn((2, z_dim), 7)
    y = np.eye(10, dtype=np.float32)[[2, 9]]

    def fwd(gp, gs, dp, ds, zz, yy):
        images, _ = jcore.apply(lambda: jgen(zz, yy, is_training=True),
                                gp, gs)
        (prob, logits, h), _ = jcore.apply(
            lambda: jdisc(images, yy, is_training=True), dp, ds)
        return images, logits, h

    images, logits, h = jax.jit(fwd)(*variables[gen.name],
                                      *variables[disc.name], z, y)
    t_y = torch.from_numpy(y)
    with torch.no_grad():
        t_images = gen(torch.from_numpy(z), t_y, is_training=True)
        _, t_logits, t_h = disc(t_images, t_y, is_training=True)
    assert tuple(t_images.shape) == (2,) + shape
    th.assert_close(t_images, images, rtol=1e-4, atol=1e-5, what="images")
    th.assert_close(t_h, h, rtol=1e-4, atol=1e-4, what="h")
    th.assert_close(t_logits, logits, rtol=1e-4, atol=1e-4, what="logits")
