"""Fused SAGAN attention: softmax(theta @ phi^T) @ g.

Counterpart of compare_gan_tpu/ops/pallas_attention.py. On a CUDA tensor the
wrappers launch the hand-written kernels of `csrc/attention.cu` (forward:
one launch; backward: a row pass and a column pass) and raise on anything
the kernels do not take. On a CPU tensor they run the plain PyTorch versions
below, which compute what the kernels compute (same saved statistics, same
backward formula) with materialized [B, N, M] scores.

`fused_attention`, what the non-local block calls, takes the device-based
choice of the JAX package (arch_ops.py:668-706): the kernels on a card, the
differentiable `reference_attention` on the CPU. The kernels' gradient is
first order only, as the Pallas kernel's is on the TPU (its
`custom_partitioning` has no differentiation rule): asking for it with
`create_graph`, as a gradient penalty through a non-local block does, raises.

The forward is also the registered operator `compare_gan::attention_fwd`
(`attention_fwd_op`): its CUDA implementation launches the kernel, its CPU
implementation runs the plain version, and its fake implementation gives
only shapes and types. A program traced by `torch.export`
(`export.export_serving_program`) holds one node of it per non-local block,
so the device is picked, and the operands checked, when the program runs.
Importing this module registers the operator; it imports no layer code.

theta: [B, N, C]; phi: [B, M, C]; g: [B, M, Cg] -> out [B, N, Cg]. N and M
are free: in the spatial layout (`ops.arch_ops.NonLocalBlock`) each worker
passes its band's N / k queries against all M keys, and the key gradients
it returns are its band's part of theirs.
Scores, softmax and sums are f32 whatever the input type; `out` and
`dtheta` come back in the input type, `mx`/`den` ([B, N, 1]) and the raw
`dphi`/`dg` in f32, as the TPU kernels return them.
"""

from __future__ import annotations

from typing import Tuple

import torch

from compare_gan_torch.ops import _build

# Launch counts of the CUDA kernels (one per wrapper call that launched),
# so a run can show that its attention went through them.
launches_fwd = 0
launches_bwd = 0

MAX_C = 32
MAX_CG = 128


def reference_attention(theta, phi, g):
    """The unfused path (pallas_attention.py:271-277): f32 scores, softmax
    and PV product, cast back to the input type."""
    scores = torch.einsum("bnc,bmc->bnm", theta.float(), phi.float())
    attn = torch.softmax(scores, dim=-1)
    return torch.einsum("bnm,bmc->bnc", attn, g.float()).to(theta.dtype)


def attention_fwd_plain(theta, phi, g):
    """What `_fwd_kernel` computes: (out, mx, den)."""
    scores = torch.einsum("bnc,bmc->bnm", theta.float(), phi.float())
    mx = scores.amax(dim=-1, keepdim=True)
    e = torch.exp(scores - mx)
    den = e.sum(dim=-1, keepdim=True)
    out = torch.einsum("bnm,bmc->bnc", e, g.float()) / den
    return out.to(theta.dtype), mx, den


def attention_bwd_plain(theta, phi, g, dout, mx, den):
    """What `_bwd_kernel` computes: (dtheta in the input type, dphi and dg
    in f32)."""
    theta32, phi32, g32 = theta.float(), phi.float(), g.float()
    dout32 = dout.float()
    scores = torch.einsum("bnc,bmc->bnm", theta32, phi32)
    attn = torch.exp(scores - mx) / den
    dattn = torch.einsum("bnc,bmc->bnm", dout32, g32)
    row = (dattn * attn).sum(dim=-1, keepdim=True)
    dscores = attn * (dattn - row)
    dtheta = torch.einsum("bnm,bmc->bnc", dscores, phi32)
    dphi = torch.einsum("bnm,bnc->bmc", dscores, theta32)
    dg = torch.einsum("bnm,bnc->bmc", attn, dout32)
    return dtheta.to(theta.dtype), dphi, dg


def _on_cpu(*tensors) -> bool:
    devices = {t.device.type for t in tensors}
    if devices == {"cpu"}:
        return True
    if devices == {"cuda"}:
        return False
    raise ValueError(f"fused attention takes CPU or CUDA tensors, all on one "
                     f"kind of device; got {sorted(devices)}.")


def _check_operands(theta, phi, g):
    if theta.dim() != 3 or phi.dim() != 3 or g.dim() != 3:
        raise ValueError("theta, phi, g must be [B, N, C], [B, M, C], "
                         "[B, M, Cg].")
    b, n, c = theta.shape
    m, cg = g.shape[1], g.shape[2]
    if tuple(phi.shape) != (b, m, c) or g.shape[0] != b:
        raise ValueError(f"Shape mismatch: theta {tuple(theta.shape)}, phi "
                         f"{tuple(phi.shape)}, g {tuple(g.shape)}.")
    if theta.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"The CUDA attention takes float32 or bfloat16, got "
                        f"{theta.dtype}.")
    for name, t in (("phi", phi), ("g", g)):
        if t.dtype != theta.dtype:
            raise TypeError(f"{name} is {t.dtype}, theta is {theta.dtype}.")
    if not (0 < c <= MAX_C and 0 < cg <= MAX_CG and n > 0 and m > 0):
        raise ValueError(f"The CUDA attention takes 0 < C <= {MAX_C} and "
                         f"0 < Cg <= {MAX_CG}; got C={c}, Cg={cg}, N={n}, "
                         f"M={m}.")
    if b > 65535 or max(b * n * max(c, cg), b * m * max(c, cg)) >= 2 ** 31:
        raise ValueError(f"Operands too large for the kernel's indexing: "
                         f"B={b}, N={n}, M={m}.")
    for name, t in (("theta", theta), ("phi", phi), ("g", g)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous.")
    devs = {theta.device, phi.device, g.device}
    if len(devs) != 1:
        raise ValueError(f"Operands on different devices: {devs}.")
    return b, n, m, c, cg


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def attention_fwd(theta, phi, g):
    """(out, mx, den): the CUDA forward kernel on CUDA tensors, the plain
    version on CPU tensors. Both take only what the kernel takes."""
    global launches_fwd
    b, n, m, c, cg = _check_operands(theta, phi, g)
    if _on_cpu(theta, phi, g):
        return attention_fwd_plain(theta, phi, g)
    lib = _build.library()
    out = torch.empty((b, n, cg), dtype=theta.dtype, device=theta.device)
    mx = torch.empty((b, n, 1), dtype=torch.float32, device=theta.device)
    den = torch.empty((b, n, 1), dtype=torch.float32, device=theta.device)
    with torch.cuda.device(theta.device):
        rc = lib.cgt_attention_fwd(
            theta.data_ptr(), phi.data_ptr(), g.data_ptr(), out.data_ptr(),
            mx.data_ptr(), den.data_ptr(), b, n, m, c, cg,
            int(theta.dtype == torch.bfloat16), _stream(theta.device))
    _build.check(lib, rc, "attention forward kernel")
    launches_fwd += 1
    return out, mx, den


@torch.library.custom_op("compare_gan::attention_fwd", mutates_args=(),
                         device_types=("cpu", "cuda"))
def attention_fwd_op(theta: torch.Tensor, phi: torch.Tensor,
                     g: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """`attention_fwd` as a registered operator: (out, mx, den), through
    the kernel on CUDA tensors and the plain version on CPU tensors. It has
    no autograd formula: `FusedAttention` is the differentiable path."""
    return attention_fwd(theta, phi, g)


@attention_fwd_op.register_fake
def _attention_fwd_shapes(theta, phi, g):
    """out [B, N, Cg] in the input type, mx and den [B, N, 1] f32, for any
    (symbolic) B. Builds and checks nothing: tracing may run without a
    card."""
    b, n = theta.shape[0], theta.shape[1]
    return (theta.new_empty((b, n, g.shape[2])),
            theta.new_empty((b, n, 1), dtype=torch.float32),
            theta.new_empty((b, n, 1), dtype=torch.float32))


def attention_bwd(theta, phi, g, dout, mx, den):
    """(dtheta, dphi f32, dg f32): the two CUDA backward kernels on CUDA
    tensors, the plain version on CPU tensors."""
    global launches_bwd
    b, n, m, c, cg = _check_operands(theta, phi, g)
    if tuple(dout.shape) != (b, n, cg) or dout.dtype != theta.dtype \
            or not dout.is_contiguous():
        raise ValueError(f"dout must be a contiguous {theta.dtype} "
                         f"[{b}, {n}, {cg}]; got {dout.dtype} "
                         f"{tuple(dout.shape)}.")
    for name, t in (("mx", mx), ("den", den)):
        if tuple(t.shape) != (b, n, 1) or t.dtype != torch.float32 \
                or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 "
                             f"[{b}, {n}, 1].")
    if {dout.device, mx.device, den.device} != {theta.device}:
        raise ValueError("dout, mx, den must be on theta's device.")
    if _on_cpu(theta):
        return attention_bwd_plain(theta, phi, g, dout, mx, den)
    lib = _build.library()
    dtheta = torch.empty_like(theta)
    row = torch.empty((b, n), dtype=torch.float32, device=theta.device)
    dphi = torch.empty((b, m, c), dtype=torch.float32, device=theta.device)
    dg = torch.empty((b, m, cg), dtype=torch.float32, device=theta.device)
    with torch.cuda.device(theta.device):
        rc = lib.cgt_attention_bwd(
            theta.data_ptr(), phi.data_ptr(), g.data_ptr(), dout.data_ptr(),
            mx.data_ptr(), den.data_ptr(), dtheta.data_ptr(), row.data_ptr(),
            dphi.data_ptr(), dg.data_ptr(), b, n, m, c, cg,
            int(theta.dtype == torch.bfloat16), _stream(theta.device))
    _build.check(lib, rc, "attention backward kernels")
    launches_bwd += 1
    return dtheta, dphi, dg


SECOND_ORDER_ERROR = (
    "The fused attention kernel (compare_gan_torch/csrc/attention.cu) has no "
    "second-order gradient: a gradient penalty through a non-local block "
    "cannot run on the card, as it cannot on the JAX package's TPU path.")


class FusedAttention(torch.autograd.Function):
    """The custom_vjp of pallas_attention.py:246-268: saves theta, phi, g
    and the forward's row statistics; the backward casts dphi/dg (f32) back
    to the input type. Its gradient is first order only."""

    @staticmethod
    def forward(ctx, theta, phi, g):
        out, mx, den = attention_fwd(theta, phi, g)
        ctx.save_for_backward(theta, phi, g, mx, den)
        return out

    @staticmethod
    def backward(ctx, dout):
        if torch.is_grad_enabled():  # Under create_graph: a second order.
            raise RuntimeError(SECOND_ORDER_ERROR)
        theta, phi, g, mx, den = ctx.saved_tensors
        dtheta, dphi, dg = attention_bwd(theta, phi, g, dout.contiguous(),
                                         mx, den)
        return dtheta, dphi.to(phi.dtype), dg.to(g.dtype)


def fused_attention(theta, phi, g):
    """softmax(theta @ phi^T) @ g: through the kernels (`FusedAttention`)
    on CUDA tensors, through the differentiable `reference_attention` on
    CPU tensors, as the JAX package picks its einsum reference off the
    TPU. Under `torch.export` tracing, through the registered operator, so
    that the traced program picks its device when it runs."""
    if torch.compiler.is_exporting():
        return attention_fwd_op(theta, phi, g)[0]
    if _on_cpu(theta, phi, g):
        _check_operands(theta, phi, g)  # What the kernels would take.
        return reference_attention(theta, phi, g)
    return FusedAttention.apply(theta, phi, g)
