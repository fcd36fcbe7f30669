"""Layers of the BigGAN main path, as nn.Modules with the JAX names.

Counterpart of compare_gan_tpu/ops/arch_ops.py (main-path ops only). Public
layouts follow the JAX package: activations NHWC, linear kernels [in, out],
conv kernels HWIO in checkpoints. The port stores conv kernels OIHW and runs
`F.conv2d` on an NCHW view of the NHWC activations (a channels_last tensor,
so no copy); `interop.py` transposes kernels between the two layouts.

Types follow the JAX ops exactly, by explicit casts rather than autocast:
weights are cast to the activation's type (`w.to(x.dtype)`), batch moments
and spectral-norm sums are f32, and each op returns its input's type.

Spectral norm is applied as an output scale `out / sigma`
(arch_ops.py:189-192): the kernel is never re-materialized. Its power
iteration computes the new `u` on every forward; `core.set_state` commits it
unless the caller suppressed commits.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from compare_gan_torch import config as gin
from compare_gan_torch import core
from compare_gan_torch.gans import consts
from compare_gan_torch.ops import fused_attention as attention_lib

# HWIO (JAX) -> OIHW (torch) for conv kernels.
HWIO_TO_OIHW = (3, 2, 0, 1)


# ---------------------------------------------------------------------------
# Initializers: init(shape, generator, device, dtype) -> tensor of `shape`
# ---------------------------------------------------------------------------


def normal_init(stddev=1.0):
    def init(shape, gen, device, dtype):
        return stddev * torch.randn(shape, generator=gen, device=device,
                                    dtype=dtype)
    return init


def truncated_normal_init(stddev):
    def init(shape, gen, device, dtype):
        t = torch.empty(shape, device=device, dtype=dtype)
        return torch.nn.init.trunc_normal_(t, 0.0, stddev, -2 * stddev,
                                           2 * stddev, generator=gen)
    return init


def orthogonal_init():
    """Orthogonal over (prod(shape[:-1]), shape[-1]), as
    jax.nn.initializers.orthogonal(column_axis=-1); normal for rank < 2."""
    def init(shape, gen, device, dtype):
        if len(shape) < 2:
            return torch.randn(shape, generator=gen, device=device,
                               dtype=dtype)
        flat = torch.empty((math.prod(shape[:-1]), shape[-1]), device=device,
                           dtype=dtype)
        return torch.nn.init.orthogonal_(flat, generator=gen).reshape(shape)
    return init


def glorot_normal_init():
    """jax.nn.initializers.glorot_normal: truncated normal, fan_avg."""
    def init(shape, gen, device, dtype):
        fan_in, fan_out = math.prod(shape[:-1]), shape[-1]
        # Std of a unit normal truncated to [-2, 2] is 0.87962566...
        std = math.sqrt(2.0 / (fan_in + fan_out)) / .87962566103423978
        t = torch.empty(shape, device=device, dtype=dtype)
        return torch.nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std,
                                           generator=gen)
    return init


def constant_init(value):
    return lambda shape, gen, device, dtype: torch.full(
        shape, value, device=device, dtype=dtype)


zeros_init = lambda: constant_init(0)  # noqa: E731
ones_init = lambda: constant_init(1)  # noqa: E731


@gin.configurable("weights")
def weight_initializer(initializer=consts.NORMAL_INIT, stddev=0.02):
    """Gin-selected weight init (`weights.initializer`)."""
    if initializer == consts.NORMAL_INIT:
        return normal_init(stddev)
    if initializer == consts.TRUNCATED_INIT:
        return truncated_normal_init(stddev)
    if initializer == consts.ORTHOGONAL_INIT:
        return orthogonal_init()
    raise ValueError(f"Unknown weight initializer {initializer}.")


# ---------------------------------------------------------------------------
# Spectral normalization
# ---------------------------------------------------------------------------


@gin.configurable("spectral_norm")
def spectral_norm_options(epsilon=1e-12, singular_value="left"):
    """The `spectral_norm.*` bindings (arch_ops.py:98-100), read when a
    layer is built: the mode fixes the shape of its `u` state."""
    return epsilon, singular_value


def _l2_normalize(x, epsilon):
    return x * torch.rsqrt(torch.clamp(torch.sum(x * x), min=epsilon))


def resolve_singular_value(rows, cols, singular_value):
    """"auto" -> "left" if rows <= cols else "right" (arch_ops.py:131)."""
    if singular_value == "auto":
        singular_value = "left" if rows <= cols else "right"
    if singular_value not in ("left", "right"):
        raise ValueError(f"Unknown singular_value {singular_value!r}.")
    return singular_value


def spectral_norm_sigma(w2d, u, singular_value, epsilon=1e-12,
                        compute_dtype=None):
    """One persisted power iteration (arch_ops.py:98-160), in the two-read
    form: returns (sigma, new_u). `w2d` is the kernel flattened in the JAX
    (HWIO) order to (-1, C_out); `u` is [rows, 1] in "left" mode and
    [1, C_out] in "right" mode. The matvecs run in `compute_dtype` when it
    differs from the kernel's type; u, the normalizations and sigma are f32.
    sigma is differentiable in w; u and v are not."""
    w_c = w2d if compute_dtype is None or compute_dtype == w2d.dtype \
        else w2d.to(compute_dtype)
    w_ng = w_c.detach()
    if singular_value == "left":
        v = _l2_normalize((w_ng.t() @ u.to(w_ng.dtype)).float(), epsilon)
        t = (w_c @ v.to(w_c.dtype)).float()
    else:
        v = _l2_normalize((u.to(w_ng.dtype) @ w_ng.t()).float(), epsilon)
        t = (v.to(w_c.dtype) @ w_c).float()
    new_u = _l2_normalize(t, epsilon).detach()
    return torch.sum(t * new_u), new_u


class _SNLayer(core.Module):
    """A layer whose kernel may carry spectral norm (`kernel/u_var`)."""

    def _add_kernel(self, shape, init, use_sn, device, permute=None):
        self.kernel = self.add_param("kernel", shape, init, device,
                                     permute=permute)
        self._epsilon, mode = spectral_norm_options()
        self.use_sn = use_sn
        if use_sn:
            rows = math.prod(shape[:-1])
            self._mode = resolve_singular_value(rows, shape[-1], mode)
            self.add_state("kernel/u_var", (rows, 1) if self._mode == "left"
                           else (1, shape[-1]), normal_init(1.0), device)

    def _kernel_2d(self):
        """The kernel flattened in JAX order to (-1, C_out)."""
        w = self.kernel
        if w.dim() == 4:  # OIHW -> HWIO
            w = w.permute(2, 3, 1, 0)
        return w.reshape(-1, w.shape[-1])

    def _sigma(self, compute_dtype):
        if not self.use_sn:
            return None
        u = self._buffers["kernel/u_var"]
        sigma, new_u = spectral_norm_sigma(self._kernel_2d(), u, self._mode,
                                           self._epsilon, compute_dtype)
        core.set_state(u, new_u)
        return sigma

    def _finish(self, out, sigma):
        if sigma is not None:
            out = out / sigma.to(out.dtype)
        if self.use_bias:
            out = out + self.bias.to(out.dtype)
        return out


class SpectralNormKernel(_SNLayer):
    """A bare kernel returned as `w / sigma` when spectral norm is on
    (`spectral_norm`, arch_ops.py:163-170), e.g. BigGAN D's embedding_fc.
    Its power iteration runs in the kernel's own type (f32)."""

    def __init__(self, shape, init, use_sn, device=None):
        super().__init__()
        self._add_kernel(shape, init, use_sn, device)
        self.use_bias = False

    def forward(self):
        sigma = self._sigma(None)
        return self.kernel if sigma is None else self.kernel / sigma


# ---------------------------------------------------------------------------
# Linear / conv
# ---------------------------------------------------------------------------


class Linear(_SNLayer):
    """Dense layer (arch_ops.py:178-197). x: [B, D]; kernel [D, out]."""

    def __init__(self, in_features, output_size, stddev=0.02, bias_start=0.0,
                 use_sn=False, use_bias=True, device=None):
        super().__init__()
        self._add_kernel((in_features, output_size),
                         weight_initializer(stddev=stddev), use_sn, device)
        self.use_bias = use_bias
        if use_bias:
            self.bias = self.add_param("bias", (output_size,),
                                       constant_init(bias_start), device)

    def forward(self, x):
        sigma = self._sigma(x.dtype)
        return self._finish(x @ self.kernel.to(x.dtype), sigma)


def _same_pads(size, k, stride):
    """TF "SAME" (lo, hi) padding of one spatial dim."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


class Conv2d(_SNLayer):
    """SAME conv (arch_ops.py:200-216). x: NHWC."""

    def __init__(self, in_channels, output_dim, k_h, k_w, d_h=1, d_w=1,
                 stddev=0.02, use_sn=False, use_bias=True, device=None):
        super().__init__()
        self._add_kernel((k_h, k_w, in_channels, output_dim),
                         weight_initializer(stddev=stddev), use_sn, device,
                         permute=HWIO_TO_OIHW)
        self.strides = (d_h, d_w)
        self.use_bias = use_bias
        if use_bias:
            self.bias = self.add_param("bias", (output_dim,), zeros_init(),
                                       device)

    def forward(self, x):
        sigma = self._sigma(x.dtype)
        k_h, k_w = self.kernel.shape[2:]
        (t, b), (l, r) = (_same_pads(x.shape[1], k_h, self.strides[0]),
                          _same_pads(x.shape[2], k_w, self.strides[1]))
        xc = _nchw(x)
        if (t, l) == (b, r):
            out = F.conv2d(xc, self.kernel.to(x.dtype), stride=self.strides,
                           padding=(t, l))
        else:
            out = F.conv2d(F.pad(xc, (l, r, t, b)), self.kernel.to(x.dtype),
                           stride=self.strides)
        return self._finish(_nhwc(out), sigma)


def conv1x1(in_channels, output_dim, use_sn=False, use_bias=True,
            device=None):
    return Conv2d(in_channels, output_dim, 1, 1, use_sn=use_sn,
                  use_bias=use_bias, device=device)


class UpConv2d(Conv2d):
    """conv2d(unpool(x)) with the zero-interleaving unpool of
    resnet_ops.py:31-39 (arch_ops.py:222-246). JAX runs it as an lhs-dilated
    conv with padding (k//2, k//2 + 1); the same map is a stride-2
    transposed conv with the kernel flipped and in/out swapped, padding
    k-1-k//2 and output_padding k - 2*(k//2)."""

    def forward(self, x):
        sigma = self._sigma(x.dtype)
        k_h, k_w = self.kernel.shape[2:]
        pl_h, pl_w = (k_h - 1) // 2, (k_w - 1) // 2
        w = self.kernel.to(x.dtype).transpose(0, 1).flip(2, 3)
        out = F.conv_transpose2d(
            _nchw(x), w, stride=2, padding=(k_h - 1 - pl_h, k_w - 1 - pl_w),
            output_padding=(k_h - 2 * pl_h, k_w - 2 * pl_w))
        return self._finish(_nhwc(out), sigma)


class DownConv2d(Conv2d):
    """avg_pool_2x2(conv2d(x)) as one stride-2 conv with the pool folded
    into a (k+1)x(k+1) kernel (arch_ops.py:249-275). Spectral norm applies
    to the original kernel."""

    def forward(self, x):
        sigma = self._sigma(x.dtype)
        w = self.kernel
        k_h, k_w = w.shape[2:]
        # OIHW pads are (w_lo, w_hi, h_lo, h_hi); the JAX list is
        # ((h_lo, h_hi), (w_lo, w_hi)) for the four 2x2 pool taps.
        w_eff = (F.pad(w, (0, 1, 0, 1)) + F.pad(w, (0, 1, 1, 0))
                 + F.pad(w, (1, 0, 0, 1)) + F.pad(w, (1, 0, 1, 0))) * 0.25
        pl_h, pl_w = (k_h - 1) // 2, (k_w - 1) // 2
        xc = _nchw(x)
        if (pl_h, pl_w) != (k_h - 1 - pl_h, k_w - 1 - pl_w):
            xc = F.pad(xc, (pl_w, k_w - 1 - pl_w, pl_h, k_h - 1 - pl_h))
            pl_h = pl_w = 0
        out = F.conv2d(xc, w_eff.to(x.dtype), stride=2, padding=(pl_h, pl_w))
        return self._finish(_nhwc(out), sigma)


# ---------------------------------------------------------------------------
# Batch normalization family
# ---------------------------------------------------------------------------


@gin.configurable("standardize_batch")
class StandardizeBatch(core.Module):
    """Normalize by f32 batch moments, var = E[x^2] - E[x]^2, no trainable
    scale/offset (arch_ops.py:382-446), output in the input's type.

    Moving-average mode keeps `moving_mean`/`moving_variance`; accumulator
    mode keeps `accu/accu_mean`, `accu/accu_variance`, `accu/accu_counter`
    and `accu/update_accus`, and writes nothing while training. The state
    lives on this module, so it takes the name of the layer that normalizes
    (`.../bn1/accu/accu_mean`), as in the JAX scope tree. Moments are over
    the whole batch on this process's device."""

    def __init__(self, num_channels, decay=0.999, epsilon=1e-3,
                 data_format="NHWC", use_moving_averages=True,
                 use_cross_replica_mean=None, num_batch_groups=1,
                 device=None):
        super().__init__()
        del use_cross_replica_mean
        if data_format != "NHWC":
            raise ValueError("The port is NHWC only, like the JAX package.")
        if num_batch_groups != 1:
            raise NotImplementedError(
                "standardize_batch.num_batch_groups > 1 is not ported yet.")
        self.decay = decay
        self.epsilon = epsilon
        self.use_moving_averages = use_moving_averages
        c = (num_channels,)
        if use_moving_averages:
            self.add_state("moving_mean", c, zeros_init(), device)
            self.add_state("moving_variance", c, ones_init(), device)
        else:
            self.add_state("accu/accu_mean", c, zeros_init(), device)
            self.add_state("accu/accu_variance", c, zeros_init(), device)
            self.add_state("accu/accu_counter", (), constant_init(1e-12),
                           device)
            self.add_state("accu/update_accus", (), zeros_init(), device,
                           dtype=torch.int32)

    def standardize(self, x, is_training):
        if x.dim() not in (2, 4):
            raise ValueError(f"Expected rank 2 or 4, got {x.dim()}.")
        if is_training:
            core.tag(self, "batch_coupled")
        x32 = x.float()
        dims = tuple(range(x.dim() - 1))
        mean = x32.mean(dim=dims)
        variance = (x32 * x32).mean(dim=dims) - mean * mean
        s = self._buffers
        if self.use_moving_averages:
            if is_training:
                d = self.decay
                core.set_state(s["moving_mean"],
                               s["moving_mean"] * d + mean.detach() * (1 - d))
                core.set_state(s["moving_variance"],
                               s["moving_variance"] * d
                               + variance.detach() * (1 - d))
            else:
                mean, variance = s["moving_mean"], s["moving_variance"]
        elif not is_training:
            do_update = (s["accu/update_accus"] == 1).float()
            new_mean = s["accu/accu_mean"] + do_update * mean
            new_variance = s["accu/accu_variance"] + do_update * variance
            new_counter = s["accu/accu_counter"] + do_update
            core.set_state(s["accu/accu_mean"], new_mean)
            core.set_state(s["accu/accu_variance"], new_variance)
            core.set_state(s["accu/accu_counter"], new_counter)
            mean, variance = new_mean / new_counter, new_variance / new_counter
        out = (x32 - mean) * torch.rsqrt(variance + self.epsilon)
        return out.to(x.dtype)

    def forward(self, x, is_training):
        return self.standardize(x, is_training)


@gin.configurable("batch_norm")
class BatchNorm(StandardizeBatch):
    """BN with trainable gamma/beta (arch_ops.py:454-466)."""

    def __init__(self, num_channels, center=True, scale=True, device=None):
        super().__init__(num_channels, device=device)
        self.center, self.scale = center, scale
        if scale:
            self.gamma = self.add_param("gamma", (num_channels,), ones_init(),
                                        device)
        if center:
            self.beta = self.add_param("beta", (num_channels,), zeros_init(),
                                       device)

    def forward(self, x, is_training, **unused):
        out = self.standardize(x, is_training)
        if self.scale:
            out = out * self.gamma.to(out.dtype)
        if self.center:
            out = out + self.beta.to(out.dtype)
        return out


class _Condition(core.Module):
    def __init__(self, y_dim, num_channels, center, scale, use_sn, use_bias,
                 device):
        super().__init__()
        if scale:
            self.gamma = Linear(y_dim, num_channels, use_sn=use_sn,
                                use_bias=use_bias, device=device)
        if center:
            self.beta = Linear(y_dim, num_channels, use_sn=use_sn,
                               use_bias=use_bias, device=device)


@gin.configurable("conditional_batch_norm")
class ConditionalBatchNorm(StandardizeBatch):
    """Class-conditional BN: gamma/beta = linear(y) (arch_ops.py:494-514)."""

    def __init__(self, num_channels, y_dim, use_sn, center=True, scale=True,
                 use_bias=False, device=None):
        super().__init__(num_channels, device=device)
        if y_dim is None:
            raise ValueError("You must provide y for conditional batch norm.")
        self.center, self.scale = center, scale
        self.condition = _Condition(y_dim, num_channels, center, scale,
                                    use_sn, use_bias, device)

    def forward(self, x, is_training, y=None, **unused):
        if y is None or y.dim() != 2:
            raise ValueError("Conditional batch norm needs a rank-2 y.")
        out = self.standardize(x, is_training)
        if self.scale:
            gamma = self.condition.gamma(y)
            out = out * gamma[:, None, None, :].to(out.dtype)
        if self.center:
            beta = self.condition.beta(y)
            out = out + beta[:, None, None, :].to(out.dtype)
        return out


# ---------------------------------------------------------------------------
# Self-attention (SAGAN non-local block)
# ---------------------------------------------------------------------------


def _max_pool_2x2(x):
    return _nhwc(F.max_pool2d(_nchw(x), 2))


class NonLocalBlock(core.Module):
    """SAGAN self-attention (arch_ops.py:676-711): 1x1 SN convs theta, phi,
    g; 2x2 max-pool on phi and g; softmax attention through the CUDA kernel
    (`fused_attention`); output cast back to x's type; learned gate `sigma`
    starting at 0."""

    def __init__(self, num_channels, use_sn, device=None):
        super().__init__()
        self.attn_ch = num_channels // 8
        self.g_ch = num_channels // 2
        self.conv2d_theta = conv1x1(num_channels, self.attn_ch, use_sn=use_sn,
                                    use_bias=False, device=device)
        self.conv2d_phi = conv1x1(num_channels, self.attn_ch, use_sn=use_sn,
                                  use_bias=False, device=device)
        self.conv2d_g = conv1x1(num_channels, self.g_ch, use_sn=use_sn,
                                use_bias=False, device=device)
        self.sigma = self.add_param("sigma", (), zeros_init(), device)
        self.conv2d_attn_g = conv1x1(self.g_ch, num_channels, use_sn=use_sn,
                                     use_bias=False, device=device)

    def forward(self, x):
        b, h, w, _ = x.shape
        theta = self.conv2d_theta(x).reshape(b, h * w, self.attn_ch)
        phi = _max_pool_2x2(self.conv2d_phi(x)).reshape(
            b, (h // 2) * (w // 2), self.attn_ch)
        g = _max_pool_2x2(self.conv2d_g(x)).reshape(
            b, (h // 2) * (w // 2), self.g_ch)
        attn_g = attention_lib.fused_attention(
            theta.contiguous(), phi.contiguous(), g.contiguous())
        attn_g = attn_g.reshape(b, h, w, self.g_ch).to(x.dtype)
        attn_g = self.conv2d_attn_g(attn_g)
        return x + self.sigma.to(x.dtype) * attn_g
