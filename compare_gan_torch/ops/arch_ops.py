"""Layers of the ported architectures, as nn.Modules with the JAX names.

Counterpart of compare_gan_tpu/ops/arch_ops.py. Public
layouts follow the JAX package: activations NHWC, linear kernels [in, out],
conv kernels HWIO and transposed-conv kernels HWOI in checkpoints. The port
stores conv kernels OIHW and transposed-conv kernels IOHW (both the JAX
kernel permuted by `HWIO_TO_OIHW`) and runs `F.conv2d` /
`F.conv_transpose2d` on an NCHW view of the NHWC activations (a
channels_last tensor, so no copy); `interop.py` transposes kernels between
the two layouts.

Types follow the JAX ops exactly, by explicit casts rather than autocast:
weights are cast to the activation's type (`w.to(x.dtype)`), batch moments
and spectral-norm sums are f32, and each op returns its input's type.

Spectral norm is applied as an output scale `out / sigma`
(arch_ops.py:189-192): the kernel is never re-materialized. Its power
iteration computes the new `u` on every forward; `core.set_state` commits it
unless the caller suppressed commits.

Batch norm takes its moments over the global batch: inside a data-parallel
step (`parallel.mesh_utils.active()`) from one all-reduce across the
workers, which carries the gradient, so every worker normalizes and updates
its moving moments alike. EvoNorm-S0 and the weight-norm layers read no
batch statistics in training, and start no collective.

In the spatial layout (`tpu_ops.spatial()`) an activation is this worker's
band of image rows. The convs pad each band with halo rows of the
neighbouring bands (`tpu_ops.exchange_halos`), zeros only at the image's
top and bottom, so every band starts on a stride boundary and its output
is the band of the whole image's; batch norm's moments run over the
whole grid as they do over the workers; pooling stays local; the
non-local block attends from its own rows to the keys of every band. A
height that does not split so raises, naming the layer. Layer norm and
EvoNorm, whose moments are per image, raise there.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from compare_gan_torch import config as gin
from compare_gan_torch import core
from compare_gan_torch.gans import consts
from compare_gan_torch.ops import fused_attention as attention_lib
from compare_gan_torch.parallel import mesh_utils, tpu_ops

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
    """Dense layer (arch_ops.py:178-197). x: [B, D]; kernel [D, out].
    `of_bands` takes the flattened features of a whole image from bands."""

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

    def of_bands(self, x):
        """self(x.reshape(B, -1)) for NHWC `x`. In the spatial layout `x`
        is a band, whose flattened features meet one block of the kernel's
        rows: the partial products are summed over the model group."""
        flat = x.reshape(x.shape[0], -1)
        replicas = tpu_ops.spatial()
        if replicas is None:
            return self(flat)
        sigma = self._sigma(flat.dtype)
        n = flat.shape[1]
        kernel = self.kernel[replicas.model_rank * n:
                             (replicas.model_rank + 1) * n]
        return self._finish(tpu_ops.model_sum(flat @ kernel.to(flat.dtype)),
                            sigma)


def _same_pads(size, k, stride):
    """TF "SAME" (lo, hi) padding of one spatial dim."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


def _conv_rows(x, w, strides, pads_h, pads_w, what):
    """Conv of NHWC `x` with an OIHW kernel and (top, bottom), (left,
    right) zero pads, NHWC out. In the spatial layout the band's pads in
    height are halo rows of its neighbours: with a band that starts on a
    stride boundary and the whole image's SAME pads as halo widths, the
    output is the band of the whole image's output."""
    (t, b), (l, r) = pads_h, pads_w
    if tpu_ops.spatial() is not None:
        if x.shape[1] % strides[0]:
            raise ValueError(f"{what}: a band of {x.shape[1]} rows does not "
                             f"start every band on a stride-{strides[0]} "
                             f"row.")
        x = tpu_ops.exchange_halos(x, t, b, what)
        t = b = 0
    xc = _nchw(x)
    if (t, l) == (b, r):
        out = F.conv2d(xc, w, stride=strides, padding=(t, l))
    else:
        out = F.conv2d(F.pad(xc, (l, r, t, b)), w, stride=strides)
    return _nhwc(out)


def _conv2d_same(x, w, strides, what="conv2d"):
    """TF "SAME" conv of NHWC `x` with an OIHW kernel, NHWC out."""
    k_h, k_w = w.shape[2:]
    return _conv_rows(x, w, strides,
                      _same_pads(tpu_ops.image_rows(x), k_h, strides[0]),
                      _same_pads(x.shape[2], k_w, strides[1]), what)


def _transposed_rows(x, w, strides, padding, output_padding, out_size,
                     what):
    """F.conv_transpose2d of NHWC `x` with an IOHW kernel, cropped to
    `out_size` (H, W) of the whole image, NHWC out. In the spatial layout
    the output band of a band of h rows is h * stride rows of global
    output row o = stride * i + tap - padding[0]: it reads the input rows
    (k - 1 - padding[0]) // stride above the band and (padding[0] - 1) //
    stride + 1 below, and is cut from the output of the band with those
    halos, uncropped and extended by stride - 1 rows (a 1x1 kernel's last
    row, which no input row reaches)."""
    replicas = tpu_ops.spatial()
    if replicas is None:
        out = F.conv_transpose2d(_nchw(x), w, stride=strides,
                                 padding=padding,
                                 output_padding=output_padding)
        return _nhwc(out[:, :, :out_size[0], :out_size[1]])
    k, s, t = w.shape[2], strides[0], padding[0]
    h, band = x.shape[1], out_size[0] // replicas.model_size
    if out_size[0] % replicas.model_size or band != h * s:
        raise ValueError(f"{what}: an output of {out_size[0]} rows does not "
                         f"split into bands of {s} x the input band's {h}.")
    lo = (k - 1 - t) // s
    x = tpu_ops.exchange_halos(x, lo, (t - 1) // s + 1, what)
    out = F.conv_transpose2d(_nchw(x), w, stride=strides,
                             padding=(0, padding[1]),
                             output_padding=(s - 1, output_padding[1]))
    start = lo * s + t
    return _nhwc(out[:, :, start:start + band, :out_size[1]])


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
        return self._finish(_conv2d_same(x, self.kernel.to(x.dtype),
                                         self.strides, self.scope), sigma)


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
        out = _transposed_rows(
            x, w, (2, 2), (k_h - 1 - pl_h, k_w - 1 - pl_w),
            (k_h - 2 * pl_h, k_w - 2 * pl_w),
            (2 * tpu_ops.image_rows(x), 2 * x.shape[2]), self.scope)
        return self._finish(out, sigma)


class Deconv2d(_SNLayer):
    """Transposed SAME conv to an explicit output size (arch_ops.py:297-328,
    tf.nn.conv2d_transpose with output_shape): the gradient of a SAME conv
    mapping `out_size` -> the input's size, with any ceil-div preimage as
    the output (4 -> 7 at stride 2 on DCGAN's 28 px schedule). The kernel is
    HWOI (k_h, k_w, C_out, C_in) in the JAX layout, so spectral norm
    flattens it to (-1, C_in); the port stores it IOHW, the weight layout
    of `F.conv_transpose2d`."""

    def __init__(self, in_channels, output_dim, k_h, k_w, d_h, d_w,
                 stddev=0.02, use_sn=False, device=None):
        super().__init__()
        self._add_kernel((k_h, k_w, output_dim, in_channels),
                         weight_initializer(stddev=stddev), use_sn, device,
                         permute=HWIO_TO_OIHW)
        self.strides = (d_h, d_w)
        self.use_bias = True
        self.bias = self.add_param("bias", (output_dim,), zeros_init(),
                                   device)

    def forward(self, x, output_size):
        """x: NHWC; output_size: (H, W) of the result."""
        sigma = self._sigma(x.dtype)
        return self._finish(_deconv2d_same(
            x, self.kernel.to(x.dtype), self.strides, output_size,
            self.scope), sigma)


def _deconv2d_same(x, w, strides, output_size, what="deconv2d"):
    """tf.nn.conv2d_transpose(padding="SAME") of NHWC `x` with an IOHW
    kernel to an NHWC result of `output_size` (H, W) (the whole image's)."""
    lo, extra = [], []
    for in_size, out_size, k, s in zip((tpu_ops.image_rows(x), x.shape[2]),
                                       output_size, w.shape[2:], strides):
        if -(-out_size // s) != in_size:
            raise ValueError(
                f"deconv2d: requested output size {out_size} is not a "
                f"stride-{s} SAME preimage of input size {in_size}.")
        full = (in_size - 1) * s + k  # The uncropped transposed conv.
        lo.append(max(full - out_size, 0) // 2)  # The SAME conv's pad.
        extra.append(out_size - (full - 2 * lo[-1]))
    # conv_transpose2d crops `padding` from both ends and adds
    # `output_padding` (< stride) back at the end; where the SAME pad is
    # larger at the end (lo < hi), the slice crops one more.
    return _transposed_rows(x, w, strides, tuple(lo),
                            tuple(max(e, 0) for e in extra), output_size,
                            what)


def lrelu(x, leak=0.2):
    """max(x, leak * x) (arch_ops.py:331-332): at x = 0 the gradient splits
    as jnp.maximum's does, which F.leaky_relu's does not."""
    return torch.maximum(x, leak * x)


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
        out = _conv_rows(x, w_eff.to(x.dtype), (2, 2),
                         (pl_h, k_h - 1 - pl_h), (pl_w, k_w - 1 - pl_w),
                         self.scope)
        return self._finish(out, sigma)


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
    (`.../bn1/accu/accu_mean`), as in the JAX scope tree.

    Moments are over the global batch: in a data-parallel step, over every
    worker's rows (`use_cross_replica_mean` is accepted and ignored, as in
    JAX). With `num_batch_groups` G > 1 (arch_ops.py:415-425 there) each
    contiguous G-th of the global batch is normalized by its own moments
    in training, and the moving moments and accumulators take the mean of
    the G groups' moments. Over W workers a group lies inside one worker
    when W divides G, and spans W / G workers (a sub-group reduction) when
    G divides W."""

    def __init__(self, num_channels, decay=0.999, epsilon=1e-3,
                 data_format="NHWC", use_moving_averages=True,
                 use_cross_replica_mean=None, num_batch_groups=1,
                 device=None):
        super().__init__()
        del use_cross_replica_mean
        if data_format != "NHWC":
            raise ValueError("The port is NHWC only, like the JAX package.")
        if num_batch_groups < 1:
            raise ValueError(f"num_batch_groups must be >= 1, got "
                             f"{num_batch_groups}.")
        self.num_batch_groups = num_batch_groups
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
        replicas = mesh_utils.active()
        group_moments = None
        if self.num_batch_groups > 1 and tpu_ops.spatial() is not None:
            raise ValueError(f"{self.scope}: num_batch_groups has no "
                             f"spatial layout.")
        if self.num_batch_groups > 1:
            mean, variance, group_moments = self._group_moments(x32,
                                                                replicas)
        elif replicas is None:
            mean = x32.mean(dim=dims)
            variance = (x32 * x32).mean(dim=dims) - mean * mean
        else:
            mean, variance = tpu_ops.cross_replica_moments(x32, replicas,
                                                           axes=dims)
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
        if group_moments is not None and is_training:
            mean, variance = group_moments
        out = (x32 - mean) * torch.rsqrt(variance + self.epsilon)
        return out.to(x.dtype)

    def _group_moments(self, x32, replicas):
        """(mean, variance) over the groups, and the per-row (mean,
        variance) of each row's group, shaped to broadcast against x."""
        groups = self.num_batch_groups
        world = 1 if replicas is None else replicas.world
        b, c = x32.shape[0], x32.shape[-1]
        if groups % world == 0:  # Whole groups on every worker.
            local = groups // world
            if b % local:
                raise ValueError(f"A batch of {b} rows does not split into "
                                 f"{local} groups.")
            xg = x32.reshape((local, b // local) + tuple(x32.shape[1:]))
            axes = tuple(range(1, xg.dim() - 1))
            mean_g = xg.mean(dim=axes)
            var_g = (xg * xg).mean(dim=axes) - mean_g * mean_g
            shape = (b,) + (1,) * (x32.dim() - 2) + (c,)
            per_row = (mean_g.repeat_interleave(b // local, 0).reshape(shape),
                       var_g.repeat_interleave(b // local, 0).reshape(shape))
            summed = torch.stack([mean_g.sum(0), var_g.sum(0)])
        elif world % groups == 0:  # Each group spans world / groups workers.
            per_row = tpu_ops.cross_replica_moments(
                x32, replicas, axes=tuple(range(x32.dim() - 1)),
                group_size=world // groups)
            # Each group's moments sit on world / groups workers.
            summed = torch.stack(per_row) * (groups / world)
        else:
            raise ValueError(f"num_batch_groups {groups} and {world} "
                             f"workers: one must divide the other.")
        if replicas is not None:
            summed = tpu_ops.all_reduce_sum(summed, replicas)
        mean, variance = summed / groups
        return mean, variance, per_row

    def forward(self, x, is_training):
        return self.standardize(x, is_training)


@gin.configurable("batch_norm")
class BatchNorm(StandardizeBatch):
    """BN with trainable gamma/beta (arch_ops.py:454-466), on rank-4 NHWC
    or rank-2 [B, C] inputs (InfoGAN's and SNDCGAN's linear outputs)."""

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


@gin.configurable("no_batch_norm")
class NoBatchNorm(core.Module):
    """The identity, with no variables (arch_ops.py:449-451)."""

    def __init__(self, **unused):
        super().__init__()

    def forward(self, x, **unused):
        return x


class _SelfModulation(core.Module):
    def __init__(self, z_dim, num_channels, center, scale, use_sn,
                 num_hidden, device):
        super().__init__()
        h_dim = z_dim
        if num_hidden > 0:
            self.hidden = Linear(z_dim, num_hidden, use_sn=use_sn,
                                 device=device)
            h_dim = num_hidden
        if scale:
            self.gamma = Linear(h_dim, num_channels, bias_start=1.0,
                                use_sn=use_sn, device=device)
        if center:
            self.beta = Linear(h_dim, num_channels, use_sn=use_sn,
                               device=device)


@gin.configurable("self_modulated_batch_norm")
class SelfModulatedBatchNorm(StandardizeBatch):
    """Self-modulation: gamma/beta = MLP(z) (arch_ops.py:469-491,
    arXiv:1810.01365), the MLP under `sbn/`."""

    def __init__(self, num_channels, z_dim, use_sn, center=True, scale=True,
                 num_hidden=32, device=None):
        super().__init__(num_channels, device=device)
        if z_dim is None:
            raise ValueError("You must provide z for self modulation.")
        self.center, self.scale = center, scale
        self._num_hidden = num_hidden
        self.sbn = _SelfModulation(z_dim, num_channels, center, scale,
                                   use_sn, num_hidden, device)

    def forward(self, x, is_training, z=None, **unused):
        if z is None:
            raise ValueError("You must provide z for self modulation.")
        out = self.standardize(x, is_training)
        h = z
        if self._num_hidden > 0:
            h = F.relu(self.sbn.hidden(h))
        if self.scale:
            gamma = self.sbn.gamma(h)
            out = out * gamma[:, None, None, :].to(out.dtype)
        if self.center:
            beta = self.sbn.beta(h)
            out = out + beta[:, None, None, :].to(out.dtype)
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


def _per_image_moments(layer):
    if tpu_ops.spatial() is not None:
        raise ValueError(f"{layer.scope or type(layer).__name__}: moments "
                         f"of each image have no spatial layout.")


class LayerNorm(core.Module):
    """Layer norm over every non-batch axis with per-channel gamma/beta
    (`layer_norm`, arch_ops.py:517-530): f32 moments, var = E[(x - mean)^2],
    epsilon 1e-12, output in the input's type."""

    def __init__(self, num_channels, device=None):
        super().__init__()
        self.gamma = self.add_param("gamma", (num_channels,), ones_init(),
                                    device)
        self.beta = self.add_param("beta", (num_channels,), zeros_init(),
                                   device)

    def forward(self, x):
        _per_image_moments(self)
        x32 = x.float()
        dims = tuple(range(1, x.dim()))
        mean = x32.mean(dim=dims, keepdim=True)
        var = (x32 - mean).square().mean(dim=dims, keepdim=True)
        out = (x32 - mean) * torch.rsqrt(var + 1e-12)
        return (out * self.gamma + self.beta).to(x.dtype)


@gin.configurable("evonorm_s0")
class EvoNormS0(core.Module):
    """EvoNorm-S0 (Liu et al. 2020; arch_ops.py:533-559 there): x *
    sigmoid(v * x) / group_std(x) * gamma + beta, in f32, over groups of
    channels: the largest divisor of C that is <= 32. Per example, so it
    needs no moments of the batch and no collective. Selected by
    `G.batch_norm_fn = @evonorm_s0`."""

    def __init__(self, num_channels, device=None):
        super().__init__()
        c = num_channels
        self.gamma = self.add_param("gamma", (c,), ones_init(), device)
        self.beta = self.add_param("beta", (c,), zeros_init(), device)
        self.v = self.add_param("v", (c,), ones_init(), device)
        self.groups = max(g for g in range(1, min(32, c) + 1) if c % g == 0)

    def forward(self, x, **unused):
        _per_image_moments(self)
        x32 = x.float()
        b, h, w, c = x32.shape
        xg = x32.reshape(b, h, w, self.groups, c // self.groups)
        std = torch.sqrt(xg.var(dim=(1, 2, 4), unbiased=False, keepdim=True)
                         + 1e-5)
        std = std.expand_as(xg).reshape(x32.shape)
        num = x32 * torch.sigmoid(self.v * x32)
        return ((num / std) * self.gamma + self.beta).to(x.dtype)


# ---------------------------------------------------------------------------
# Weight normalization (arch_ops.py:562-658 there)
# ---------------------------------------------------------------------------


class _WeightNorm(core.Module):
    """Direction `V`, scale `g` and bias `b` per output channel (Salimans
    & Kingma 2016). `layer(x, init=True)` is the data-dependent init: g and
    b are set so that this batch's outputs have mean 0 and standard
    deviation `init_scale` per channel, then the output is computed with
    them, as the JAX layer does when `init=True` while its variables are
    built (the port has no separate init trace). In a data-parallel step
    the init moments are those of the global batch, so every worker sets
    the same g and b."""

    def _add_variables(self, v_shape, channels, stddev, init_scale, eps,
                       device, permute=None):
        self.V = self.add_param("V", v_shape, truncated_normal_init(stddev),
                                device, permute=permute)
        self.g = self.add_param("g", (channels,), ones_init(), device)
        self.b = self.add_param("b", (channels,), zeros_init(), device)
        self.init_scale = init_scale
        self._eps = eps

    @torch.no_grad()
    def _data_init(self, x_init):
        """g, b from the moments of the unscaled output x_init (NHWC or
        [B, C]) over every axis but the channels."""
        x32 = x_init.float()
        axes = tuple(range(x32.dim() - 1))
        replicas = mesh_utils.active()
        if replicas is None:
            mean, var = x32.mean(dim=axes), x32.var(dim=axes, unbiased=False)
        else:
            mean, var = tpu_ops.cross_replica_moments(x32, replicas, axes)
        scale = self.init_scale / torch.sqrt(var + self._eps)
        self.g.copy_(scale)
        self.b.copy_(-mean * scale)


class WeightNormLinear(_WeightNorm):
    """Weight-normalized dense (`weight_norm_linear`); V [in, out]; eps
    1e-10 in the init, as in the reference. The output is f32."""

    def __init__(self, in_features, output_size, init_scale=1.0,
                 stddev=0.02, device=None):
        super().__init__()
        self._add_variables((in_features, output_size), output_size, stddev,
                            init_scale, 1e-10, device)

    def forward(self, x, init=False):
        v_norm = torch.rsqrt(self.V.square().sum(0))
        xv = (x @ self.V.to(x.dtype)).float()
        if init:
            self._data_init(xv * v_norm)
        return (self.g * v_norm)[None, :] * xv + self.b[None, :]


class WeightNormConv2d(_WeightNorm):
    """Weight-normalized SAME conv (`weight_norm_conv2d`); V HWIO in the
    JAX layout (stored OIHW); eps 1e-8 in the init."""

    def __init__(self, in_channels, output_dim, k_h, k_w, d_h, d_w,
                 init_scale=1.0, stddev=0.02, device=None):
        super().__init__()
        self._add_variables((k_h, k_w, in_channels, output_dim), output_dim,
                            stddev, init_scale, 1e-8, device,
                            permute=HWIO_TO_OIHW)
        self.strides = (d_h, d_w)

    def forward(self, x, init=False):
        v_normed = self.V * torch.rsqrt(
            self.V.square().sum(dim=(1, 2, 3), keepdim=True))
        if init:
            self._data_init(_conv2d_same(x, v_normed.to(x.dtype),
                                         self.strides))
        w = self.g[:, None, None, None] * v_normed
        out = _conv2d_same(x, w.to(x.dtype), self.strides)
        return out + self.b.to(out.dtype)


class WeightNormDeconv2d(_WeightNorm):
    """Weight-normalized transposed SAME conv (`weight_norm_deconv2d`) to
    stride times the input's size, by `Deconv2d`'s rule; V HWOI in the JAX
    layout (stored IOHW); eps 1e-8 in the init."""

    def __init__(self, in_channels, output_dim, k_h, k_w, d_h, d_w,
                 init_scale=1.0, stddev=0.02, device=None):
        super().__init__()
        self._add_variables((k_h, k_w, output_dim, in_channels), output_dim,
                            stddev, init_scale, 1e-8, device,
                            permute=HWIO_TO_OIHW)
        self.strides = (d_h, d_w)

    def forward(self, x, init=False):
        v_normed = self.V * torch.rsqrt(
            self.V.square().sum(dim=(0, 2, 3), keepdim=True))
        size = (x.shape[1] * self.strides[0], x.shape[2] * self.strides[1])
        if init:
            self._data_init(_deconv2d_same(x, v_normed.to(x.dtype),
                                           self.strides, size))
        w = self.g[None, :, None, None] * v_normed
        out = _deconv2d_same(x, w.to(x.dtype), self.strides, size)
        return out + self.b.to(out.dtype)


# ---------------------------------------------------------------------------
# Self-attention (SAGAN non-local block)
# ---------------------------------------------------------------------------


def _max_pool_2x2(x):
    return _nhwc(F.max_pool2d(_nchw(x), 2))


class NonLocalBlock(core.Module):
    """SAGAN self-attention (arch_ops.py:676-711): 1x1 SN convs theta, phi,
    g; 2x2 max-pool on phi and g; softmax attention through the CUDA kernel
    (`fused_attention`); output cast back to x's type; learned gate `sigma`
    starting at 0.

    In the spatial layout theta keeps the band's own query rows; phi and g
    are pooled in the band, then gathered over the model group in band
    order, the whole image's keys in their global order. The kernels run
    on the band's N / k queries against all M keys, and the keys'
    gradients come back as partial sums that the gather's backward sums to
    their owners. That computes what the JAX package's partitioning rule
    computes (pallas_attention.py:33-75, :240-244), but the rule declares
    the query dim replicated, so XLA gathers the whole map and every model
    rank runs the whole attention; here each runs 1 / k of it."""

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
        if h % 2 and tpu_ops.spatial() is not None:
            raise ValueError(f"{self.scope}: a band of {h} rows does not "
                             f"pool 2x2 in place.")
        theta = self.conv2d_theta(x).reshape(b, h * w, self.attn_ch)
        phi = tpu_ops.gather_bands(_max_pool_2x2(self.conv2d_phi(x)).reshape(
            b, (h // 2) * (w // 2), self.attn_ch))
        g = tpu_ops.gather_bands(_max_pool_2x2(self.conv2d_g(x)).reshape(
            b, (h // 2) * (w // 2), self.g_ch))
        attn_g = attention_lib.fused_attention(
            theta.contiguous(), phi.contiguous(), g.contiguous())
        attn_g = attn_g.reshape(b, h, w, self.g_ch).to(x.dtype)
        attn_g = self.conv2d_attn_g(attn_g)
        return x + self.sigma.to(x.dtype) * attn_g
