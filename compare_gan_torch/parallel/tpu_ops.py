"""Cross-replica collectives (counterpart of
compare_gan_tpu/parallel/tpu_ops.py).

The JAX functions run inside `shard_map` over a named mesh axis; these run
in every worker of a `mesh_utils.Replicas` group and take it in place of
the axis name. All of them carry gradients: each is built on one
all-reduce whose backward is the same all-reduce of the gradients, so a
gradient of a gradient (the WGAN-GP and DRAGAN penalties through a batch
norm) crosses the workers too.

  cross_replica_concat  -- all-gather of equal shapes, in rank order.
  cross_replica_mean    -- mean over the workers, or over contiguous groups
                           of `group_size` workers.
  cross_replica_moments -- mean and E[x^2] - E[x]^2 from one all-reduce of
                           the stacked (sum, sum of squares, row count) in
                           f32; the count makes it exact when the workers
                           hold different numbers of rows.

`batch_mean` and `batch_variance` are the global-batch reductions of the
losses: outside a data-parallel step (no active Replicas) they are the
plain `mean` / `var`, so the one-process path computes what it always did.

The spatial layout's collectives run over the model group of the active
Replicas (`spatial()`), each the adjoint of another, so that gradients of
any order cross the bands:

  exchange_halos -- the band with `lo` rows of the band above and `hi` of
                    the band below (zeros at the image's top and bottom);
                    backward: each halo row's gradient added to its owner.
  gather_bands   -- the bands of every model rank, in band order; backward:
                    the gradient summed over the group, this band's part.
  split_bands    -- this worker's band of a tensor every model rank holds
                    whole; backward: autograd's slice, zeros elsewhere.
  model_sum      -- the sum over the group; backward: the same sum.

A loss is computed whole on every model rank of a data rank. Each takes
`1 / world` of it (`loss_shares`: the grid's size, not the data ranks'),
so that the model ranks' shares sum to their data rank's, and `model_sum`'s
summing backward gives each band the whole gradient: parameters used whole
on every rank (D's last linear layer, its projection embedding) are then
counted once when the gradients are summed over the grid, and parameters
used on bands get the sum of their bands' parts.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from compare_gan_torch.parallel import mesh_utils


class _AllReduceSum(torch.autograd.Function):
    """Sum over the workers. The gradient of a replicated sum with respect
    to one worker's summand is the sum of every worker's gradient of the
    result: the same all-reduce, itself differentiable."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.contiguous().clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return _AllReduceSum.apply(grad, ctx.group), None


def all_reduce_sum(x: torch.Tensor, replicas) -> torch.Tensor:
    """Differentiable sum of `x` over the workers of `replicas`."""
    return _AllReduceSum.apply(x, replicas.group)


def cross_replica_concat(value: torch.Tensor, replicas) -> torch.Tensor:
    """All-gather along dim 0 in rank order (tpu_ops.py:26-30 there): every
    worker gets [world * value.shape[0], ...]. Every worker's `value` must
    have the same shape."""
    n, rest = value.shape[0], tuple(value.shape[1:])
    zeros = value.new_zeros
    padded = torch.cat([zeros((replicas.rank * n,) + rest), value,
                        zeros(((replicas.world - replicas.rank - 1) * n,)
                              + rest)])
    return all_reduce_sum(padded, replicas)


def _group_sum(value, replicas, group_size):
    """Sum of `value` over this worker's contiguous group of `group_size`
    workers (all of them when None)."""
    if group_size is None or group_size == replicas.world:
        return all_reduce_sum(value, replicas)
    if group_size <= 0 or replicas.world % group_size:
        raise ValueError(f"Group size {group_size} must divide replica "
                         f"count {replicas.world}.")
    gathered = cross_replica_concat(value[None], replicas)
    start = (replicas.rank // group_size) * group_size
    return gathered[start:start + group_size].sum(0)


def cross_replica_mean(value: torch.Tensor, replicas,
                       group_size: Optional[int] = None) -> torch.Tensor:
    """Mean over the workers, or over contiguous groups of `group_size`
    workers (tpu_ops.py:33-50 there)."""
    size = replicas.world if group_size is None else group_size
    return _group_sum(value, replicas, group_size) / size


def cross_replica_moments(value: torch.Tensor, replicas,
                          axes: Sequence[int] = (0,),
                          group_size: Optional[int] = None):
    """(mean, variance) of `value` over `axes` and over the workers (or a
    contiguous group of `group_size` workers), in f32: one all-reduce of
    the stacked (sum, sum of squares, count) (tpu_ops.py:53-62 there)."""
    x32 = value.float()
    axes = tuple(axes)
    count = math.prod(x32.shape[a] for a in axes)
    local = torch.cat([x32.sum(axes).reshape(-1),
                       (x32 * x32).sum(axes).reshape(-1),
                       x32.new_full((1,), float(count))])
    stats = _group_sum(local, replicas, group_size)
    c = (stats.shape[0] - 1) // 2
    shape = [s for a, s in enumerate(x32.shape) if a not in axes]
    total = stats[-1]
    mean = (stats[:c] / total).reshape(shape)
    mean_sq = (stats[c:2 * c] / total).reshape(shape)
    return mean, mean_sq - mean * mean


def loss_shares(replicas) -> int:
    """The number of workers that each hold a share of a loss of the global
    batch: all of them, the model ranks that compute a data rank's loss
    whole included."""
    return replicas.world


def batch_mean(x: torch.Tensor, count: Optional[int] = None
               ) -> torch.Tensor:
    """The mean of `x` over the global batch. In a data-parallel step this
    worker's share: its sum over the global element count, `count` or, by
    default, its own count times `loss_shares` (every worker holding as
    many). The shares sum to the global mean, and so do their gradients,
    which the step sums over the workers."""
    replicas = mesh_utils.active()
    if replicas is None:
        return x.mean()
    return x.sum() / (x.numel() * loss_shares(replicas) if count is None
                      else count)


def batch_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of `x` over the global batch, on every worker."""
    replicas = mesh_utils.active()
    total = x.sum()
    return total if replicas is None else all_reduce_sum(total, replicas)


def batch_variance(x: torch.Tensor) -> torch.Tensor:
    """The population variance of every element of `x` over the global
    batch."""
    replicas = mesh_utils.active()
    if replicas is None:
        return x.var(unbiased=False)
    return cross_replica_moments(x.reshape(-1, 1), replicas)[1][0]


def replicated_share(x: torch.Tensor) -> torch.Tensor:
    """A term every worker computes alike (a function of the replicated
    weights, such as the L2 penalty), as this worker's share of it."""
    replicas = mesh_utils.active()
    return x if replicas is None else x / loss_shares(replicas)


# ---------------------------------------------------------------------------
# The spatial layout: collectives of the model group over bands of rows
# ---------------------------------------------------------------------------


def spatial():
    """The active Replicas when image height is split over a model group,
    else None."""
    replicas = mesh_utils.active()
    if replicas is None or replicas.model_size == 1:
        return None
    return replicas


def image_rows(x: torch.Tensor) -> int:
    """The whole image's height of a band (NHWC) of the active layout."""
    replicas = spatial()
    return x.shape[1] * (1 if replicas is None else replicas.model_size)


def _stack(x, replicas):
    """[k, *x.shape]: every model rank's `x`, in rank order, from one
    all-reduce (gloo on CUDA tensors runs no all-gather), on the wire in
    f32 when `x` is a 16-bit type: the sum of one value with zeros is
    exact in either."""
    wire = x.float() if x.element_size() < 4 else x
    buf = wire.new_zeros((replicas.model_size,) + tuple(x.shape))
    buf[replicas.model_rank] = wire
    dist.all_reduce(buf, group=replicas.model_group)
    return buf.to(x.dtype)


class _HaloExchange(torch.autograd.Function):
    """[b, lo + h + hi, ...] from a band [b, h, ...]: the last `lo` rows of
    the band above, the band, the first `hi` rows of the band below."""

    @staticmethod
    def forward(ctx, x, replicas, lo, hi):
        ctx.args = (replicas, lo, hi)
        h = x.shape[1]
        sent = _stack(torch.cat([x[:, :hi], x[:, h - lo:]], 1), replicas)
        m, k = replicas.model_rank, replicas.model_size
        top = sent[m - 1][:, hi:] if m > 0 else x.new_zeros(
            (x.shape[0], lo) + tuple(x.shape[2:]))
        bottom = sent[m + 1][:, :hi] if m < k - 1 else x.new_zeros(
            (x.shape[0], hi) + tuple(x.shape[2:]))
        return torch.cat([top, x, bottom], 1)

    @staticmethod
    def backward(ctx, grad):
        return (_HaloAdjoint.apply(grad, *ctx.args),) + (None,) * 3


class _HaloAdjoint(torch.autograd.Function):
    """The transpose of `_HaloExchange`: the band's rows of [b, lo + h +
    hi, ...], plus the halo rows the bands above and below hold of it."""

    @staticmethod
    def forward(ctx, grad, replicas, lo, hi):
        ctx.args = (replicas, lo, hi)
        h = grad.shape[1] - lo - hi
        sent = _stack(torch.cat([grad[:, lo + h:], grad[:, :lo]], 1),
                      replicas)
        m, k = replicas.model_rank, replicas.model_size
        out = grad[:, lo:lo + h].clone()
        if m > 0:  # The band above's bottom halo: my first hi rows.
            out[:, :hi] += sent[m - 1][:, :hi]
        if m < k - 1:  # The band below's top halo: my last lo rows.
            out[:, h - lo:] += sent[m + 1][:, hi:]
        return out

    @staticmethod
    def backward(ctx, grad):
        return (_HaloExchange.apply(grad, *ctx.args),) + (None,) * 3


def exchange_halos(x: torch.Tensor, lo: int, hi: int,
                   what: str = "a layer") -> torch.Tensor:
    """This worker's band (NHWC, rows in dim 1) with `lo` halo rows above
    and `hi` below from the neighbouring bands of the model group, zeros
    past the image's top and bottom: what a SAME conv reads. `what` names
    the layer in the error raised for a band thinner than its halo."""
    replicas = spatial()
    if replicas is None or lo == hi == 0:
        return x
    if max(lo, hi) > x.shape[1]:
        raise ValueError(f"{what}: a band of {x.shape[1]} rows is thinner "
                         f"than its halo ({lo} above, {hi} below); use "
                         f"fewer model ranks.")
    return _HaloExchange.apply(x, replicas, lo, hi)


class _GatherBands(torch.autograd.Function):
    """Every model rank's tensor concatenated along `dim` in band order."""

    @staticmethod
    def forward(ctx, x, replicas, dim):
        ctx.args = (replicas, dim)
        return torch.cat(list(_stack(x, replicas)), dim)

    @staticmethod
    def backward(ctx, grad):
        return _ReduceBands.apply(grad, *ctx.args), None, None


class _ReduceBands(torch.autograd.Function):
    """The transpose of `_GatherBands`: the sum over the model group of a
    whole tensor, this band's part of it along `dim`."""

    @staticmethod
    def forward(ctx, x, replicas, dim):
        ctx.args = (replicas, dim)
        total = x.float().contiguous().clone()  # f32 on the wire.
        dist.all_reduce(total, group=replicas.model_group)
        n = x.shape[dim] // replicas.model_size
        return total.narrow(dim, replicas.model_rank * n, n).to(
            x.dtype).contiguous()

    @staticmethod
    def backward(ctx, grad):
        return _GatherBands.apply(grad, *ctx.args), None, None


def gather_bands(x: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """The whole tensor from every model rank's band along `dim` (the
    identity outside the spatial layout)."""
    replicas = spatial()
    return x if replicas is None else _GatherBands.apply(x, replicas, dim)


def split_bands(x: torch.Tensor, what: str = "a layer") -> torch.Tensor:
    """This worker's band of rows (dim 1) of a tensor every model rank
    holds whole, as G's first linear layer gives it (the identity outside
    the spatial layout). Its gradient is autograd's: zeros outside the
    band, so each model rank's whole-computed layer gets its band's part,
    and the sum over the grid the whole."""
    replicas = spatial()
    if replicas is None:
        return x
    h, k = x.shape[1], replicas.model_size
    if h % k:
        raise ValueError(f"{what}: {h} rows do not split into {k} bands.")
    return x.narrow(1, replicas.model_rank * (h // k), h // k)


def model_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum over the model group of the active layout, differentiable
    (its backward is the same sum); on the wire in f32."""
    replicas = spatial()
    if replicas is None:
        return x
    return _AllReduceSum.apply(x.float(), replicas.model_group).to(x.dtype)


def spatial_sum(x: torch.Tensor) -> torch.Tensor:
    """x.sum(dim=(1, 2)) of the whole image from a band (NHWC)."""
    return model_sum(x.sum(dim=(1, 2)))
