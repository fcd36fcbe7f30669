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


def batch_mean(x: torch.Tensor, count: Optional[int] = None
               ) -> torch.Tensor:
    """The mean of `x` over the global batch. In a data-parallel step this
    worker's share: its sum over the global element count, `count` or, by
    default, its own count times the workers (every worker holding as
    many). The shares sum to the global mean, and so do their gradients,
    which the step sums over the workers."""
    replicas = mesh_utils.active()
    if replicas is None:
        return x.mean()
    return x.sum() / (x.numel() * replicas.world if count is None else count)


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
    return x if replicas is None else x / replicas.world
