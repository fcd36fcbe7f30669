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
  split_bands    -- this worker's band of a map every model rank holds
                    whole, or the map itself, whole, where its height
                    does not split; backward: autograd's slice, zeros
                    elsewhere.
  model_sum      -- the sum over the group; backward: the same sum.

Built on them: the whole image's sums and means of a band (`spatial_sum`,
`spatial_mean`, `image_sum`), each image's moments (`image_moments`,
layer norm and EvoNorm), and its quarter-turns (`rotate_bands`: a rotated
band is no band, so the rows are gathered, turned, and cut again).

Partial replication, as XLA partitions a map whose height does not split:
a map is held as bands where its height splits into k equal bands and the
next layer can run on them, and whole on every model rank of the group
otherwise. A layer that cannot run on its bands (a stride or a 2x2 pool
that a band's odd row count would straddle, a transposed conv whose
output does not split, a band thinner than a halo) gathers them and runs
on the whole map; a whole map whose height splits goes back to bands
(`split_bands`). So a map's kind is part of it: the tensor types `Band`
and `Whole` (`as_band`, `like`, `is_band`), which every op on maps
carries to its results, and a band meeting a whole map raises. The sums
over a whole map's rows are each model rank's own (`band_group`): over
the group they would count them k times.

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

from compare_gan_torch import utils
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
    which the step sums over the workers. In the spatial layout the k
    model ranks of a data rank hold its rows alike, so a given `count` is
    counted k times."""
    replicas = mesh_utils.active()
    if replicas is None:
        return x.mean()
    return x.sum() / (x.numel() * loss_shares(replicas) if count is None
                      else count * replicas.model_size)


def batch_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of `x` over every worker, on every worker: the global
    batch's, each data rank's rows counted once on each of its model ranks
    in the spatial layout (S3GAN's class loss divides a worker's sum by
    it, which makes that worker's share)."""
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


class _Map(torch.Tensor):
    """A map (NHWC activation) of the spatial layout, its type the way the
    model group holds it: `Band`, this worker's band of the rows, or
    `Whole`, every row alike on every model rank. An op on maps returns
    its rank-4 results as maps of their kind, and raises where a band meets
    a whole map, or a rank-4 tensor of more than one row that is neither
    (a map whose kind was lost): a band cannot be told from a whole map by
    its shape."""

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        with torch._C.DisableTorchFunctionSubclass():
            out = func(*args, **kwargs)
        return _as_kind(out, _kind_of(func, (*args, *kwargs.values())))


class Band(_Map):
    """This worker's band of a map's rows."""


class Whole(_Map):
    """A map every model rank holds whole."""


def _kind_of(func, args):
    kinds, loose = set(), False
    for arg in args:
        for t in arg if isinstance(arg, (list, tuple)) else (arg,):
            if isinstance(t, _Map):
                kinds.add(type(t))
            elif isinstance(t, torch.Tensor) and t.dim() == 4 \
                    and t.shape[1] > 1:
                loose = True
    if len(kinds) > 1 or loose:
        name = getattr(func, "__name__", func)
        raise ValueError(f"{name}: a band meets a whole map" if len(kinds) > 1
                         else f"{name}: a map of the spatial layout meets a "
                         f"rank-4 tensor that is neither a band nor a whole "
                         f"map")
    return kinds.pop() if kinds else None


def _as_kind(out, kind):
    if isinstance(out, torch.Tensor):
        if kind is None or out.dim() != 4 or type(out) is kind:
            return out
        return out.as_subclass(kind)
    if type(out) in (list, tuple):
        return type(out)(_as_kind(o, kind) for o in out)
    return out


def plain(x: torch.Tensor) -> torch.Tensor:
    """`x` as a plain tensor (the same data and graph), its kind dropped."""
    return x.as_subclass(torch.Tensor) if isinstance(x, _Map) else x


def as_band(x: torch.Tensor) -> torch.Tensor:
    """`x`, this worker's band of a map's rows, marked as a band (the
    identity outside the spatial layout)."""
    return x if spatial() is None else plain(x).as_subclass(Band)


def like(x: torch.Tensor, of: torch.Tensor) -> torch.Tensor:
    """`x`, a map computed from the map `of` through tensors of other ranks,
    marked as the kind of `of`."""
    if spatial() is None:
        return x
    return plain(x).as_subclass(Band if is_band(of) else Whole)


def is_band(x: torch.Tensor, what: str = "a layer") -> bool:
    """Whether the map `x` is this worker's band (True) or held whole on
    every model rank (False; so is everything outside the spatial layout,
    and a tensor of rank 2 or less: features). Raises for a tensor of
    higher rank that is neither, naming `what`."""
    if spatial() is None or x.dim() <= 2 or isinstance(x, Whole):
        return False
    if isinstance(x, Band):
        return True
    raise ValueError(f"{what}: a map of shape {tuple(x.shape)} is neither a "
                     f"band nor a whole map of the spatial layout.")


def band_group(x: torch.Tensor):
    """The Replicas over whose model group a sum over the rows of the map
    `x` runs: the active layout's for a band; None for a whole map, whose
    every row each model rank holds (its own sum is the whole map's)."""
    return spatial() if is_band(x) else None


def image_rows(x: torch.Tensor, what: str = "a layer") -> int:
    """The whole map's height of the map (NHWC) `x`."""
    replicas = spatial()
    return x.shape[1] * (replicas.model_size if is_band(x, what) else 1)


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
    past the image's top and bottom: what a SAME conv reads; a plain
    tensor. `what` names the layer in the error raised for a whole map or
    a band thinner than its halo (the layers gather such a band first)."""
    replicas = spatial()
    if replicas is None:
        return x
    if isinstance(x, Whole):
        raise ValueError(f"{what}: a whole map has no halo rows.")
    if max(lo, hi) > x.shape[1]:
        raise ValueError(f"{what}: a band of {x.shape[1]} rows is thinner "
                         f"than its halo ({lo} above, {hi} below).")
    if lo == hi == 0:
        return plain(x)
    return _HaloExchange.apply(plain(x), replicas, lo, hi)


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
    identity outside the spatial layout): a band of a map (NHWC) becomes
    the whole map, and a tensor of another rank is taken as a band along
    `dim`. Its backward sums the gradients of every model rank's whole
    tensor, this band's part of them: a whole map used alike on every rank
    gives each band its whole gradient k times over 1 / k of the loss."""
    replicas = spatial()
    if replicas is None:
        return x
    if x.dim() == 4 and not is_band(x, "gather_bands"):
        raise ValueError("gather_bands: the map is whole already.")
    out = _GatherBands.apply(plain(x), replicas, dim)
    return out.as_subclass(Whole) if x.dim() == 4 else out


def split_bands(x: torch.Tensor, what: str = "a layer") -> torch.Tensor:
    """A map (NHWC) every model rank holds whole, as G's first linear layer
    gives it or a layer that ran on a whole map: this worker's band of its
    rows where they split into k equal bands, else the map itself, held
    whole (partial replication; the identity outside the spatial layout).
    Its gradient is autograd's: zeros outside the band, so each model
    rank's whole-computed layer gets its band's part, and the sum over the
    grid the whole."""
    replicas = spatial()
    if replicas is None:
        return x
    if isinstance(x, Band):
        raise ValueError(f"{what}: a band is not split again.")
    h, k = x.shape[1], replicas.model_size
    x = plain(x)
    if h % k:
        return x.as_subclass(Whole)
    return x.narrow(1, replicas.model_rank * (h // k), h // k).as_subclass(
        Band)


def model_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum over the model group of the active layout, differentiable
    (its backward is the same sum); on the wire in f32."""
    replicas = spatial()
    if replicas is None:
        return x
    return _AllReduceSum.apply(plain(x).float(), replicas.model_group).to(
        x.dtype)


def _row_sum(x, of, dims):
    """The sum of `x` over `dims` (the rows among them), over the model
    group when the map `of` is a band."""
    total = plain(x).sum(dim=dims)
    return total if band_group(of) is None else model_sum(total)


def spatial_sum(x: torch.Tensor) -> torch.Tensor:
    """x.sum(dim=(1, 2)) of the whole map from a band or a whole map
    (NHWC)."""
    return _row_sum(x, x, (1, 2))


def spatial_mean(x: torch.Tensor) -> torch.Tensor:
    """x.mean(dim=(1, 2)) of the whole map from a band or a whole map
    (NHWC)."""
    return spatial_sum(x) / (image_rows(x) * x.shape[2])


def image_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum over every dim but the batch of each whole image, from a
    band or a whole map: [B]."""
    return _row_sum(x, x, tuple(range(1, x.dim())))


def image_moments(x: torch.Tensor, dims: Sequence[int], of=None):
    """(mean, variance) over `dims` of each whole image of the map `of`
    (default `x`; `x` may be a reshape of it), kept as dims of size 1; the
    rows (dim 1) must be among them. Two passes, the variance E[(x -
    mean)^2]: the group's sum of the bands' sums, then of their squares
    about the mean; a whole map's own sums."""
    dims = tuple(dims)
    of = x if of is None else of
    replicas = band_group(of)
    x = plain(x)
    count = math.prod(x.shape[d] for d in dims) * (
        1 if replicas is None else replicas.model_size)

    def total(t):
        t = t.sum(dim=dims, keepdim=True)
        return t if replicas is None else model_sum(t)

    mean = total(x) / count
    return mean, total((x - mean).square()) / count


def rotate_bands(x: torch.Tensor, rot90_scalars=(0, 1, 2, 3)
                 ) -> torch.Tensor:
    """`utils.rotate_images` of the whole square images of a band (NHWC),
    this worker's band of the result: a quarter-turn sends rows to
    columns, so the bands are gathered, the whole images turned, and the
    result cut into bands again. Whole images turn where they are."""
    if spatial() is None or not is_band(x, "rotate_bands"):
        return utils.rotate_images(x, rot90_scalars)
    if x.shape[0] == 0:  # Every model rank holds the same rows.
        return x.repeat(len(rot90_scalars), 1, 1, 1)
    return split_bands(utils.rotate_images(plain(gather_bands(x)),
                                           rot90_scalars), "rotate_bands")
