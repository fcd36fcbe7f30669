"""Worker identity, process groups and the row split of data parallelism
(counterpart of compare_gan_tpu/parallel/mesh_utils.py).

The JAX package builds a 1-D `data` mesh over the devices of one program;
the port starts one worker process per device (`compare_gan_torch.main`
spawns them) and joins them in a `torch.distributed` group, given its
rendezvous address, world size and rank explicitly: nothing on a GPU host
tells a program of a cluster. A worker's place is a `Replicas`: its rank,
the world size, and the host it runs on among `num_hosts` hosts (ranks are
numbered host by host).

The training batch is split as the JAX mesh splits it: every sub-step's
global batch of B rows is cut into `world` contiguous blocks of B / world
rows, block r on rank r. Each host reads its `1 / num_hosts` share of the
global step batch from its own input stream (`datasets`,
modular_gan.py:605-625 there); with one host every worker reads the whole
batch and keeps its rows; with several, one all-to-all brings each
worker its rows from the hosts that read them (`exchange_blocks`), and
only the labels, which the draws read whole, are gathered everywhere.
Variables are replicated: every worker starts from the same state
(`assert_replicated` checks it bitwise) and applies the same summed
gradients (`sum_over_replicas`, a few flat buffers, not one call per
tensor).

Inside a train step `replica_context(replicas)` makes the group visible to
the ops that read the batch as a whole (batch norm, the losses,
`tpu_ops.batch_mean`). Outside it, as in evaluation and image summaries
on rank 0, they compute over the local batch and start no collective.

The spatial layout (counterpart of `make_mesh(extra_axes=(("model", k),))`
and `compile_train_step(spatial=True)` there, mesh_utils.py:26-45,183-207)
adds a second axis: the workers form a `data x model` grid, rank =
data_rank * k + model_rank, so a model group is k consecutive ranks on one
host, as the JAX mesh puts `model` last, inside a process's devices. A
data rank's rows are cut into k bands of image height, band m on model
rank m (`P("data", "model")`); labels, z and the sampled labels stay whole
on every model rank of a data rank, which draw the same values. XLA
derives every halo, moment and gradient sum of that layout from the
sharding; here `tpu_ops` holds them as collectives of the model group
(`model_group`), and the layers call them where they read rows of other
bands (`ops.arch_ops`, the architectures that support the layout).
Moments and gradients are summed over the whole grid.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import socket
import threading
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

_local = threading.local()

# (num_hosts, host_id) of the process group this process joined, the
# counterpart of jax.distributed's global state: the input pipeline reads
# it (datasets, ModularGAN.input_batches).
_topology = (1, 0)

# The largest flat buffer of one gradient all-reduce.
BUCKET_BYTES = 256 * 2 ** 20
# How long a collective waits for the other workers before it fails.
TIMEOUT = datetime.timedelta(minutes=30)


@dataclasses.dataclass(frozen=True)
class Replicas:
    """One worker's place among the workers. `group` is the
    torch.distributed process group of all of them (None: the default
    group). With `model_size` k > 1 they form a `data x model` grid (the
    spatial layout): `model_group` holds the k workers that share this
    worker's rows, each with one band of their image height."""
    rank: int
    world: int
    num_hosts: int = 1
    group: Any = None
    model_size: int = 1
    model_group: Any = None

    @property
    def model_rank(self) -> int:
        """This worker's band of image height, 0 at the top."""
        return self.rank % self.model_size

    @property
    def data_rank(self) -> int:
        return self.rank // self.model_size

    @property
    def data_size(self) -> int:
        """Workers that hold rows of their own."""
        return self.world // self.model_size

    def band(self, x):
        """This worker's band of rows of image height (dim 1) of a whole
        image batch."""
        if self.model_size == 1:
            return x
        h = x.shape[1]
        if h % self.model_size:
            raise ValueError(f"An image height of {h} does not split into "
                             f"{self.model_size} bands.")
        n = h // self.model_size
        return x[:, self.model_rank * n:(self.model_rank + 1) * n]

    @property
    def local_count(self) -> int:
        """Workers per host."""
        return self.world // self.num_hosts

    @property
    def host_id(self) -> int:
        return self.rank // self.local_count

    def rows(self, x, global_rows: int):
        """This worker's block of a tensor or array whose leading dim is a
        global batch of `global_rows` rows: its data rank's."""
        if global_rows % self.data_size:
            raise ValueError(f"A global batch of {global_rows} rows does not "
                             f"split over {self.data_size} data ranks.")
        n = global_rows // self.data_size
        return x[self.data_rank * n:(self.data_rank + 1) * n]

    def _sent_rows(self, host_rows: torch.Tensor) -> torch.Tensor:
        """The global step batch holds every host's share in host order
        (rows [h * T / H, (h + 1) * T / H) on host h, as the JAX mesh
        orders them). Each worker sends the rows [rank * T / W,
        (rank + 1) * T / W) of it, its block of its host's share."""
        n = host_rows.shape[0] // self.local_count
        local = self.rank % self.local_count
        return host_rows[local * n:(local + 1) * n]

    def gather_hosts(self, host_rows: torch.Tensor) -> torch.Tensor:
        """The whole global step batch on every worker, from every host's
        share: T rows move to each worker, so it is for small tensors (the
        labels, which the draws read whole)."""
        if self.num_hosts == 1:
            return host_rows
        mine = self._sent_rows(host_rows).contiguous()
        blocks = [torch.empty_like(mine) for _ in range(self.world)]
        dist.all_gather(blocks, mine, group=self.group)
        return torch.cat(blocks)

    def exchange_blocks(self, host_rows: torch.Tensor,
                        sub_batch: int) -> torch.Tensor:
        """This worker's block of every sub-step of the global step batch
        (`rows(sub_step, sub_batch)` of each, sub-steps in order), from
        every host's share: one all-to-all in which each worker sends
        each other worker the rows of its block of the host share that
        the other keeps, so T / W rows reach each worker. (With one host
        every worker holds the whole batch and just takes its rows.) In
        the spatial layout those are 1 / k of its data rank's rows, and
        the model group gathers the k parts in order."""
        total = host_rows.shape[0] * self.num_hosts
        n, chunk = sub_batch // self.world, total // self.world
        sent = torch.arange(self.rank * chunk, (self.rank + 1) * chunk)
        dest = sent % sub_batch // n
        order = torch.argsort(dest, stable=True)
        kept = torch.cat([torch.arange(i + self.rank * n,
                                       i + (self.rank + 1) * n)
                          for i in range(0, total, sub_batch)])
        out = host_rows.new_empty((kept.numel(),) + host_rows.shape[1:])
        dist.all_to_all_single(
            out, self._sent_rows(host_rows)[order.to(host_rows.device)],
            output_split_sizes=torch.bincount(
                kept // chunk, minlength=self.world).tolist(),
            input_split_sizes=torch.bincount(
                dest, minlength=self.world).tolist(),
            group=self.group)
        if self.model_size == 1:
            return out
        # [k parts, sub-steps, n rows] -> [sub-steps, k parts, n rows].
        parts = out.new_zeros((self.model_size,) + tuple(out.shape))
        parts[self.model_rank] = out
        dist.all_reduce(parts, group=self.model_group)
        steps = kept.numel() // n
        return parts.reshape((self.model_size, steps, n)
                             + tuple(out.shape[1:])).transpose(0, 1).reshape(
            (-1,) + tuple(out.shape[1:]))


@contextlib.contextmanager
def replica_context(replicas: Optional[Replicas]):
    """Within the block, `active()` is `replicas` (None: no group)."""
    prev = getattr(_local, "replicas", None)
    _local.replicas = replicas
    try:
        yield
    finally:
        _local.replicas = prev


def active() -> Optional[Replicas]:
    """The Replicas of the data-parallel step running in this thread."""
    return getattr(_local, "replicas", None)


def process_topology() -> Tuple[int, int]:
    """(num_hosts, host_id) of this process's group; (1, 0) without one."""
    return _topology


def free_port() -> int:
    """A free TCP port on localhost, for a one-host rendezvous."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def check_device_count(num_devices: int, device: torch.device) -> None:
    """Refuse more CUDA devices than this host has, as the JAX package's
    make_mesh refuses more devices than exist (mesh_utils.py:34-41 there).
    A CPU worker needs no device of its own."""
    if num_devices < 1:
        raise ValueError(f"--num_devices must be >= 1, got {num_devices}.")
    if device.type != "cuda":
        return
    available = torch.cuda.device_count()
    if num_devices > available:
        raise ValueError(
            f"Requested a {num_devices}-device mesh but only {available} "
            f"devices are available — refusing to silently train on a "
            f"narrower mesh (global-batch semantics would change).")


def worker_device(device: str, local_rank: int,
                  local_count: int) -> torch.device:
    """The device of one worker: `cuda:<local_rank>` for `cuda`, the CPU
    for `cpu`; an indexed device (`cuda:1`) pins a one-worker host."""
    dev = torch.device(device)
    if dev.index is not None:
        if local_count != 1:
            raise ValueError(f"--device={device} pins one device, but "
                             f"{local_count} workers per host were asked.")
        return dev
    if dev.type == "cuda":
        return torch.device("cuda", local_rank)
    return dev


def init_process_group(rank: int, world: int, address: str, port: int,
                       device=None, num_hosts: int = 1,
                       backend: Optional[str] = None,
                       model_size: int = 1) -> Replicas:
    """Join the group of `world` workers at tcp://address:port as `rank`,
    on `device` (by default the card of this host's rank: a CPU worker is
    asked for with torch.device("cpu")). The backend follows the device
    (NCCL for CUDA, gloo for the CPU) unless `backend` names one (gloo
    also takes CUDA tensors, and unlike NCCL puts several workers on one
    device). With `model_size` k > 1 the workers form the spatial layout's
    `data x model` grid; each model group (k consecutive ranks) must lie
    on one host. Raises if the group cannot form; there is no fallback to
    one process."""
    if world % num_hosts:
        raise ValueError(f"{world} workers do not split over {num_hosts} "
                         f"hosts.")
    if model_size < 1 or (world // num_hosts) % model_size:
        raise ValueError(f"A model group of {model_size} workers would span "
                         f"hosts of {world // num_hosts} workers each: the "
                         f"spatial layout keeps each group on one host.")
    if device is None:
        device = torch.device("cuda", rank % (world // num_hosts))
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend, init_method=f"tcp://{address}:{port}", rank=rank,
        world_size=world, timeout=TIMEOUT)
    model_group = None
    if model_size > 1:  # Every rank builds every group, in one order.
        for first in range(0, world, model_size):
            group = dist.new_group(list(range(first, first + model_size)))
            if first <= rank < first + model_size:
                model_group = group
    replicas = Replicas(rank=rank, world=world, num_hosts=num_hosts,
                        model_size=model_size, model_group=model_group)
    global _topology
    _topology = (num_hosts, replicas.host_id)
    return replicas


def destroy_process_group() -> None:
    global _topology
    _topology = (1, 0)
    if dist.is_initialized():
        dist.destroy_process_group()


def barrier(replicas: Optional[Replicas]) -> None:
    """Wait for every worker (no-op without a group). An all-reduce rather
    than `dist.barrier`, which NCCL runs on a device of its own choosing."""
    if replicas is None:
        return
    device = (torch.device("cuda", torch.cuda.current_device())
              if dist.get_backend(replicas.group) == "nccl"
              else torch.device("cpu"))
    dist.all_reduce(torch.zeros(1, device=device), group=replicas.group)


def _buckets(tensors: List[torch.Tensor]):
    """Indices of consecutive runs of tensors of one type and device, each
    run at most BUCKET_BYTES (a larger tensor alone)."""
    bucket, size = [], 0
    for i, t in enumerate(tensors):
        nbytes = t.numel() * t.element_size()
        if bucket and (size + nbytes > BUCKET_BYTES
                       or t.dtype != tensors[bucket[0]].dtype
                       or t.device != tensors[bucket[0]].device):
            yield bucket
            bucket, size = [], 0
        bucket.append(i)
        size += nbytes
    if bucket:
        yield bucket


@torch.no_grad()
def sum_over_replicas(tensors: List[torch.Tensor],
                      replicas: Optional[Replicas]) -> None:
    """Sum each tensor over the workers, in place, through flat buffers of
    at most BUCKET_BYTES rather than one call per tensor. For gradients
    this is the CrossShardOptimizer sum of the reference: each worker's
    loss is its share of the global-batch loss, so the sum is the global
    gradient."""
    if replicas is None:
        return
    for bucket in _buckets(tensors):
        flat = torch.cat([tensors[i].reshape(-1) for i in bucket])
        dist.all_reduce(flat, group=replicas.group)
        offset = 0
        for i in bucket:
            t = tensors[i]
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


@torch.no_grad()
def assert_replicated(tensors: Dict[str, torch.Tensor],
                      replicas: Optional[Replicas]) -> None:
    """Raise on every worker unless each tensor equals rank 0's bitwise
    (a desynced replica is the failure that no loss value shows)."""
    if replicas is None or replicas.world == 1:
        return
    names = sorted(tensors)
    raw = [tensors[n].contiguous().reshape(-1).view(torch.uint8)
           for n in names]
    differ = []
    for bucket in _buckets(raw):
        mine = torch.cat([raw[i] for i in bucket])
        chief = mine.clone()
        dist.broadcast(chief, src=0, group=replicas.group)
        offset = 0
        for i in bucket:
            end = offset + raw[i].numel()
            if not torch.equal(mine[offset:end], chief[offset:end]):
                differ.append(names[i])
            offset = end
    flag = torch.tensor([float(len(differ))], device=raw[0].device)
    dist.all_reduce(flag, group=replicas.group)
    if flag.item():
        raise AssertionError(
            f"Replicas differ from rank 0 (rank {replicas.rank}: "
            f"{differ[:10] or 'none here'}).")
