"""Variable naming, seeded initialization, state commits and structural tags.

Counterpart of compare_gan_tpu/core.py. The JAX package declares variables
through a build context and returns updated state explicitly; the port keeps
them in `nn.Module`s and updates state buffers in place. What stays the same:

* Names. A module tree mirrors the JAX scope tree, so a variable's JAX name is
  its dotted torch path with "/" for "." under the model's prefix
  (`generator/B1/bn1/condition/gamma/kernel`). State that JAX keeps under a
  sub-path of a layer (`kernel/u_var`, `accu/accu_mean`) is a buffer whose
  name holds the "/".
* Commits. Every forward computes its state updates; `set_state` writes them
  unless the caller opened `no_state_updates()` (core.py:151 in the JAX
  package), as for the penalty's D forwards.
* Tags. `standardize_batch` tags "batch_coupled" in training mode, scoped by
  the module's JAX path, and `experimental_fake_only_g_loss` checks the tags
  recorded by the D forward of the G sub-step (core.py:166-185).
"""

from __future__ import annotations

import contextlib
import hashlib
import math
import threading
from typing import Callable, Dict, Optional

import torch
from torch import nn

_local = threading.local()


def jax_name(prefix: str, torch_name: str) -> str:
    """`B1.bn1.condition.gamma.kernel` under `generator` ->
    `generator/B1/bn1/condition/gamma/kernel`."""
    return f"{prefix}/{torch_name.replace('.', '/')}" if prefix else \
        torch_name.replace(".", "/")


def seed_for(seed: int, name: str) -> int:
    """A 63-bit seed derived from (seed, name), stable across processes."""
    digest = hashlib.sha256(f"{int(seed)}/{name}".encode()).digest()
    return int.from_bytes(digest[:8], "little") % (2 ** 63)


class Module(nn.Module):
    """nn.Module whose variables carry their initializer and JAX layout.

    `add_param` / `add_state` register a tensor together with the function
    that fills it (see `initialize`). `init(shape, generator, device, dtype)`
    returns a tensor in the JAX layout `shape`; `permute`, when given, maps
    it to the layout the port stores (HWIO -> OIHW for conv kernels).
    """

    def __init__(self):
        super().__init__()
        self._initializers: Dict[str, tuple] = {}
        self.scope = ""

    def add_param(self, name, shape, init: Callable, device,
                  permute=None) -> nn.Parameter:
        stored = _permuted_shape(shape, permute)
        self.register_parameter(
            name, nn.Parameter(torch.empty(stored, device=device)))
        self._initializers[name] = (init, tuple(shape), permute)
        return self._parameters[name]

    def add_state(self, name, shape, init: Callable, device,
                  dtype=torch.float32) -> torch.Tensor:
        self.register_buffer(name, torch.empty(tuple(shape), device=device,
                                               dtype=dtype))
        self._initializers[name] = (init, tuple(shape), None)
        return self._buffers[name]


def _permuted_shape(shape, permute):
    shape = tuple(shape)
    return shape if permute is None else tuple(shape[i] for i in permute)


def assign_scopes(root: nn.Module, prefix: str) -> None:
    """Record each submodule's JAX scope path (used by `tag`)."""
    for name, module in root.named_modules():
        if isinstance(module, Module):
            module.scope = jax_name(prefix, name) if name else prefix


@torch.no_grad()
def initialize(root: nn.Module, prefix: str, seed: int) -> None:
    """Fill every declared variable of `root` from its own generator, seeded
    by (seed, JAX name): a variable's initial value does not depend on the
    order in which modules were built. Tensors on the meta device are left
    as they are (shape-only builds)."""
    for mod_name, module in root.named_modules():
        inits = getattr(module, "_initializers", None)
        if not inits:
            continue
        for var_name, (init, shape, permute) in inits.items():
            tensor = module._parameters.get(var_name)
            if tensor is None:
                tensor = module._buffers[var_name]
            if tensor.device.type == "meta":
                continue
            full = jax_name(prefix, f"{mod_name}.{var_name}" if mod_name
                            else var_name)
            gen = torch.Generator(device=tensor.device)
            gen.manual_seed(seed_for(seed, full))
            value = init(shape, gen, tensor.device, tensor.dtype)
            if permute is not None:
                value = value.permute(*permute)
            tensor.copy_(value)


def named_variables(root: nn.Module, prefix: str):
    """({jax_name: parameter}, {jax_name: buffer}) of a module tree."""
    params = {jax_name(prefix, n): p for n, p in root.named_parameters()}
    buffers = {jax_name(prefix, n): b for n, b in root.named_buffers()}
    return params, buffers


def count_params(root: nn.Module) -> int:
    return sum(math.prod(p.shape) for p in root.parameters())


# ---------------------------------------------------------------------------
# State commits
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def no_state_updates():
    """Suppress `set_state` commits within scope (reads still see the latest
    committed value)."""
    prev = getattr(_local, "frozen", False)
    _local.frozen = True
    try:
        yield
    finally:
        _local.frozen = prev


@torch.no_grad()
def set_state(buffer: torch.Tensor, value: torch.Tensor) -> None:
    """Commit `value` into a state buffer, unless commits are suppressed."""
    if not getattr(_local, "frozen", False):
        buffer.copy_(value)


# ---------------------------------------------------------------------------
# Structural tags
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def collect_tags():
    """Collect the tags recorded by forwards run inside the block."""
    prev = getattr(_local, "tags", None)
    tags: set = set()
    _local.tags = tags
    try:
        yield tags
    finally:
        _local.tags = prev


def tag(module: Module, name: str) -> None:
    """Record `<module's JAX path>/<name>` if a collector is open. Tags are
    not suppressed by no_state_updates(): they describe the computation's
    structure, not committed values."""
    tags: Optional[set] = getattr(_local, "tags", None)
    if tags is not None:
        tags.add(f"{module.scope}/{name}" if module.scope else name)
