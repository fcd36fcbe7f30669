"""Shared helpers of the port's parity tests (tests/test_torch_*.py).

Importing this module pins torch to one thread: the tests run in several
xdist workers on one host, and torch's default thread count per worker
would oversubscribe it.
"""

import numpy as np
import torch

torch.set_num_threads(1)


def randn(shape, seed, scale=1.0):
    """float32 normal draws from numpy, for feeding both packages."""
    return (scale * np.random.RandomState(seed).randn(*shape)).astype(
        np.float32)


def np32(x):
    """A jax array, torch tensor or numpy array as a float32 numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def assert_close(got, want, rtol, atol, what=""):
    np.testing.assert_allclose(np32(got), np32(want), rtol=rtol, atol=atol,
                               err_msg=what)


def load_jax(module, prefix, params, state=None):
    """Copy JAX variables (keyed by JAX name) into a port module whose
    variables are named under `prefix`; the two name sets must be equal."""
    from compare_gan_torch import core, interop
    p, b = core.named_variables(module, prefix)
    want = {**p, **b}
    have = {**params, **(state or {})}
    assert set(want) == set(have), sorted(set(want) ^ set(have))
    with torch.no_grad():
        for k, t in want.items():
            t.copy_(interop.to_port(have[k]))
