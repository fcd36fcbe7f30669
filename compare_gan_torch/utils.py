"""Small helpers shared by the port (counterparts in
compare_gan_tpu/utils/misc.py, which imports jax)."""

from __future__ import annotations

import inspect


def call_with_accepted_args(fn, **kwargs):
    """Call fn with only the kwargs its signature accepts, looking through
    gin-configurable wrappers and classes to the real signature."""
    target = fn
    while hasattr(target, "__wrapped_fn__"):
        target = target.__wrapped_fn__
    if inspect.isclass(target):
        target = target.__init__
    sig = inspect.signature(target)
    if any(p.kind == inspect.Parameter.VAR_KEYWORD
           for p in sig.parameters.values()):
        return fn(**kwargs)
    return fn(**{k: v for k, v in kwargs.items() if k in sig.parameters})

