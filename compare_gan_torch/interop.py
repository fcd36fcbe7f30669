"""Carry variables between the JAX package and the port.

Both packages name every variable by its JAX scope path
(`generator/B1/bn1/condition/gamma/kernel`, `.../kernel/u_var`). The JAX
package stores conv kernels HWIO; the port stores them OIHW (`F.conv2d`'s
layout). The same permutation takes a transposed conv's HWOI kernel
(`deconv2d`) to IOHW, `F.conv_transpose2d`'s layout. Every other variable
has the same shape in both.

A port state dict is flat and keyed as the JAX checkpoint keys its
TrainState leaves (`jax.tree_util.keystr`): `.params['<name>']`,
`.state['<name>']`, `.ema_params['<name>']`.
"""

from __future__ import annotations

import re
from typing import Dict, Optional, Tuple

import numpy as np
import torch

GROUPS = ("params", "state", "ema_params")
_KEY_RE = re.compile(r"^\.(params|state|ema_params)\['(.+)'\]$")


def key(group: str, name: str) -> str:
    return f".{group}['{name}']"


def to_port(value) -> torch.Tensor:
    """A JAX-layout array as a port-layout tensor (HWIO -> OIHW)."""
    t = torch.from_numpy(np.array(value))
    return t.permute(3, 2, 0, 1).contiguous() if t.dim() == 4 else t


def to_jax(tensor: torch.Tensor) -> np.ndarray:
    """A port-layout tensor as a JAX-layout numpy array (OIHW -> HWIO)."""
    t = tensor.detach().cpu()
    if t.dim() == 4:
        t = t.permute(2, 3, 1, 0)
    return t.contiguous().numpy()


def params_from_jax(params: Dict, state: Dict,
                    ema_params: Optional[Dict] = None
                    ) -> Dict[str, torch.Tensor]:
    """JAX variables (numpy or jax arrays keyed by JAX name) -> port state
    dict."""
    out = {}
    for group, tree in zip(GROUPS, (params, state, ema_params or {})):
        for name, value in tree.items():
            out[key(group, name)] = to_port(value)
    return out


def params_to_jax(state_dict: Dict[str, torch.Tensor]
                  ) -> Tuple[Dict, Dict, Dict]:
    """The inverse of params_from_jax: (params, state, ema_params) as
    numpy arrays in the JAX layout. Keys of other groups are ignored."""
    out = {g: {} for g in GROUPS}
    for k, v in state_dict.items():
        m = _KEY_RE.match(k)
        if m:
            out[m.group(1)][m.group(2)] = to_jax(v)
    return out["params"], out["state"], out["ema_params"]


def state_dict(ts) -> Dict[str, torch.Tensor]:
    """The live tensors of a TrainState (port layout), keyed as above."""
    out = {}
    for group, tree in zip(GROUPS, (ts.params(), ts.state(), ts.ema_params)):
        for name, value in tree.items():
            out[key(group, name)] = value
    return out


@torch.no_grad()
def load_state_dict(ts, values: Dict[str, torch.Tensor]) -> None:
    """Copy `values` into the TrainState's variables. Every variable of the
    TrainState must be present with its shape; extra keys are an error."""
    targets = state_dict(ts)
    missing = sorted(set(targets) - set(values))
    extra = sorted(k for k in set(values) - set(targets) if _KEY_RE.match(k))
    if missing or extra:
        raise KeyError(f"State dict does not match the model: missing "
                       f"{missing[:5]}, unexpected {extra[:5]} "
                       f"({len(missing)} missing, {len(extra)} unexpected).")
    for k, target in targets.items():
        value = values[k]
        if tuple(value.shape) != tuple(target.shape):
            raise ValueError(f"{k}: shape {tuple(value.shape)} != "
                             f"{tuple(target.shape)}.")
        target.copy_(value.to(device=target.device, dtype=target.dtype))
