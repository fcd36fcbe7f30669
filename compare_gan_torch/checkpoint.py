"""Checkpoints: step-indexed `.npz` files (counterpart of
compare_gan_tpu/checkpoint.py).

`<model_dir>/model.ckpt-<step>.npz` holds the parameters, state and EMA
shadows under the JAX package's checkpoint keys (`.params['<name>']`, ...)
in the JAX layout (conv kernels HWIO), the step counters under `.step` and
`.disc_step`, and the port's own entries: the draw seed (`.seed`) and the
Adam moments (`.g_opt.count`, `.g_opt.mu['<name>']`, ...). A `checkpoint`
pointer file lists the retained checkpoints, oldest first.
"""

from __future__ import annotations

import os
import re
import threading
from typing import Dict, List, Optional

import numpy as np
import torch

from compare_gan_torch import interop

_CKPT_RE = re.compile(r"model\.ckpt-(\d+)\.npz$")


def checkpoint_path(model_dir: str, step: int) -> str:
    return os.path.join(model_dir, f"model.ckpt-{step}.npz")


def step_of(path: str) -> int:
    m = _CKPT_RE.search(path)
    if not m:
        raise ValueError(f"Not a checkpoint path: {path}")
    return int(m.group(1))


def _opt_arrays(prefix, opt) -> Dict[str, np.ndarray]:
    out = {f"{prefix}.count": np.asarray(opt.count, np.int32)}
    for moment in ("mu", "nu"):
        for name, v in getattr(opt, moment).items():
            out[f"{prefix}.{moment}['{name}']"] = interop.to_jax(v)
    return out


def to_arrays(ts) -> Dict[str, np.ndarray]:
    """Every entry of a checkpoint, as host numpy arrays."""
    arrays = {k: interop.to_jax(v)
              for k, v in interop.state_dict(ts).items()}
    arrays[".step"] = np.asarray(ts.step, np.int32)
    arrays[".disc_step"] = np.asarray(ts.disc_step, np.int32)
    arrays[".seed"] = np.asarray(ts.seed, np.int64)
    arrays.update(_opt_arrays(".g_opt", ts.g_opt))
    arrays.update(_opt_arrays(".d_opt", ts.d_opt))
    return arrays


def write_arrays(model_dir: str, arrays: Dict[str, np.ndarray], step: int,
                 keep_checkpoint_max: int = 1000) -> str:
    """Write atomically (tmp + rename), update the pointer file, drop the
    oldest checkpoints beyond `keep_checkpoint_max`."""
    os.makedirs(model_dir, exist_ok=True)
    path = checkpoint_path(model_dir, step)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)
    _update_pointer(model_dir, keep_checkpoint_max)
    return path


def save_checkpoint(model_dir: str, ts, step: int,
                    keep_checkpoint_max: int = 1000) -> str:
    return write_arrays(model_dir, to_arrays(ts), step, keep_checkpoint_max)


def _update_pointer(model_dir: str, keep_max: int) -> None:
    ckpts = sorted((p for p in os.listdir(model_dir) if _CKPT_RE.search(p)),
                   key=step_of)
    while len(ckpts) > keep_max:
        os.remove(os.path.join(model_dir, ckpts.pop(0)))
    with open(os.path.join(model_dir, "checkpoint"), "w") as f:
        if ckpts:
            f.write(f"model_checkpoint_path: \"{ckpts[-1]}\"\n")
            for c in ckpts:
                f.write(f"all_model_checkpoint_paths: \"{c}\"\n")


def all_checkpoints(model_dir: str) -> List[str]:
    pointer = os.path.join(model_dir, "checkpoint")
    if not os.path.exists(pointer):
        return []
    out = []
    with open(pointer) as f:
        for line in f:
            if line.startswith("all_model_checkpoint_paths:"):
                out.append(os.path.join(model_dir, line.split('"')[1]))
    return [p for p in out if os.path.exists(p)]


def latest_checkpoint(model_dir: str) -> Optional[str]:
    ckpts = all_checkpoints(model_dir)
    return ckpts[-1] if ckpts else None


@torch.no_grad()
def _load_opt(data, prefix, opt) -> None:
    opt.count = int(data[f"{prefix}.count"])
    for moment in ("mu", "nu"):
        for name, target in getattr(opt, moment).items():
            target.copy_(interop.to_port(data[f"{prefix}.{moment}['{name}']"]))


def restore_checkpoint(path: str, ts):
    """Load a checkpoint into a TrainState built from the same config;
    returns the TrainState."""
    with np.load(path) as data:
        values = {k: interop.to_port(data[k]) for k in data.files
                  if k.startswith((".params", ".state", ".ema_params"))}
        interop.load_state_dict(ts, values)
        _load_opt(data, ".g_opt", ts.g_opt)
        _load_opt(data, ".d_opt", ts.d_opt)
        ts.step = int(data[".step"])
        ts.disc_step = int(data[".disc_step"])
        ts.seed = int(data[".seed"])
    return ts


class AsyncCheckpointSaver:
    """Copies to the host on the caller's thread, writes the file on a
    background thread; saves realign to multiples of
    `save_checkpoint_steps` after a restart."""

    def __init__(self, model_dir: str, save_checkpoint_steps: int = 5000,
                 keep_checkpoint_max: int = 1000):
        self._model_dir = model_dir
        self._every = save_checkpoint_steps
        self._keep = keep_checkpoint_max
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._next_due = save_checkpoint_steps

    def align(self, step: int) -> None:
        self._next_due = (step // self._every + 1) * self._every

    def should_save(self, step: int) -> bool:
        return step >= self._next_due

    def save(self, ts, step: int) -> None:
        self.align(step)
        self.join()  # One write in flight at a time.
        arrays = to_arrays(ts)  # Device -> host now.

        def work():
            try:
                write_arrays(self._model_dir, arrays, step, self._keep)
            except Exception as e:  # Re-raised by join().
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def join(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err
