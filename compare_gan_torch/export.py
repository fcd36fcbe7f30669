"""Module exports (counterpart of compare_gan_tpu/export.py, the TF-Hub
module surface).

An export directory holds what it takes to rebuild G and D without the
training config:

* `module.npz`: the inference params (G's swapped for their EMA shadows)
  under `params/<JAX name>` and the state (SN u, BN statistics and
  accumulators) under `state/<JAX name>`, in the JAX layout (conv kernels
  HWIO);
* `module_spec.json`: architecture, dataset, z_dim, conditional,
  num_classes, image_shape, tags and step;
* `export_config.gin`: the gin snapshot the networks are rebuilt under.

The layout is the JAX package's, so an export of either package loads in
the other. The TF checkpoint import and export and the jax2tf SavedModel of
the JAX package are not ported.
"""

from __future__ import annotations

import contextlib
import json
import os
from typing import Callable, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from compare_gan_torch import config as gin
from compare_gan_torch import core
from compare_gan_torch import interop
from compare_gan_torch import utils
from compare_gan_torch.ops import rng as rng_ops


def _export_config_scope(spec):
    """The export's gin snapshot, isolated from the live bindings, when it
    has one; else a passthrough."""
    text = spec.get("_config_text", "")
    return gin.config_scope(text) if text else contextlib.nullcontext()


def snapshot_z(spec, shape, generator: torch.Generator,
               prefer_eval_scope=False):
    """Draw z as the export's gin snapshot says: its training prior (scope
    `z`) or, with `prefer_eval_scope`, the `eval_z` scope whenever the
    snapshot binds any of its knobs."""
    from compare_gan_torch import eval_gan_lib

    with _export_config_scope(spec):
        knobs = ("distribution_fn", "minval", "maxval", "stddev")
        if prefer_eval_scope and any(
                gin.query(f"eval_z.{k}", default=None) is not None
                for k in knobs):
            return eval_gan_lib.z_generator(shape, generator)
        return utils.call_with_accepted_args(
            gin.query("z.distribution_fn", default=rng_ops.uniform),
            shape=shape, generator=generator,
            minval=gin.query("z.minval", default=-1.0),
            maxval=gin.query("z.maxval", default=1.0),
            stddev=gin.query("z.stddev", default=1.0))


def sample_z(spec, n, seed=0, prefer_eval_scope=True) -> np.ndarray:
    """[n, z_dim] float32 latents per the export's snapshot, from a CPU
    generator seeded with `seed`."""
    gen = torch.Generator().manual_seed(int(seed))
    z = snapshot_z(spec, [int(n), int(spec["z_dim"])], gen,
                   prefer_eval_scope=prefer_eval_scope)
    return z.float().numpy()


def export_module(gan, ts, export_dir: str) -> str:
    """Write <export_dir>/{module.npz, module_spec.json,
    export_config.gin}."""
    os.makedirs(export_dir, exist_ok=True)
    with open(os.path.join(export_dir, "export_config.gin"), "w") as f:
        f.write(gin.config_str())
    arrays = {}
    for prefix, tree in (("params", gan._inference_params(ts)),
                         ("state", ts.state())):
        for k, v in tree.items():
            arrays[f"{prefix}/{k}"] = interop.to_jax(v)
    with open(os.path.join(export_dir, "module.npz"), "wb") as f:
        np.savez(f, **arrays)
    spec = {
        "architecture": gan._architecture,
        "dataset": gan.dataset.name,
        "z_dim": gan.z_dim,
        "conditional": gan.conditional,
        "num_classes": gan.dataset.num_classes,
        "image_shape": list(gan.dataset.image_shape),
        "tags": ["gen", "disc"],
        "step": int(ts.step),
    }
    with open(os.path.join(export_dir, "module_spec.json"), "w") as f:
        json.dump(spec, f, indent=2)
    return export_dir


def _load(export_dir: str):
    """(spec with its gin snapshot under "_config_text", params, state):
    the arrays as stored, JAX layout."""
    with open(os.path.join(export_dir, "module_spec.json")) as f:
        spec = json.load(f)
    cfg = os.path.join(export_dir, "export_config.gin")
    spec["_config_text"] = ""
    if os.path.exists(cfg):
        with open(cfg) as f:
            spec["_config_text"] = f.read()
    params, state = {}, {}
    with np.load(os.path.join(export_dir, "module.npz")) as data:
        for k in data.files:
            kind, name = k.split("/", 1)
            (params if kind == "params" else state)[name] = data[k]
    return spec, params, state


def _build_arch(spec, kind, device):
    """G ("gen") or D ("disc") of the spec on `device`, uninitialized; call
    inside the export's config scope."""
    from compare_gan_torch.architectures import DISCRIMINATORS, GENERATORS
    num_classes = spec["num_classes"] if spec["conditional"] else None
    image_shape = tuple(spec["image_shape"])
    if kind == "gen":
        module = GENERATORS[spec["architecture"]](
            image_shape=image_shape, z_dim=spec["z_dim"],
            num_classes=num_classes, device=device)
    else:
        module = DISCRIMINATORS[spec["architecture"]](
            image_shape=image_shape, num_classes=num_classes, device=device)
    core.assign_scopes(module, module.name)
    return module


@torch.no_grad()
def _load_variables(module, params: Dict, state: Dict) -> None:
    """Copy the module's variables out of JAX-layout arrays keyed by JAX
    name; every variable of the module must be there."""
    targets = {**core.named_variables(module, module.name)[0],
               **core.named_variables(module, module.name)[1]}
    values = {**params, **state}
    missing = sorted(set(targets) - set(values))
    if missing:
        raise KeyError(f"Export lacks {len(missing)} variables of "
                       f"{module.name}: {missing[:5]}")
    for name, target in targets.items():
        target.copy_(interop.to_port(values[name]).to(target.dtype))


def _loaded(export_dir, kind, device):
    spec, params, state = _load(export_dir)
    with _export_config_scope(spec):
        module = _build_arch(spec, kind, torch.device(device))
    _load_variables(module, params, state)
    return spec, module


def _one_hot(spec, labels, n, device):
    if not spec["conditional"]:
        return None
    if labels is None:
        raise ValueError("A conditional export needs labels.")
    labels = torch.as_tensor(np.array(labels), device=device)
    if len(labels) != n:
        raise ValueError(f"{len(labels)} labels for a batch of {n}.")
    return F.one_hot(labels.long(), spec["num_classes"]).float()


def load_generator(export_dir: str, device="cuda"
                   ) -> Tuple[Callable, dict]:
    """(generate(z, labels=None) -> images [B, H, W, C] on `device`, spec):
    the "gen" tag, in eval mode, committing no state."""
    spec, generator = _loaded(export_dir, "gen", device)

    def generate(z, labels=None):
        z = torch.as_tensor(np.array(z, np.float32), device=device)
        y = _one_hot(spec, labels, len(z), device)
        with _export_config_scope(spec), torch.no_grad(), \
                core.no_state_updates():
            return generator(z, y=y, is_training=False)

    return generate, spec


def load_discriminator(export_dir: str, device="cuda"
                       ) -> Tuple[Callable, dict]:
    """(discriminate(images, labels=None) -> (prediction, logits,
    features), spec): the "disc" tag, in eval mode."""
    spec, discriminator = _loaded(export_dir, "disc", device)

    def discriminate(images, labels=None):
        images = torch.as_tensor(np.array(images, np.float32),
                                 device=device)
        y = _one_hot(spec, labels, len(images), device)
        with _export_config_scope(spec), torch.no_grad(), \
                core.no_state_updates():
            return discriminator(images, y=y, is_training=False)

    return discriminate, spec
