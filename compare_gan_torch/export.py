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
the other.

`import_reference_checkpoint` loads a google/compare_gan TF Saver
checkpoint or TF-Hub module into a TrainState, and
`export_reference_checkpoint` writes one back with the reference's variable
names, as the JAX package's functions of the same names do; both read and
write TensorFlow's V2 checkpoint format themselves (`tf_io`), without
TensorFlow. The export writes no `.meta` graph (see
`tf_io.checkpoint_bundle`).

`export_serving_program` is the counterpart of the JAX package's jax2tf
SavedModel export: G traced by `torch.export` into one program with a
dynamic batch, served at the reference's TF-Hub batch signatures
(`gen_bs8` ... `gen_bs64`) by `serving.load_serving_program` without any
model code. It writes no TF SavedModel.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
from typing import Callable, Dict, Tuple

import numpy as np
import torch

from compare_gan_torch import config as gin
from compare_gan_torch import core
from compare_gan_torch import interop
from compare_gan_torch import serving
from compare_gan_torch import utils
from compare_gan_torch.ops import rng as rng_ops
from compare_gan_torch.tf_io import checkpoint_bundle


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
    # As jax.nn.one_hot: a label outside [0, num_classes) is an all-zero
    # row (F.one_hot raises on it).
    classes = torch.arange(spec["num_classes"], device=device)
    return (labels.long()[:, None] == classes).float()


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


# ---------------------------------------------------------------------------
# The serving program (counterpart of the jax2tf SavedModel export)
# ---------------------------------------------------------------------------

class _ServingGenerator(torch.nn.Module):
    """(z [B, z_dim] f32, labels [B] int32) -> images [B, H, W, C]: the G
    of `ts` in eval mode on the one-hot of the labels (any state of the
    GAN's config, as `ModularGAN.sample` takes it); an unconditional G
    takes the labels and ignores them, as the JAX signature does."""

    def __init__(self, gan, ts):
        super().__init__()
        self.generator = ts.generator
        self._gan = gan

    def forward(self, z, labels):
        y = (self._gan._get_one_hot_labels(labels) if self._gan.conditional
             else None)
        return self.generator(z, y=y, is_training=False)


def export_serving_program(gan, ts, export_dir: str,
                           batch_sizes=(8, 16, 32, 64)) -> str:
    """Write G as a self-contained serving program: <export_dir>/
    {generator.pt2, serving_spec.json}. The counterpart of the JAX
    package's `export_saved_model`, at its signatures `gen_bs<N>`
    (the reference's TF-Hub batch tags, modular_gan.py:289-306); it
    writes no TF SavedModel.

    The program computes `ts.generator(z, y=one_hot(labels),
    is_training=False)` on `gan._inference_params(ts)` (G's EMA shadows)
    and the state of `ts`, committing no state, under the live gin config:
    `ts` may come from another GAN object of the same config, as JAX's
    functional export applies `gan.generator` to any state's variables.
    `torch.export` traces it once with a dynamic batch dimension, so the
    weights are stored once (as the JAX export keeps them in shared
    variables, not once per signature); `serving.load_serving_program`
    checks each signature's batch size. The non-local blocks are nodes of
    the registered operator `compare_gan::attention_fwd`, whose device is
    chosen when the program runs. Weights are saved on the CPU; the loader
    moves them. The spec holds the signature names, z_dim, conditional,
    num_classes, image_shape, the type the program computes in and the
    step. Returns `export_dir`."""
    from torch.export.passes import move_to_device_pass

    os.makedirs(export_dir, exist_ok=True)
    batch_sizes = sorted(int(bs) for bs in batch_sizes)
    batch = torch.export.Dim("batch", min=1, max=batch_sizes[-1])
    example = (torch.zeros(batch_sizes[-1], gan.z_dim, device=gan.device),
               torch.zeros(batch_sizes[-1], dtype=torch.int32,
                           device=gan.device))
    with torch.no_grad(), core.no_state_updates(), \
            gan._inference_weights(ts):
        program = torch.export.export(
            _ServingGenerator(gan, ts), example,
            dynamic_shapes={"z": {0: batch}, "labels": {0: batch}})
        # Inside the swap: the copy to the CPU takes the EMA shadows.
        program = move_to_device_pass(program, "cpu")
    out = [n for n in program.graph.nodes if n.op == "output"][0]
    images = out.args[0][0].meta["val"]
    torch.export.save(program,
                      os.path.join(export_dir, serving.SERVING_PROGRAM))
    spec = {
        "signatures": {f"gen_bs{bs}": bs for bs in batch_sizes},
        "z_dim": gan.z_dim,
        "conditional": gan.conditional,
        "num_classes": gan.dataset.num_classes,
        "image_shape": list(gan.dataset.image_shape),
        "dtype": str(images.dtype).replace("torch.", ""),
        "step": int(ts.step),
    }
    with open(os.path.join(export_dir, serving.SERVING_SPEC), "w") as f:
        json.dump(spec, f, indent=2)
    return export_dir


# ---------------------------------------------------------------------------
# Reference TF checkpoints: import into a TrainState, export from one
# ---------------------------------------------------------------------------

# Optimizer slot variables the reference's TF Saver checkpoints carry but a
# TrainState import skips (fresh optimizer state is created instead):
# "<var>/Adam", "<var>/Adam_1", Momentum/RMSProp slots, and the Adam power
# counters ("beta1_power", sometimes suffixed).
_TF_OPT_SLOT = re.compile(
    r".*/(Adam|Momentum|RMSProp)(_\d+)?$|^beta[12]_power(_\d+)?$")

# Variable-name suffixes that live in the state, not the params (reference
# arch_ops.py: u_var :488-497, moving_* :88-95, accu/* :141-168).
_TF_STATE_SUFFIXES = ("/u_var", "/moving_mean", "/moving_variance",
                      "/accu_mean", "/accu_variance", "/accu_counter",
                      "/update_accus")

_TF_EMA_SUFFIX = "/ExponentialMovingAverage"


def classify_tf_variable(name: str):
    """('param'|'state'|'ema'|'step'|'disc_step'|'skip', target name) of a
    reference TF variable. Both packages name variables by the reference's
    variable_scope paths, so the map is near identity: what remains is
    sorting each variable into its TrainState tree."""
    if name.startswith("module/"):  # Hub-module instantiation scope.
        name = name[len("module/"):]
    if name in ("global_step", "global_step/ExponentialMovingAverage"):
        return ("step" if name == "global_step" else "skip"), name
    if name == "global_step_disc":
        return "disc_step", name
    if _TF_OPT_SLOT.match(name):
        return "skip", name
    if name.endswith(_TF_EMA_SUFFIX):
        return "ema", name[: -len(_TF_EMA_SUFFIX)]
    if name.endswith(_TF_STATE_SUFFIXES):
        return "state", name
    if name.startswith(("generator/", "discriminator/")):
        return "param", name
    return "skip", name


def _jax_shape(tensor: torch.Tensor) -> Tuple[int, ...]:
    """The JAX-layout shape of a port tensor (OIHW -> HWIO)."""
    shape = tuple(tensor.shape)
    return (shape[2], shape[3], shape[1], shape[0]) if len(shape) == 4 \
        else shape


def import_reference_checkpoint(gan, checkpoint_path: str,
                                batch_size: int = 8, seed: int = 42):
    """Load a reference (google/compare_gan) TF Saver checkpoint or TF-Hub
    module into a TrainState for this port's `gan` (the counterpart of the
    JAX package's function of the same name).

    `checkpoint_path` is a Saver prefix, a model_dir with a `checkpoint`
    pointer or a TF-Hub module dir. Variables go into the params, state and
    EMA trees by name (layouts agree with the JAX package's: conv kernels
    HWIO, deconv kernels HWOI, linear [in, out], SN u_var, BN moving_* and
    accu_*), permuted into the port's OIHW / IOHW; both step counters are
    restored; optimizer state is fresh (the checkpoint's Adam slots are
    skipped). `batch_size` is accepted for the JAX signature: the variables
    do not depend on it.

    Raises ValueError listing missing and extra variables if the checkpoint
    does not exactly cover the gan's parameter and state trees: a silent
    partial import would give a subtly wrong model.
    """
    del batch_size
    reader = checkpoint_bundle.CheckpointReader(
        checkpoint_bundle.resolve_checkpoint(checkpoint_path))
    names = sorted(reader.variable_to_shape_map())

    template = gan.init_state(seed)
    trees: Dict[str, Dict] = {"param": {}, "state": {}, "ema": {}}
    step = disc_step = None
    for name in names:
        kind, key = classify_tf_variable(name)
        if kind == "skip":
            continue
        value = reader.get_tensor(name)
        if kind == "step":
            step = int(value)
        elif kind == "disc_step":
            disc_step = int(value)
        else:
            trees[kind][key] = value

    def _check(got: dict, want: dict, tree_name: str, group: str):
        missing = sorted(set(want) - set(got))
        extra = sorted(set(got) - set(want))
        if missing or extra:
            raise ValueError(
                f"TF checkpoint does not match the gan's {tree_name} tree."
                f" Missing: {missing[:5]}{'...' if len(missing) > 5 else ''}"
                f" Extra: {extra[:5]}{'...' if len(extra) > 5 else ''}")
        out = {}
        for k, v in want.items():
            arr = np.asarray(got[k])
            if arr.shape != _jax_shape(v):
                raise ValueError(
                    f"Shape mismatch for {k}: checkpoint {arr.shape} vs "
                    f"model {_jax_shape(v)}.")
            out[interop.key(group, k)] = interop.to_port(arr)
        return out

    values = {**_check(trees["param"], template.params(), "params",
                       "params"),
              **_check(trees["state"], template.state(), "state", "state")}
    if template.ema_params:
        values.update(_check(trees["ema"], template.ema_params, "ema_params",
                             "ema_params"))
    elif trees["ema"]:
        raise ValueError(
            "Checkpoint carries EMA shadows but the gan was built with "
            "g_use_ema=False; construct it with g_use_ema=True so the "
            "reference's EMA-at-export semantics apply.")
    interop.load_state_dict(template, values)
    template.step = step if step is not None else 0
    template.disc_step = disc_step if disc_step is not None else 0
    return template


def export_reference_checkpoint(gan, ts, prefix: str) -> str:
    """Inverse of import_reference_checkpoint: write this TrainState as a TF
    V2 checkpoint `prefix` with the reference's variable names (params,
    state, EMA shadows under "<name>/ExponentialMovingAverage",
    `global_step` int64 and `global_step_disc` int32), so models trained
    here load into google/compare_gan (its eval stack, TF-Hub export flow,
    or as a warm start). Optimizer slots are not written: the reference
    recreates Adam slots on first use. No `.meta` graph is written; the
    reference's Saver, built from its own graph, restores without one.
    Returns `prefix`."""
    del gan  # The JAX signature; the TrainState holds everything.
    tensors = {name: interop.to_jax(v)
               for tree in (ts.params(), ts.state())
               for name, v in tree.items()}
    for name, v in ts.ema_params.items():
        tensors[name + _TF_EMA_SUFFIX] = interop.to_jax(v)
    tensors["global_step"] = np.asarray(int(ts.step), np.int64)
    tensors["global_step_disc"] = np.asarray(int(ts.disc_step), np.int32)
    return checkpoint_bundle.write_checkpoint(prefix, tensors)
