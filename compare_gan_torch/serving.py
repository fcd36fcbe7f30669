"""Serve G from the program `export.export_serving_program` writes.

    spec, signatures = load_serving_program(export_dir)          # the card
    images = signatures["gen_bs8"](z, labels)   # z [8, z_dim], labels [8]

The counterpart of loading the JAX package's jax2tf SavedModel
(`tf.saved_model.load(d).signatures`): one function per batch signature
`gen_bs<N>`, z float32 [N, z_dim] and labels int32 [N] to images
[N, H, W, C] in [0, 1] on the program's device. A label outside
[0, num_classes) conditions on an all-zero row; an unconditional G ignores
the labels.

The loader is self-contained: it reads the program and its JSON spec and
imports torch and the attention operator's registration
(`ops.fused_attention`, built from `csrc/attention.cu`), and no model code,
gin config or training code of the port.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Dict, Tuple

import torch

from compare_gan_torch.ops import _build
from compare_gan_torch.ops import fused_attention  # noqa: F401 (the op)

SERVING_PROGRAM = "generator.pt2"
SERVING_SPEC = "serving_spec.json"


def _signature(program, spec, batch_size, device) -> Callable:
    z_dim = int(spec["z_dim"])

    def generate(z, labels):
        z = torch.as_tensor(z, device=device)
        labels = torch.as_tensor(labels, device=device)
        if tuple(z.shape) != (batch_size, z_dim) or \
                tuple(labels.shape) != (batch_size,):
            raise ValueError(
                f"gen_bs{batch_size} takes z [{batch_size}, {z_dim}] and "
                f"labels [{batch_size}]; got z {tuple(z.shape)}, labels "
                f"{tuple(labels.shape)}.")
        if z.dtype != torch.float32 or labels.is_floating_point():
            raise TypeError(f"z must be float32 and labels integers; got "
                            f"{z.dtype} and {labels.dtype}.")
        with torch.no_grad():
            return program(z, labels.to(torch.int32))

    return generate


def load_serving_program(export_dir: str, device="cuda"
                         ) -> Tuple[dict, Dict[str, Callable]]:
    """(spec, {"gen_bs8": fn, ...}): the program of `export_dir` on
    `device`, each signature fn(z, labels) -> images. Raises when CUDA is
    asked for and absent, and when the kernel library does not build:
    the program never switches to the plain operator by itself."""
    from torch.export.passes import move_to_device_pass

    with open(os.path.join(export_dir, SERVING_SPEC)) as f:
        spec = json.load(f)
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("load_serving_program: CUDA was asked for "
                               "and torch.cuda.is_available() is False.")
        _build.library()
    elif device.type != "cpu":
        raise ValueError(f"The serving program runs on cuda or cpu, not "
                         f"{device}.")
    program = torch.export.load(os.path.join(export_dir, SERVING_PROGRAM))
    module = move_to_device_pass(program, device).module()
    return spec, {name: _signature(module, spec, bs, device)
                  for name, bs in spec["signatures"].items()}
