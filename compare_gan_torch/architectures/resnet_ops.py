"""ResNet building blocks (counterpart of
compare_gan_tpu/architectures/resnet_ops.py).

Scale convs are always the fused forms of the JAX default
(`resnet_ops.fused_scale_convs = True`): `UpConv2d` is exactly
conv2d(unpool(x)) with the zero-interleaving unpool, `DownConv2d` exactly
avg_pool(conv2d(x)). The unfused path is not ported.
"""

from __future__ import annotations

import math

from compare_gan_torch import core
from compare_gan_torch.ops import arch_ops as ops


def validate_image_inputs(shape, validate_power2=True):
    if len(shape) != 4:
        raise ValueError(f"Expected rank-4 image tensor, got {shape}.")
    if shape[1] != shape[2]:
        raise ValueError(f"Input tensor h != w: {shape}.")
    width = shape[1]
    if validate_power2 and math.log2(width) != int(math.log2(width)):
        raise ValueError(f"Width not a power of 2: {width}.")


def scale_conv(in_channels, out_channels, scale, kernel_size, use_sn,
               device):
    """(name, module) of a block's conv: `up_`/`down_`/`same_` prefix as in
    ResNetBlock._get_conv (resnet_ops.py:78-105)."""
    cls = {"up": ops.UpConv2d, "down": ops.DownConv2d,
           "none": ops.Conv2d}[scale]
    return cls(in_channels, out_channels, kernel_size[0], kernel_size[1],
               use_sn=use_sn, device=device)


def conv_name(scale, suffix):
    return "{}_{}".format("same" if scale == "none" else scale, suffix)


class ResNetBlock(core.Module):
    """Shared G/D block layout (resnet_ops.py:58-133): G scales in conv1,
    D in conv2."""

    def __init__(self, in_channels, out_channels, scale, is_gen_block,
                 spectral_norm=False):
        super().__init__()
        if scale not in ("up", "down", "none"):
            raise ValueError(f"Unknown scale {scale}.")
        self._in_channels = in_channels
        self._out_channels = out_channels
        self._scale = scale
        self._scale1 = scale if is_gen_block else "none"
        self._scale2 = "none" if is_gen_block else scale
        self._spectral_norm = spectral_norm
