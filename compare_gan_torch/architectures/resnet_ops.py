"""ResNet building blocks (counterpart of
compare_gan_tpu/architectures/resnet_ops.py).

Scale convs follow `resnet_ops.fused_scale_convs` (default True), read when
a block is built. Fused, `UpConv2d` is exactly conv2d(unpool(x)) with the
zero-interleaving unpool and `DownConv2d` exactly avg_pool(conv2d(x)), each
as one conv; unfused, the unpool and the pool run as their own ops around a
plain conv. Both hold their variables under the same names.
"""

from __future__ import annotations

import math

import torch.nn.functional as F

from compare_gan_torch import config as gin
from compare_gan_torch import core
from compare_gan_torch.architectures import abstract_arch
from compare_gan_torch.ops import arch_ops as ops
from compare_gan_torch.parallel import tpu_ops


@gin.configurable("resnet_ops")
def fusion_options(fused_scale_convs=True):
    """`resnet_ops.fused_scale_convs`: fuse unpool + conv and conv +
    avg_pool into one conv each (resnet_ops.py:22-28)."""
    return fused_scale_convs


def unpool(value):
    """Zero-interleaved 2x upsampling of NHWC: value[b, i, j, c] ->
    out[b, 2i, 2j, c], zeros at the other three cell positions
    (resnet_ops.py:31-39). In the spatial layout a band's output is the
    band of the whole map's, and a whole map's goes back to bands where
    its height splits."""
    band = tpu_ops.is_band(value, "unpool")
    value = tpu_ops.plain(value)
    b, h, w, c = value.shape
    out = value.new_zeros((b, 2 * h, 2 * w, c))
    out[:, ::2, ::2] = value
    return tpu_ops.as_band(out) if band else tpu_ops.split_bands(out,
                                                                 "unpool")


def avg_pool_2x2(x):
    """2x2 average pooling of NHWC `x`. In the spatial layout a band of an
    even row count pools in place; one of an odd row count, whose 2x2
    cells would straddle two bands, is gathered and pooled whole, and the
    whole map goes back to bands where its height splits."""
    band = tpu_ops.is_band(x, "avg_pool_2x2")
    if band and x.shape[1] % 2:
        x, band = tpu_ops.gather_bands(x), False
    b, h, w, c = x.shape
    out = tpu_ops.plain(x).reshape(b, h // 2, 2, w // 2, 2, c).mean(
        dim=(2, 4))
    return tpu_ops.as_band(out) if band else tpu_ops.split_bands(
        out, "avg_pool_2x2")


class UnpoolConv2d(ops.Conv2d):
    """conv2d(unpool(x)): the unfused "up" conv."""

    def forward(self, x):
        return super().forward(unpool(x))


class ConvAvgPool2d(ops.Conv2d):
    """avg_pool_2x2(conv2d(x)): the unfused "down" conv."""

    def forward(self, x):
        return avg_pool_2x2(super().forward(x))


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
    """A block's conv for `scale` (ResNetBlock._get_conv,
    resnet_ops.py:78-105), fused or not as `fusion_options` says."""
    if fusion_options():
        cls = {"up": ops.UpConv2d, "down": ops.DownConv2d,
               "none": ops.Conv2d}[scale]
    else:
        cls = {"up": UnpoolConv2d, "down": ConvAvgPool2d,
               "none": ops.Conv2d}[scale]
    return cls(in_channels, out_channels, kernel_size[0], kernel_size[1],
               use_sn=use_sn, device=device)


def conv_name(scale, suffix):
    return "{}_{}".format("same" if scale == "none" else scale, suffix)


class BlockLayout(core.Module):
    """What every G/D block shares (resnet_ops.py:58-76): G scales in
    conv1, D in conv2."""

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

    def _add_conv(self, in_channels, out_channels, scale, suffix,
                  kernel_size, device):
        """Register the conv under its JAX name; returns the name."""
        name = conv_name(scale, suffix)
        self.add_module(name, scale_conv(in_channels, out_channels, scale,
                                         kernel_size, self._spectral_norm,
                                         device))
        return name

    def _check_inputs(self, inputs):
        if inputs.shape[-1] != self._in_channels:
            raise ValueError(
                f"Unexpected number of input channels (expected "
                f"{self._in_channels}, got {inputs.shape[-1]}).")


class ResNetBlock(BlockLayout):
    """The SN-GAN block (resnet_ops.py:107-133): a 3x3 shortcut conv beside
    BN (+ layer norm) - ReLU - conv, twice. `bn1`/`bn2` are the
    architecture's batch-norm modules."""

    def __init__(self, in_channels, out_channels, scale, is_gen_block,
                 layer_norm=False, spectral_norm=False, bn1=None, bn2=None,
                 device=None):
        super().__init__(in_channels, out_channels, scale, is_gen_block,
                         spectral_norm=spectral_norm)
        self._shortcut = self._add_conv(in_channels, out_channels, scale,
                                        "conv_shortcut", (3, 3), device)
        self.bn1 = bn1
        self._layer_norm = layer_norm
        if layer_norm:
            self.ln1 = ops.LayerNorm(in_channels, device=device)
        self._conv1 = self._add_conv(in_channels, out_channels, self._scale1,
                                     "conv1", (3, 3), device)
        self.bn2 = bn2
        if layer_norm:
            self.ln2 = ops.LayerNorm(out_channels, device=device)
        self._conv2 = self._add_conv(out_channels, out_channels,
                                     self._scale2, "conv2", (3, 3), device)

    def forward(self, inputs, z, y, is_training):
        self._check_inputs(inputs)
        shortcut = self._modules[self._shortcut](inputs)
        out = self.bn1(inputs, z=z, y=y, is_training=is_training)
        if self._layer_norm:
            out = self.ln1(out)
        out = self._modules[self._conv1](F.relu(out))
        out = self.bn2(out, z=z, y=y, is_training=is_training)
        if self._layer_norm:
            out = self.ln2(out)
        out = self._modules[self._conv2](F.relu(out))
        return out + shortcut


class ResNetGenerator(abstract_arch.AbstractGenerator):
    """Base of the ResNet generators (resnet_ops.py:136-145)."""

    def _resnet_block(self, in_channels, out_channels, scale, y_dim):
        if scale not in ("up", "none"):
            raise ValueError(f"Unknown G block scaling: {scale}.")
        return ResNetBlock(
            in_channels, out_channels, scale, is_gen_block=True,
            spectral_norm=self._spectral_norm,
            bn1=self.make_batch_norm(in_channels, y_dim),
            bn2=self.make_batch_norm(out_channels, y_dim),
            device=self._device)


class ResNetDiscriminator(abstract_arch.AbstractDiscriminator):
    """Base of the ResNet discriminators (resnet_ops.py:148-157)."""

    def _resnet_block(self, in_channels, out_channels, scale):
        if scale not in ("down", "none"):
            raise ValueError(f"Unknown D block scaling: {scale}.")
        return ResNetBlock(
            in_channels, out_channels, scale, is_gen_block=False,
            layer_norm=self._layer_norm, spectral_norm=self._spectral_norm,
            bn1=self.make_batch_norm(in_channels, self._num_classes),
            bn2=self.make_batch_norm(out_channels, self._num_classes),
            device=self._device)
