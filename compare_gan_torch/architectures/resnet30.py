"""The 30-block ResNet: 6 super-blocks of 5 residual blocks at 128x128
(counterpart of compare_gan_tpu/architectures/resnet30.py; Gulrajani et
al. 2017). In the spatial layout (`parallel.tpu_ops`) G's fc_noise runs
whole on every model rank, each keeping its band of the 4x4 seed, and D's
last linear layer takes the bands' flattened features
(`Linear.of_bands`)."""

from __future__ import annotations

import torch

from compare_gan_torch.architectures import resnet_ops
from compare_gan_torch.ops import arch_ops as ops
from compare_gan_torch.parallel import tpu_ops

CH = 64


def _layout(scale_last):
    """(name, in, out, scale) of every block, super-block by super-block:
    five same-width blocks, then (but for the last) one that scales."""
    blocks = []
    for superblock in range(6):
        width = (8 * CH) >> superblock if scale_last == "up" \
            else (CH // 4) << superblock
        for i in range(5):
            blocks.append((f"B_{superblock}_{i}", width, width, "none"))
        if superblock < 5:
            out = width // 2 if scale_last == "up" else width * 2
            blocks.append((f"B_{superblock}_up", width, out, scale_last))
    return blocks


class Generator(resnet_ops.ResNetGenerator):
    """ResNet30 generator (resnet30.py:13-40): linear to 4x4x512, 30 blocks
    halving the width at each of 5 up-blocks, a 3x3 conv, sigmoid."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        dev, y_dim = self._device, self._num_classes
        self.fc_noise = ops.Linear(self._z_dim, 4 * 4 * 8 * CH, device=dev)
        self._block_names = []
        for name, cin, cout, scale in _layout("up"):
            self.add_module(name, self._resnet_block(cin, cout, scale,
                                                     y_dim))
            self._block_names.append(name)
        self.final_conv = ops.Conv2d(CH // 4, self._image_shape[2], 3, 3,
                                     device=dev)

    def forward(self, z, y, is_training):
        if z.dim() != 2:
            raise ValueError(f"Expected [batch_size, z_dim], got "
                             f"{tuple(z.shape)}.")
        net = tpu_ops.split_bands(self.fc_noise(z).reshape(-1, 4, 4, 8 * CH),
                                  self.fc_noise.scope)
        for name in self._block_names:
            net = self._modules[name](net, z=z, y=y, is_training=is_training)
        return torch.sigmoid(self.final_conv(net))


class Discriminator(resnet_ops.ResNetDiscriminator):
    """ResNet30 discriminator (resnet30.py:43-71): a 3x3 color conv, 30
    blocks doubling the width at each of 5 down-blocks, a linear logit on
    the flattened 4x4x512 features."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        colors = self._image_shape[2]
        if colors not in (1, 3):
            raise ValueError(f"Color channels not supported: {colors}")
        dev = self._device
        self.color_conv = ops.Conv2d(colors, CH // 4, 3, 3, device=dev)
        self._block_names = []
        for name, cin, cout, scale in _layout("down"):
            self.add_module(name, self._resnet_block(cin, cout, scale))
            self._block_names.append(name)
        self.disc_final_fc = ops.Linear(4 * 4 * 8 * CH, 1,
                                        use_sn=self._spectral_norm,
                                        device=dev)

    def forward(self, x, y, is_training):
        resnet_ops.validate_image_inputs(
            (x.shape[0], tpu_ops.image_rows(x)) + tuple(x.shape[2:]))
        net = self.color_conv(x)
        for name in self._block_names:
            net = self._modules[name](net, z=None, y=y,
                                      is_training=is_training)
        out_logit = self.disc_final_fc.of_bands(net)
        net = net.reshape(x.shape[0], -1)
        return torch.sigmoid(out_logit), out_logit, net
