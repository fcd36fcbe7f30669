"""The WGAN-GP ResNet (Gulrajani et al. 2017): 5 G blocks and 6 D blocks
at up to 128x128 (counterpart of compare_gan_tpu/architectures/resnet5.py).
D pools by the mean and outputs a sigmoid. In the spatial layout
(`parallel.tpu_ops`) G's fc_noise runs whole on every model rank, each
keeping its band of the 4x4 seed, and D's mean pooling adds the bands'
sums over the model group."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from compare_gan_torch.architectures import resnet_ops
from compare_gan_torch.ops import arch_ops as ops
from compare_gan_torch.parallel import tpu_ops


class Generator(resnet_ops.ResNetGenerator):
    """ResNet5 generator (resnet5.py:16-51): linear to a 4x4 seed, five
    blocks of which the first log2(size / 4) upsample, batch norm, ReLU and
    a 3x3 conv. `ch` and `channels` are the JAX constructor's."""

    def __init__(self, ch=64, channels=(8, 8, 4, 4, 2, 1), **kwargs):
        super().__init__(**kwargs)
        seed_size, image_size = 4, self._image_shape[0]
        up_layers = math.log2(image_size / seed_size)
        if up_layers != int(up_layers):
            raise ValueError(
                f"log2({image_size}/{seed_size}) must be an integer.")
        if up_layers < 0 or up_layers > 5:
            raise ValueError(f"Invalid image_size {image_size}.")
        self._seed_ch = ch * channels[0]
        dev, y_dim = self._device, self._num_classes
        self.fc_noise = ops.Linear(
            self._z_dim, self._seed_ch * seed_size * seed_size, device=dev)
        self._block_names = [f"B{i + 1}" for i in range(5)]
        for i, name in enumerate(self._block_names):
            self.add_module(name, self._resnet_block(
                ch * channels[i], ch * channels[i + 1],
                "up" if i < up_layers else "none", y_dim))
        self.final_norm = self.make_batch_norm(ch * channels[5], y_dim)
        self.final_conv = ops.Conv2d(ch * channels[5], self._image_shape[2],
                                     3, 3, device=dev)

    def forward(self, z, y, is_training):
        net = tpu_ops.split_bands(
            self.fc_noise(z).reshape(-1, 4, 4, self._seed_ch),
            self.fc_noise.scope)
        for name in self._block_names:
            net = self._modules[name](net, z=z, y=y, is_training=is_training)
        net = self.final_norm(net, z=z, y=y, is_training=is_training)
        return torch.sigmoid(self.final_conv(F.relu(net)))


class Discriminator(resnet_ops.ResNetDiscriminator):
    """ResNet5 discriminator (resnet5.py:54-81): six down blocks, ReLU,
    mean pooling, a linear logit."""

    def __init__(self, ch=64, channels=(1, 2, 4, 4, 8, 8), **kwargs):
        super().__init__(**kwargs)
        colors = self._image_shape[2]
        if colors not in (1, 3):
            raise ValueError(f"Color channels not supported: {colors}")
        if self._image_shape[0] < 64:
            # The JAX package's fused down conv leaves a 0x0 map there and
            # returns NaN logits.
            raise ValueError(
                f"resnet5's discriminator halves its input 6 times: "
                f"{self._image_shape[0]} px leave no pixel for its last "
                f"block (64 px at least).")
        self.B0 = self._resnet_block(colors, ch, "down")
        self._block_names = ["B0"] + [f"B{i + 1}" for i in range(5)]
        for i, name in enumerate(self._block_names[1:]):
            self.add_module(name, self._resnet_block(
                ch * channels[i], ch * channels[i + 1], "down"))
        self.disc_final_fc = ops.Linear(ch * channels[5], 1,
                                        use_sn=self._spectral_norm,
                                        device=self._device)


    def forward(self, x, y, is_training):
        resnet_ops.validate_image_inputs(
            (x.shape[0], tpu_ops.image_rows(x)) + tuple(x.shape[2:]))
        net = x
        for name in self._block_names:
            net = self._modules[name](net, z=None, y=y,
                                      is_training=is_training)
        pre_logits = tpu_ops.spatial_mean(F.relu(net))
        out_logit = self.disc_final_fc(pre_logits)
        return torch.sigmoid(out_logit), out_logit, pre_logits
