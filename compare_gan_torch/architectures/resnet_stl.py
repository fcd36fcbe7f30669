"""The SN-GAN STL-10 ResNet: 48x48 from a 6x6 seed (counterpart of
compare_gan_tpu/architectures/resnet_stl.py). In the spatial layout
(`parallel.tpu_ops`) G's fc_noise runs whole on every model rank, each
keeping its band of the 6x6 seed, and D's mean pooling adds the bands'
sums over the model group."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from compare_gan_torch.architectures import resnet_ops
from compare_gan_torch.ops import arch_ops as ops
from compare_gan_torch.parallel import tpu_ops

CH = 64


class Generator(resnet_ops.ResNetGenerator):
    """ResNet STL generator (resnet_stl.py:13-35): linear to 6x6x512, three
    up-blocks, batch norm, ReLU, a 3x3 conv, sigmoid."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        dev, y_dim = self._device, self._num_classes
        self.fc_noise = ops.Linear(self._z_dim, 6 * 6 * 512, device=dev)
        self._block_names = [f"B{i + 1}" for i in range(3)]
        for name, (cin, cout) in zip(self._block_names,
                                     [(8, 4), (4, 2), (2, 1)]):
            self.add_module(name, self._resnet_block(CH * cin, CH * cout,
                                                     "up", y_dim))
        self.final_norm = self.make_batch_norm(CH, y_dim)
        self.final_conv = ops.Conv2d(CH, self._image_shape[2], 3, 3,
                                     device=dev)

    def forward(self, z, y, is_training):
        net = tpu_ops.split_bands(
            self.fc_noise(z).reshape(z.shape[0], 6, 6, 512),
            self.fc_noise.scope)
        for name in self._block_names:
            net = self._modules[name](net, z=z, y=y, is_training=is_training)
        net = self.final_norm(net, z=z, y=y, is_training=is_training)
        return torch.sigmoid(self.final_conv(F.relu(net)))


class Discriminator(resnet_ops.ResNetDiscriminator):
    """ResNet STL discriminator (resnet_stl.py:38-62): five blocks, the
    last without downsampling, ReLU, mean pooling, a linear logit."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        colors = self._image_shape[2]
        if colors not in (1, 3):
            raise ValueError(f"Number of color channels unknown: {colors}")
        self.B0 = self._resnet_block(colors, CH, "down")
        self._block_names = ["B0"]
        for i, (cin, cout) in enumerate([(1, 2), (2, 4), (4, 8), (8, 16)]):
            self.add_module(f"B{i + 1}", self._resnet_block(
                CH * cin, CH * cout, "down" if i < 3 else "none"))
            self._block_names.append(f"B{i + 1}")
        self.disc_final_fc = ops.Linear(CH * 16, 1,
                                        use_sn=self._spectral_norm,
                                        device=self._device)


    def forward(self, x, y, is_training):
        resnet_ops.validate_image_inputs(
            (x.shape[0], tpu_ops.image_rows(x)) + tuple(x.shape[2:]),
            validate_power2=False)
        net = x
        for name in self._block_names:
            net = self._modules[name](net, z=None, y=y,
                                      is_training=is_training)
        pre_logits = tpu_ops.spatial_mean(F.relu(net))
        out_logit = self.disc_final_fc(pre_logits)
        return torch.sigmoid(out_logit), out_logit, pre_logits
