"""Single-linear-layer G and D for fast trainer tests (counterpart of
compare_gan_tpu/architectures/dummy.py)."""

from __future__ import annotations

import math

import torch

from compare_gan_torch.architectures import abstract_arch
from compare_gan_torch.ops import arch_ops as ops
from compare_gan_torch.parallel import tpu_ops


class Generator(abstract_arch.AbstractGenerator):
    """sigmoid(linear(z)) reshaped to the image (dummy.py:15-26); in the
    spatial layout, this worker's band of it."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.fc_noise = ops.Linear(self._z_dim, math.prod(self._image_shape),
                                   device=self._device)

    def forward(self, z, y, is_training):
        out = torch.sigmoid(self.fc_noise(z))
        return tpu_ops.split_bands(
            out.reshape((z.shape[0],) + self._image_shape),
            self.fc_noise.scope)


class Discriminator(abstract_arch.AbstractDiscriminator):
    """A linear layer on the images' per-channel means (dummy.py:29-38);
    in the spatial layout the bands' sums added over the model group."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.linear = ops.Linear(self._image_shape[2], 1,
                                 device=self._device)

    @property
    def feature_dim(self):
        """Width of the features D returns (what SSGAN's and S3GAN's heads
        read): the image's channels."""
        return self._image_shape[2]

    def forward(self, x, y, is_training):
        h = tpu_ops.spatial_sum(x) / (tpu_ops.image_rows(x) * x.shape[2])
        out = self.linear(h)
        return torch.sigmoid(out), out, h
