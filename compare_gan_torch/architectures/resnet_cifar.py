"""SN-GAN CIFAR ResNet, 32x32 (counterpart of
compare_gan_tpu/architectures/resnet_cifar.py). G: 3 up-blocks at 256
channels with optional hierarchical z and z/y embeddings, sigmoid output;
D: 4 blocks at 128 channels with an optional projection head. In the
spatial layout (`parallel.tpu_ops`) G's fc_noise runs whole on every model
rank, each keeping its band of the 4x4 seed, and D's mean pooling adds the
bands' sums over the model group."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from compare_gan_torch import config as gin
from compare_gan_torch.architectures import resnet_ops
from compare_gan_torch.ops import arch_ops as ops
from compare_gan_torch.parallel import tpu_ops

G_CH, D_CH, NUM_G_BLOCKS = 256, 128, 3


@gin.configurable("resnet_cifar.Generator")
class Generator(resnet_ops.ResNetGenerator):
    """ResNet CIFAR generator (resnet_cifar.py:16-65)."""

    def __init__(self, hierarchical_z=False, embed_z=False, embed_y=False,
                 **kwargs):
        super().__init__(**kwargs)
        if self._image_shape[:2] != (32, 32):
            raise ValueError(f"resnet_cifar generates 32x32 images, not "
                             f"{self._image_shape[:2]}.")
        dev, sn, z_dim = self._device, self._spectral_norm, self._z_dim
        self._hierarchical_z = hierarchical_z
        self._embed_z = embed_z
        self._embed_y = embed_y
        y_dim = self._num_classes
        if embed_z:
            self.embed_z = ops.Linear(z_dim, z_dim, use_sn=sn, device=dev)
        if embed_y:
            if not self._num_classes:
                raise ValueError("embed_y needs a conditional GAN.")
            self.embed_y = ops.Linear(self._num_classes, z_dim, use_sn=sn,
                                      device=dev)
            y_dim = z_dim
        z0_dim, block_y_dim = z_dim, y_dim
        if hierarchical_z:
            if z_dim % (NUM_G_BLOCKS + 1):
                raise ValueError(f"z_dim {z_dim} must split evenly into "
                                 f"{NUM_G_BLOCKS + 1} chunks.")
            self._z_chunk = z0_dim = z_dim // (NUM_G_BLOCKS + 1)
            if y_dim:
                block_y_dim = self._z_chunk + y_dim
        self.fc_noise = ops.Linear(z0_dim, 4 * 4 * G_CH, use_sn=sn,
                                   device=dev)
        self._block_names = [f"B{i + 1}" for i in range(NUM_G_BLOCKS)]
        for name in self._block_names:
            self.add_module(name, self._resnet_block(G_CH, G_CH, "up",
                                                     block_y_dim))
        self.final_norm = self.make_batch_norm(G_CH, y_dim)
        self.final_conv = ops.Conv2d(G_CH, self._image_shape[2], 3, 3,
                                     use_sn=sn, device=dev)

    def forward(self, z, y, is_training):
        if self._embed_z:
            z = self.embed_z(z)
        if self._embed_y:
            y = self.embed_y(y)
        y_per_block = [y] * NUM_G_BLOCKS
        if self._hierarchical_z:
            chunks = torch.split(z, self._z_chunk, dim=1)
            z0, z_per_block = chunks[0], chunks[1:]
            if y is not None:
                # jnp.concatenate promotes (bf16 z, f32 y) to f32.
                dt = torch.promote_types(z.dtype, y.dtype)
                y_per_block = [torch.cat([zi.to(dt), y.to(dt)], 1)
                               for zi in z_per_block]
        else:
            z0, z_per_block = z, [z] * NUM_G_BLOCKS

        net = tpu_ops.split_bands(self.fc_noise(z0).reshape(-1, 4, 4, G_CH),
                                  self.fc_noise.scope)
        for i, name in enumerate(self._block_names):
            net = self._modules[name](net, z=z_per_block[i], y=y_per_block[i],
                                      is_training=is_training)
        net = self.final_norm(net, z=z, y=y, is_training=is_training)
        net = self.final_conv(F.relu(net))
        return torch.sigmoid(net)


@gin.configurable("resnet_cifar.Discriminator")
class Discriminator(resnet_ops.ResNetDiscriminator):
    """ResNet CIFAR discriminator (resnet_cifar.py:68-100): mean pooling and
    the projection head out += <embed(y), h>."""

    def __init__(self, project_y=False, **kwargs):
        super().__init__(**kwargs)
        dev, sn = self._device, self._spectral_norm
        colors = self._image_shape[2]
        if colors not in (1, 3):
            raise ValueError(f"Color channels not supported: {colors}")
        self._project_y = project_y
        self._block_names = [f"B{i + 1}" for i in range(4)]
        for i, name in enumerate(self._block_names):
            self.add_module(name, self._resnet_block(
                colors if i == 0 else D_CH, D_CH,
                "down" if i <= 1 else "none"))
        self.disc_final_fc = ops.Linear(D_CH, 1, use_sn=sn, device=dev)
        if project_y:
            if not self._num_classes:
                raise ValueError("project_y needs a conditional GAN.")
            self.embedding_fc = ops.Linear(self._num_classes, D_CH,
                                           use_sn=sn, use_bias=False,
                                           device=dev)

    @property
    def feature_dim(self):
        """Width of the features h that D returns."""
        return D_CH

    def forward(self, x, y, is_training):
        resnet_ops.validate_image_inputs(
            (x.shape[0], tpu_ops.image_rows(x)) + tuple(x.shape[2:]))
        net = x
        for name in self._block_names:
            net = self._modules[name](net, z=None, y=y,
                                      is_training=is_training)
        h = tpu_ops.spatial_mean(F.relu(net))
        out_logit = self.disc_final_fc(h)
        if self._project_y:
            if y is None:
                raise ValueError("You must provide class information y.")
            # Promotes a bf16 logit to f32, as in JAX.
            out_logit = out_logit + (self.embedding_fc(y) * h).sum(
                dim=1, keepdim=True)
        return torch.sigmoid(out_logit), out_logit, h
