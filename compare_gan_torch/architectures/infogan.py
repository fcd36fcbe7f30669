"""InfoGAN's MLP + conv G and D for MNIST-scale images (counterpart of
compare_gan_tpu/architectures/infogan.py). In the spatial layout
(`parallel.tpu_ops`) G's linear layers run whole on every model rank, each
keeping its band of the first map, and D's d_fc3 takes the bands'
flattened features (`Linear.of_bands`); what follows it is whole."""

from __future__ import annotations

import torch

from compare_gan_torch.architectures import abstract_arch
from compare_gan_torch.ops import arch_ops as ops
from compare_gan_torch.parallel import tpu_ops


class Generator(abstract_arch.AbstractGenerator):
    """InfoGAN generator (infogan.py:12-31): two linear layers and two 4x4
    stride-2 deconvs, each followed by batch norm (always, whatever
    `G.batch_norm_fn` says: the first two on rank-2 activations) and a
    leaky ReLU; sigmoid output."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        h, w, c = self._image_shape
        dev = self._device
        self.g_fc1 = ops.Linear(self._z_dim, 1024, device=dev)
        self.g_bn1 = ops.BatchNorm(1024, device=dev)
        self.g_fc2 = ops.Linear(1024, 128 * (h // 4) * (w // 4), device=dev)
        self.g_bn2 = ops.BatchNorm(128 * (h // 4) * (w // 4), device=dev)
        self.g_dc3 = ops.Deconv2d(128, 64, 4, 4, 2, 2, device=dev)
        self.g_bn3 = ops.BatchNorm(64, device=dev)
        self.g_dc4 = ops.Deconv2d(64, c, 4, 4, 2, 2, device=dev)

    def forward(self, z, y, is_training):
        h, w, _ = self._image_shape
        net = ops.lrelu(self.g_bn1(self.g_fc1(z), is_training))
        net = ops.lrelu(self.g_bn2(self.g_fc2(net), is_training))
        net = tpu_ops.split_bands(
            net.reshape(z.shape[0], h // 4, w // 4, 128), self.g_fc2.scope)
        net = self.g_dc3(net, (h // 2, w // 2))
        net = ops.lrelu(self.g_bn3(net, is_training))
        return torch.sigmoid(self.g_dc4(net, (h, w)))


class Discriminator(abstract_arch.AbstractDiscriminator):
    """InfoGAN discriminator (infogan.py:34-50)."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        h, w, c = self._image_shape
        dev, sn = self._device, self._spectral_norm
        self.d_conv1 = ops.Conv2d(c, 64, 4, 4, 2, 2, use_sn=sn, device=dev)
        self.d_conv2 = ops.Conv2d(64, 128, 4, 4, 2, 2, use_sn=sn, device=dev)
        self.d_bn2 = self.make_batch_norm(128, self._num_classes)
        flat = 128 * -(-h // 4) * -(-w // 4)
        self.d_fc3 = ops.Linear(flat, 1024, use_sn=sn, device=dev)
        self.d_bn3 = self.make_batch_norm(1024, self._num_classes)
        self.d_fc4 = ops.Linear(1024, 1, use_sn=sn, device=dev)

    def forward(self, x, y, is_training):
        net = ops.lrelu(self.d_conv1(x))
        net = self.d_bn2(self.d_conv2(net), y=y, is_training=is_training)
        net = self.d_bn3(self.d_fc3.of_bands(ops.lrelu(net)), y=y,
                         is_training=is_training)
        net = ops.lrelu(net)
        out_logit = self.d_fc4(net)
        return torch.sigmoid(out_logit), out_logit, net
