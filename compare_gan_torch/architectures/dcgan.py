"""DCGAN generator and discriminator (counterpart of
compare_gan_tpu/architectures/dcgan.py; Radford et al. 2015). Batch norm in
G (and in D when `D.batch_norm_fn` is bound), ReLU and tanh in G, leaky
ReLU in D; 28/32/64/128 px by the ceil-div spatial schedule."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from compare_gan_torch.architectures import abstract_arch
from compare_gan_torch.ops import arch_ops as ops
from compare_gan_torch.parallel import tpu_ops


def conv_out_size_same(size, stride):
    return -(-size // stride)


def halvings(size, times):
    """[size, ceil(size/2), ...]: the SAME stride-2 schedule."""
    sizes = [size]
    for _ in range(times):
        sizes.append(conv_out_size_same(sizes[-1], 2))
    return sizes


class Generator(abstract_arch.AbstractGenerator):
    """DCGAN generator (dcgan.py:19-53): linear to 512 channels at 1/16 of
    the image, then four 5x5 stride-2 deconvs. In the spatial layout the
    linear layer runs whole on every model rank, and each keeps its band."""
    SPATIAL = True

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        gf_dim, dev = 64, self._device
        s_h, s_w, colors = self._image_shape
        self._sizes = list(zip(halvings(s_h, 4), halvings(s_w, 4)))[::-1]
        h16, w16 = self._sizes[0]
        self.g_fc1 = ops.Linear(self._z_dim, gf_dim * 8 * h16 * w16,
                                device=dev)
        widths = [gf_dim * 8, gf_dim * 4, gf_dim * 2, gf_dim, colors]
        y_dim = self._num_classes
        for i in range(4):
            self.add_module(f"g_bn{i + 1}",
                            self.make_batch_norm(widths[i], y_dim))
            self.add_module(f"g_dc{i + 1}", ops.Deconv2d(
                widths[i], widths[i + 1], 5, 5, 2, 2, device=dev))

    def forward(self, z, y, is_training):
        net = tpu_ops.split_bands(
            self.g_fc1(z).reshape(-1, *self._sizes[0], 512), self.g_fc1.scope)
        for i in range(4):
            net = self._modules[f"g_bn{i + 1}"](net, z=z, y=y,
                                                is_training=is_training)
            net = self._modules[f"g_dc{i + 1}"](F.relu(net),
                                                self._sizes[i + 1])
        return 0.5 * torch.tanh(net) + 0.5


class Discriminator(abstract_arch.AbstractDiscriminator):
    """DCGAN discriminator (dcgan.py:56-79): four 5x5 stride-2 convs, batch
    norm after the last three, a linear logit on the flattened features
    (in the spatial layout a band's product with its rows of the kernel,
    summed over the model group)."""
    SPATIAL = True

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        df_dim, dev, sn = 64, self._device, self._spectral_norm
        s_h, s_w, colors = self._image_shape
        widths = [colors, df_dim, df_dim * 2, df_dim * 4, df_dim * 8]
        for i in range(4):
            self.add_module(f"d_conv{i + 1}", ops.Conv2d(
                widths[i], widths[i + 1], 5, 5, 2, 2, use_sn=sn, device=dev))
            if i:
                self.add_module(f"d_bn{i}", self.make_batch_norm(
                    widths[i + 1], self._num_classes))
        flat = df_dim * 8 * halvings(s_h, 4)[-1] * halvings(s_w, 4)[-1]
        self.d_fc4 = ops.Linear(flat, 1, use_sn=sn, device=dev)

    def forward(self, x, y, is_training):
        net = ops.lrelu(self.d_conv1(x))
        for i in range(1, 4):
            net = self._modules[f"d_conv{i + 1}"](net)
            net = ops.lrelu(self._modules[f"d_bn{i}"](
                net, y=y, is_training=is_training))
        out_logit = self.d_fc4.of_bands(net)
        return torch.sigmoid(out_logit), out_logit, net
