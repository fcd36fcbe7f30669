"""SN-DCGAN (counterpart of compare_gan_tpu/architectures/sndcgan.py;
Miyato et al. 2018). G: a linear layer and four deconvs, tanh output
mapped to [0, 1]; D: seven convs with leaky ReLU 0.1 on inputs rescaled to
[-1, 1]. In the spatial layout (`parallel.tpu_ops`) G's linear layer and
g_bn1 run whole on every model rank, each keeping its band of the seed
map, and D's last linear layer takes the bands' flattened features
(`Linear.of_bands`)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from compare_gan_torch.architectures import abstract_arch
from compare_gan_torch.architectures.dcgan import halvings
from compare_gan_torch.ops import arch_ops as ops
from compare_gan_torch.parallel import tpu_ops

# (out channels, kernel, stride) of D's convs d_conv1..d_conv7.
D_CONVS = [(64, 3, 1), (128, 4, 2), (128, 3, 1), (256, 4, 2), (256, 3, 1),
           (512, 4, 2), (512, 3, 1)]


class Generator(abstract_arch.AbstractGenerator):
    """SNDCGAN generator (sndcgan.py:18-50). g_bn1 normalizes the linear
    layer's rank-2 output, one channel per unit, before the reshape."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        s_h, s_w, colors = self._image_shape
        dev, y_dim = self._device, self._num_classes
        hs, ws = halvings(s_h, 3), halvings(s_w, 3)
        self._sizes = [(hs[3], ws[3]), (hs[2], ws[2]), (hs[1], ws[1]),
                       (s_h, s_w), (s_h, s_w)]
        seed = hs[3] * ws[3] * 512
        self.g_fc1 = ops.Linear(self._z_dim, seed, device=dev)
        self.g_bn1 = self.make_batch_norm(seed, y_dim)
        widths = [512, 256, 128, 64]
        for i in range(3):
            self.add_module(f"g_dc{i + 2}", ops.Deconv2d(
                widths[i], widths[i + 1], 4, 4, 2, 2, device=dev))
            self.add_module(f"g_bn{i + 2}",
                            self.make_batch_norm(widths[i + 1], y_dim))
        self.g_dc5 = ops.Deconv2d(64, colors, 3, 3, 1, 1, device=dev)

    def forward(self, z, y, is_training):
        net = F.relu(self.g_bn1(self.g_fc1(z), z=z, y=y,
                                is_training=is_training))
        net = tpu_ops.split_bands(
            net.reshape(z.shape[0], *self._sizes[0], 512), self.g_fc1.scope)
        for i in range(3):
            net = self._modules[f"g_dc{i + 2}"](net, self._sizes[i + 1])
            net = F.relu(self._modules[f"g_bn{i + 2}"](
                net, z=z, y=y, is_training=is_training))
        net = self.g_dc5(net, self._sizes[4])
        return (torch.tanh(net) + 1.0) / 2.0


class Discriminator(abstract_arch.AbstractDiscriminator):
    """SNDCGAN discriminator (sndcgan.py:53-77)."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        s_h, s_w, colors = self._image_shape
        dev, sn = self._device, self._spectral_norm
        in_ch = colors
        for i, (out_ch, k, s) in enumerate(D_CONVS):
            self.add_module(f"d_conv{i + 1}", ops.Conv2d(
                in_ch, out_ch, k, k, s, s, use_sn=sn, device=dev))
            in_ch = out_ch
        flat = 512 * halvings(s_h, 3)[-1] * halvings(s_w, 3)[-1]
        self.d_fc1 = ops.Linear(flat, 1, use_sn=sn, device=dev)

    def forward(self, x, y, is_training):
        net = x * 2.0 - 1.0
        for i in range(len(D_CONVS)):
            net = ops.lrelu(self._modules[f"d_conv{i + 1}"](net), leak=0.1)
        out_logit = self.d_fc1.of_bands(net)
        net = net.reshape(x.shape[0], -1)
        return torch.sigmoid(out_logit), out_logit, net
