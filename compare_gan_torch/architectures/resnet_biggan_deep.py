"""BigGAN-deep generator and discriminator, resolutions 32-512 (counterpart
of compare_gan_tpu/architectures/resnet_biggan_deep.py; arXiv:1809.11096,
Tables 7-9): bottleneck blocks 1x1 -> 3x3 -> 3x3 -> 1x1 at a quarter of the
wider width, identity-preserving shortcuts (G drops channels, D concatenates
an `add_channels` 1x1 conv), one non-local block at 64x64, z not chunked.

Parameter counts match the JAX package (z_dim 128 and 1,000 classes at
128 px; its tests pin 256 and 512 px too):
  128px: G = 50,244,484  D = 34,590,210

G concatenates z with the embedded labels, and the concatenation promotes a
bf16 z to the labels' f32 (as `jnp.concatenate` does), so under
`compute_dtype = bfloat16` a conditional G runs in f32 in both packages.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from compare_gan_torch import config as gin
from compare_gan_torch import core
from compare_gan_torch.architectures import abstract_arch
from compare_gan_torch.architectures import resnet_ops
from compare_gan_torch.ops import arch_ops as ops


class _NormConv(core.Module):
    """One `convN` scope of a block: BN (`bn`) - ReLU - conv, the conv
    under its JAX name (`1x1_conv` or `3x3_conv`)."""

    def __init__(self, bn, conv_name, conv):
        super().__init__()
        self.bn = bn
        self._conv = conv_name
        self.add_module(conv_name, conv)

    def forward(self, x, z, y, is_training, pool_first=False):
        out = F.relu(self.bn(x, z=z, y=y, is_training=is_training))
        if pool_first:
            out = resnet_ops.avg_pool_2x2(out)
        return self._modules[self._conv](out)


class _AddChannels(core.Module):
    """The `shortcut` scope of a D block that widens: its `add_channels`
    1x1 conv."""

    def __init__(self, in_channels, num_missing, use_sn, device):
        super().__init__()
        self.add_channels = ops.conv1x1(in_channels, num_missing,
                                        use_sn=use_sn, device=device)


@gin.configurable("BigGanDeepResNetBlock")
class BigGanDeepResNetBlock(core.Module):
    """Bottleneck block with identity-preserving skips
    (resnet_biggan_deep.py:20-104). G's conv2 unpools ("up"), fused with its
    conv when `resnet_ops.fused_scale_convs` is on; D's conv4 pools
    ("down") before its 1x1 conv, never fused. `make_bn(num_channels)`
    builds the architecture's batch norm."""

    def __init__(self, in_channels, out_channels, scale, spectral_norm=False,
                 make_bn=None, device=None):
        super().__init__()
        if scale not in ("up", "down", "none"):
            raise ValueError(f"Unknown scale {scale}.")
        self._in_channels = in_channels
        self._out_channels = out_channels
        self._scale = scale
        sn = spectral_norm
        mid = max(in_channels, out_channels) // 4
        self.conv1 = _NormConv(make_bn(in_channels), "1x1_conv",
                               ops.conv1x1(in_channels, mid, use_sn=sn,
                                           device=device))
        self.conv2 = _NormConv(make_bn(mid), "3x3_conv", resnet_ops.scale_conv(
            mid, mid, "up" if scale == "up" else "none", (3, 3), sn, device))
        self.conv3 = _NormConv(make_bn(mid), "3x3_conv",
                               ops.Conv2d(mid, mid, 3, 3, use_sn=sn,
                                          device=device))
        self.conv4 = _NormConv(make_bn(mid), "1x1_conv",
                               ops.conv1x1(mid, out_channels, use_sn=sn,
                                           device=device))
        if in_channels > out_channels and scale != "up":
            raise ValueError("Only an 'up' block drops channels.")
        if in_channels < out_channels:
            if scale != "down":
                raise ValueError("Only a 'down' block adds channels.")
            self.shortcut = _AddChannels(in_channels,
                                         out_channels - in_channels, sn,
                                         device)

    def _shortcut(self, inputs):
        shortcut = inputs
        if inputs.shape[-1] > self._out_channels:
            shortcut = shortcut[..., :self._out_channels]
        if self._scale == "up":
            shortcut = resnet_ops.unpool(shortcut)
        elif self._scale == "down":
            shortcut = resnet_ops.avg_pool_2x2(shortcut)
        if inputs.shape[-1] < self._out_channels:
            added = self.shortcut.add_channels(shortcut)
            shortcut = torch.cat([shortcut, added], dim=-1)
        return shortcut

    def forward(self, inputs, z, y, is_training):
        if inputs.shape[-1] != self._in_channels:
            raise ValueError(
                f"Unexpected number of input channels (expected "
                f"{self._in_channels}, got {inputs.shape[-1]}).")
        out = self.conv1(inputs, z, y, is_training)
        out = self.conv2(out, z, y, is_training)
        out = self.conv3(out, z, y, is_training)
        out = self.conv4(out, z, y, is_training,
                         pool_first=self._scale == "down")
        return out + self._shortcut(inputs)


def _attention_after(scales, resolution, want):
    """Index of the first block of scale `want` whose output is 64x64
    (each "up" doubles the map, each "down" halves it), or None."""
    for i, scale in enumerate(scales):
        resolution = {"up": 2 * resolution, "down": resolution // 2}.get(
            scale, resolution)
        if scale == want and resolution == 64:
            return i
    return None


@gin.configurable("resnet_biggan_deep.Generator")
class Generator(abstract_arch.AbstractGenerator):
    """BigGAN-deep generator (resnet_biggan_deep.py:107-187): y embedded
    without bias or SN and concatenated to z; fc_noise to a 4x4 seed;
    blocks alternating none/up; a non-local block after the up block that
    reaches 64x64; plain final BN, ReLU, final conv, (tanh + 1) / 2."""

    def __init__(self, ch=128, embed_y=True, embed_y_dim=128,
                 experimental_fast_conv_to_rgb=False, **kwargs):
        super().__init__(**kwargs)
        dev = self._device
        self._ch = ch
        self._embed_y = embed_y
        self._fast_conv_to_rgb = experimental_fast_conv_to_rgb
        in_channels, out_channels = self._get_in_out_channels()
        self._in_channels = in_channels
        y_dim = self._num_classes
        if embed_y:
            if not self._num_classes:
                raise ValueError("embed_y needs a conditional GAN.")
            self.embed_y = ops.Linear(self._num_classes, embed_y_dim,
                                      use_sn=False, use_bias=False,
                                      device=dev)
            y_dim = embed_y_dim
        # The blocks' norms read y = z = concat(z, embedded y) when
        # conditional, else z and no y.
        zy_dim = self._z_dim + (y_dim or 0)
        cond_dim = zy_dim if y_dim else None
        sn = self._spectral_norm

        def make_bn(num_channels):
            return self.make_batch_norm(num_channels, cond_dim, z_dim=zy_dim)

        self.fc_noise = ops.Linear(zy_dim, in_channels[0] * 16, use_sn=sn,
                                   device=dev)
        scales = ["none" if i % 2 == 0 else "up"
                  for i in range(len(in_channels))]
        self._block_names = [f"B{i + 1}" for i in range(len(in_channels))]
        for name, cin, cout, scale in zip(self._block_names, in_channels,
                                          out_channels, scales):
            self.add_module(name, BigGanDeepResNetBlock(
                cin, cout, scale, spectral_norm=sn, make_bn=make_bn,
                device=dev))
        self._attention = _attention_after(scales, 4, "up")
        if self._attention is not None:
            self.non_local_block = ops.NonLocalBlock(
                out_channels[self._attention], use_sn=sn, device=dev)
        self.final_norm = ops.BatchNorm(out_channels[-1], device=dev)
        colors = self._image_shape[2]
        self.final_conv = ops.Conv2d(
            out_channels[-1], 128 if self._fast_conv_to_rgb else colors, 3, 3,
            use_sn=sn, device=dev)

    def _get_in_out_channels(self):
        resolution = self._image_shape[0]
        multipliers = {
            512: 4 * [16] + 4 * [8] + [4, 4, 2, 2, 1, 1, 1],
            256: 4 * [16] + 4 * [8] + [4, 4, 2, 2, 1],
            128: 4 * [16] + 2 * [8] + [4, 4, 2, 2, 1],
            64: 4 * [16] + 2 * [8] + [4, 4, 2],
            32: 8 * [4]}
        if resolution not in multipliers:
            raise ValueError(f"Unsupported resolution: {resolution}")
        m = multipliers[resolution]
        return ([self._ch * c for c in m[:-1]],
                [self._ch * c for c in m[1:]])

    def forward(self, z, y, is_training):
        if self._embed_y:
            y = self.embed_y(y)
        if y is not None:
            # jnp.concatenate promotes (bf16 z, f32 y) to f32.
            dt = torch.promote_types(z.dtype, y.dtype)
            y = torch.cat([z.to(dt), y.to(dt)], dim=1)
            z = y
        net = self.fc_noise(z).reshape(-1, 4, 4, self._in_channels[0])
        for i, name in enumerate(self._block_names):
            net = self._modules[name](net, z=z, y=y, is_training=is_training)
            if i == self._attention:
                net = self.non_local_block(net)
        net = F.relu(self.final_norm(net, is_training=is_training))
        net = self.final_conv(net)
        if self._fast_conv_to_rgb:
            net = net[:, :, :, :self._image_shape[2]]
        return (torch.tanh(net) + 1.0) / 2.0


@gin.configurable("resnet_biggan_deep.Discriminator")
class Discriminator(abstract_arch.AbstractDiscriminator):
    """BigGAN-deep discriminator (resnet_biggan_deep.py:190-257):
    initial_conv, blocks alternating down/none, a non-local block after
    the none block at 64x64, ReLU, spatial sum, final_fc and the projection
    head out += <embed(y), h> (glorot-normal, SN when D has SN).
    `blocks_with_attention` is accepted and not read, as in the JAX
    package: the attention's place is fixed."""

    def __init__(self, ch=128, blocks_with_attention="B1", project_y=True,
                 **kwargs):
        super().__init__(**kwargs)
        del blocks_with_attention
        dev = self._device
        self._ch = ch
        self._project_y = project_y
        resolution, _, colors = self._image_shape
        in_channels, out_channels = self._get_in_out_channels(colors,
                                                              resolution)
        sn = self._spectral_norm
        self.initial_conv = ops.Conv2d(colors, in_channels[0], 3, 3,
                                       use_sn=sn, device=dev)
        scales = ["down" if i % 2 == 0 else "none"
                  for i in range(len(in_channels))]
        self._block_names = [f"B{i + 1}" for i in range(len(in_channels))]
        for name, cin, cout, scale in zip(self._block_names, in_channels,
                                          out_channels, scales):
            self.add_module(name, BigGanDeepResNetBlock(
                cin, cout, scale, spectral_norm=sn,
                make_bn=lambda c: self.make_batch_norm(c, self._num_classes),
                device=dev))
        self._attention = _attention_after(scales, resolution, "none")
        if self._attention is not None:
            self.non_local_block = ops.NonLocalBlock(
                out_channels[self._attention], use_sn=sn, device=dev)
        self.final_fc = ops.Linear(out_channels[-1], 1, use_sn=sn, device=dev)
        if project_y:
            if not self._num_classes:
                raise ValueError("project_y needs a conditional GAN.")
            self.embedding_fc = ops.SpectralNormKernel(
                (self._num_classes, out_channels[-1]),
                ops.glorot_normal_init(), use_sn=sn, device=dev)

    def _get_in_out_channels(self, colors, resolution):
        if colors not in (1, 3):
            raise ValueError(f"Unsupported color channels: {colors}")
        multipliers = {
            512: [1, 1, 1, 2, 2, 4, 4] + 4 * [8] + 4 * [16],
            256: [1, 2, 2, 4, 4] + 4 * [8] + 4 * [16],
            128: [1, 2, 2, 4, 4] + 2 * [8] + 4 * [16],
            64: [2, 4, 4] + 2 * [8] + 4 * [16],
            32: 8 * [2]}
        if resolution not in multipliers:
            raise ValueError(f"Unsupported resolution: {resolution}")
        m = multipliers[resolution]
        return ([self._ch * c for c in m[:-1]],
                [self._ch * c for c in m[1:]])

    def forward(self, x, y, is_training):
        resnet_ops.validate_image_inputs(x.shape)
        net = self.initial_conv(x)
        for i, name in enumerate(self._block_names):
            net = self._modules[name](net, z=None, y=y,
                                      is_training=is_training)
            if i == self._attention:
                net = self.non_local_block(net)
        h = F.relu(net).sum(dim=(1, 2))
        out_logit = self.final_fc(h)
        if self._project_y:
            if y is None:
                raise ValueError("You must provide class information y.")
            embedded_y = y @ self.embedding_fc().to(y.dtype)
            out_logit = out_logit + (embedded_y * h).sum(dim=1, keepdim=True)
        return torch.sigmoid(out_logit), out_logit, h
