"""BigGAN generator and discriminator, resolutions 32-512 (counterpart of
compare_gan_tpu/architectures/resnet_biggan.py).

Parameter counts match the JAX package and the reference exactly:
  128px: G = 70,433,988  D = 87,982,370
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from compare_gan_torch import config as gin
from compare_gan_torch.architectures import abstract_arch
from compare_gan_torch.architectures import resnet_ops
from compare_gan_torch.ops import arch_ops as ops
from compare_gan_torch.parallel import tpu_ops


@gin.configurable("BigGanResNetBlock")
class BigGanResNetBlock(resnet_ops.BlockLayout):
    """BigGAN block (resnet_biggan.py:26-65): BN (+ layer norm) - ReLU -
    conv twice, plus a 1x1 shortcut conv unless `add_shortcut` is False, in
    which case the block has no skip at all (the reference's semantics)."""

    def __init__(self, in_channels, out_channels, scale, is_gen_block,
                 add_shortcut=True, layer_norm=False, spectral_norm=False,
                 bn1=None, bn2=None, device=None):
        super().__init__(in_channels, out_channels, scale, is_gen_block,
                         spectral_norm=spectral_norm)
        self._add_shortcut = add_shortcut
        self._layer_norm = layer_norm
        self.bn1 = bn1
        if layer_norm:
            self.ln1 = ops.LayerNorm(in_channels, device=device)
        self._conv1 = self._add_conv(in_channels, out_channels, self._scale1,
                                     "conv1", (3, 3), device)
        self.bn2 = bn2
        if layer_norm:
            self.ln2 = ops.LayerNorm(out_channels, device=device)
        self._conv2 = self._add_conv(out_channels, out_channels,
                                     self._scale2, "conv2", (3, 3), device)
        if add_shortcut:
            self._shortcut = self._add_conv(in_channels, out_channels, scale,
                                            "conv_shortcut", (1, 1), device)

    def forward(self, inputs, z, y, is_training):
        self._check_inputs(inputs)
        out = self.bn1(inputs, z=z, y=y, is_training=is_training)
        if self._layer_norm:
            out = self.ln1(out)
        out = self._modules[self._conv1](F.relu(out))
        out = self.bn2(out, z=z, y=y, is_training=is_training)
        if self._layer_norm:
            out = self.ln2(out)
        out = self._modules[self._conv2](F.relu(out))
        if self._add_shortcut:
            out = out + self._modules[self._shortcut](inputs)
        return out


def _attention_channels(blocks_with_attention, names, channels):
    """Channels of the one shared `non_local_block` (the JAX scope tree
    gives every listed block the same variables), or None."""
    widths = {c for n, c in zip(names, channels) if n in blocks_with_attention}
    if len(widths) > 1:
        raise ValueError(f"Attention blocks {sorted(blocks_with_attention)} "
                         f"have different widths {sorted(widths)}; they "
                         f"would share one non_local_block.")
    return widths.pop() if widths else None


@gin.configurable("resnet_biggan.Generator")
class Generator(abstract_arch.AbstractGenerator):
    """BigGAN generator (resnet_biggan.py:68-164): hierarchical z split
    across blocks and concatenated with the embedded y, attention after the
    configured blocks, unconditional final BN, tanh -> [0, 1]. In the
    spatial layout the first linear layer runs whole on every model rank,
    and each keeps its band of rows of the 4x4 map."""
    SPATIAL = True

    def __init__(self, ch=96, blocks_with_attention="B4", hierarchical_z=True,
                 embed_z=False, embed_y=True, embed_y_dim=128,
                 embed_bias=False, experimental_fast_conv_to_rgb=False,
                 **kwargs):
        super().__init__(**kwargs)
        dev = self._device
        self._ch = ch
        self._blocks_with_attention = set(blocks_with_attention.split(","))
        self._hierarchical_z = hierarchical_z
        self._embed_z = embed_z
        self._embed_y = embed_y
        self._fast_conv_to_rgb = experimental_fast_conv_to_rgb
        in_channels, out_channels = self._get_in_out_channels()
        self._in_channels = in_channels
        num_blocks = len(in_channels)
        z_dim = self._z_dim

        y_dim = self._num_classes
        if embed_z:
            self.embed_z = ops.Linear(z_dim, z_dim, use_sn=False,
                                      use_bias=embed_bias, device=dev)
        if embed_y:
            if not self._num_classes:
                raise ValueError("embed_y needs a conditional GAN.")
            self.embed_y = ops.Linear(self._num_classes, embed_y_dim,
                                      use_sn=False, use_bias=embed_bias,
                                      device=dev)
            y_dim = embed_y_dim
        if hierarchical_z:
            if z_dim % (num_blocks + 1):
                raise ValueError(f"z_dim {z_dim} must split evenly into "
                                 f"{num_blocks + 1} chunks.")
            self._z_chunk = z_dim // (num_blocks + 1)
            z0_dim = self._z_chunk
            cond_dim = self._z_chunk + y_dim if y_dim else None
        else:
            z0_dim, cond_dim = z_dim, y_dim

        sn = self._spectral_norm
        self.fc_noise = ops.Linear(z0_dim, in_channels[0] * 16, use_sn=sn,
                                   device=dev)
        self._block_names = [f"B{i + 1}" for i in range(num_blocks)]
        for name, cin, cout in zip(self._block_names, in_channels,
                                   out_channels):
            self.add_module(name, BigGanResNetBlock(
                cin, cout, "up", is_gen_block=True, spectral_norm=sn,
                bn1=self.make_batch_norm(cin, cond_dim),
                bn2=self.make_batch_norm(cout, cond_dim), device=dev))
        att_ch = _attention_channels(self._blocks_with_attention,
                                     self._block_names, out_channels)
        if att_ch is not None:
            self.non_local_block = ops.NonLocalBlock(att_ch, use_sn=sn,
                                                     device=dev)
        self.final_norm = ops.BatchNorm(out_channels[-1], device=dev)
        colors = self._image_shape[2]
        self.final_conv = ops.Conv2d(
            out_channels[-1], 128 if self._fast_conv_to_rgb else colors, 3, 3,
            use_sn=sn, device=dev)

    def _get_in_out_channels(self):
        resolution = self._image_shape[0]
        multipliers = {512: [16, 16, 8, 8, 4, 2, 1, 1],
                       256: [16, 16, 8, 8, 4, 2, 1],
                       128: [16, 16, 8, 4, 2, 1],
                       64: [16, 16, 8, 4, 2],
                       32: [4, 4, 4, 4]}
        if resolution not in multipliers:
            raise ValueError(f"Unsupported resolution: {resolution}")
        m = multipliers[resolution]
        return ([self._ch * c for c in m[:-1]],
                [self._ch * c for c in m[1:]])

    def forward(self, z, y, is_training):
        num_blocks = len(self._block_names)
        if self._embed_z:
            z = self.embed_z(z)
        if self._embed_y:
            y = self.embed_y(y)
        if self._hierarchical_z:
            chunks = torch.split(z, self._z_chunk, dim=1)
            z0, z_per_block = chunks[0], chunks[1:]
            if y is not None:
                # jnp.concatenate promotes (bf16 z, f32 y) to f32.
                dt = torch.promote_types(z.dtype, y.dtype)
                y_per_block = [torch.cat([zi.to(dt), y.to(dt)], 1)
                               for zi in z_per_block]
            else:
                y_per_block = [None] * num_blocks
        else:
            z0, z_per_block = z, [z] * num_blocks
            y_per_block = [y] * num_blocks

        net = tpu_ops.split_bands(
            self.fc_noise(z0).reshape(-1, 4, 4, self._in_channels[0]),
            self.fc_noise.scope)
        for i, name in enumerate(self._block_names):
            net = self._modules[name](net, z=z_per_block[i], y=y_per_block[i],
                                      is_training=is_training)
            if name in self._blocks_with_attention:
                net = self.non_local_block(net)
        net = F.relu(self.final_norm(net, is_training=is_training))
        net = self.final_conv(net)
        if self._fast_conv_to_rgb:
            net = net[:, :, :, :self._image_shape[2]]
        return (torch.tanh(net) + 1.0) / 2.0


@gin.configurable("resnet_biggan.Discriminator")
class Discriminator(abstract_arch.AbstractDiscriminator):
    """BigGAN discriminator (resnet_biggan.py:167-243): sum pooling and the
    projection head out += <embed(y), h>. In the spatial layout the sum
    pooling adds the bands' sums over the model group, and the head runs
    whole on every model rank."""
    SPATIAL = True

    def __init__(self, ch=96, blocks_with_attention="B1", project_y=True,
                 **kwargs):
        super().__init__(**kwargs)
        dev = self._device
        self._ch = ch
        self._blocks_with_attention = set(blocks_with_attention.split(","))
        self._project_y = project_y
        resolution, _, colors = self._image_shape
        in_channels, out_channels = self._get_in_out_channels(colors,
                                                              resolution)
        sn = self._spectral_norm
        num_blocks = len(in_channels)
        self._block_names = [f"B{i + 1}" for i in range(num_blocks)]
        for i, (name, cin, cout) in enumerate(zip(
                self._block_names, in_channels, out_channels)):
            self.add_module(name, BigGanResNetBlock(
                cin, cout, "none" if i == num_blocks - 1 else "down",
                is_gen_block=False, add_shortcut=cin != cout,
                layer_norm=self._layer_norm, spectral_norm=sn,
                bn1=self.make_batch_norm(cin, self._num_classes),
                bn2=self.make_batch_norm(cout, self._num_classes),
                device=dev))
        att_ch = _attention_channels(self._blocks_with_attention,
                                     self._block_names, out_channels)
        if att_ch is not None:
            self.non_local_block = ops.NonLocalBlock(att_ch, use_sn=sn,
                                                     device=dev)
        self.final_fc = ops.Linear(out_channels[-1], 1, use_sn=sn, device=dev)
        if project_y:
            if not self._num_classes:
                raise ValueError("project_y needs a conditional GAN.")
            # Glorot-normal init, overriding the gin `weights` scheme
            # (resnet_biggan.py:232-242).
            self.embedding_fc = ops.SpectralNormKernel(
                (self._num_classes, out_channels[-1]),
                ops.glorot_normal_init(), use_sn=sn, device=dev)

    @property
    def feature_dim(self):
        """Width of the features h that D returns."""
        return self.final_fc.kernel.shape[0]

    def _get_in_out_channels(self, colors, resolution):
        if colors not in (1, 3):
            raise ValueError(f"Unsupported color channels: {colors}")
        multipliers = {512: [1, 1, 2, 4, 8, 8, 16, 16],
                       256: [1, 2, 4, 8, 8, 16, 16],
                       128: [1, 2, 4, 8, 16, 16],
                       64: [2, 4, 8, 16, 16],
                       32: [2, 2, 2, 2]}
        if resolution not in multipliers:
            raise ValueError(f"Unsupported resolution: {resolution}")
        out_channels = [self._ch * c for c in multipliers[resolution]]
        return [colors] + out_channels[:-1], out_channels

    def forward(self, x, y, is_training):
        resnet_ops.validate_image_inputs(
            (x.shape[0], tpu_ops.image_rows(x)) + tuple(x.shape[2:]))
        net = x
        for name in self._block_names:
            net = self._modules[name](net, z=None, y=y,
                                      is_training=is_training)
            if name in self._blocks_with_attention:
                net = self.non_local_block(net)
        h = tpu_ops.spatial_sum(F.relu(net))
        out_logit = self.final_fc(h)
        if self._project_y:
            if y is None:
                raise ValueError("You must provide class information y.")
            embedded_y = y @ self.embedding_fc().to(y.dtype)
            # Promotes a bf16 logit to f32, as in JAX.
            out_logit = out_logit + (embedded_y * h).sum(dim=1, keepdim=True)
        return torch.sigmoid(out_logit), out_logit, h
