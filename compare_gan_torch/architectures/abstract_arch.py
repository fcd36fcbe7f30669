"""Generator/discriminator base classes (counterpart of
compare_gan_tpu/architectures/abstract_arch.py).

The JAX architectures create their variables lazily on the first trace; a
torch module builds them in its constructor, so it is told what the JAX
version learns from its inputs: the image shape, z_dim and the number of
classes, and the device to allocate on. The module's `name` ("generator" /
"discriminator") is the prefix of every JAX variable name.
"""

from __future__ import annotations

from compare_gan_torch import config as gin
from compare_gan_torch import core
from compare_gan_torch import utils
from compare_gan_torch.ops import arch_ops as ops


class _Arch(core.Module):
    # Whether the architecture runs in the spatial layout (bands of image
    # height over a model group of workers, `parallel.tpu_ops.spatial`).
    SPATIAL = False

    def __init__(self, name, batch_norm_fn, spectral_norm, device):
        super().__init__()
        self.name = name
        self._batch_norm_fn = batch_norm_fn
        self._spectral_norm = spectral_norm
        self._device = device

    def make_batch_norm(self, num_channels, y_dim=None, z_dim=None):
        """A normalization module from the gin-selected `batch_norm_fn`
        class (None: identity). A self-modulated norm reads G's z (of
        width `z_dim`, by default G's z_dim); D has none, so it raises
        there as in the JAX package."""
        if self._batch_norm_fn is None:
            return ops.NoBatchNorm()
        if z_dim is None:
            z_dim = getattr(self, "_z_dim", None)
        return utils.call_with_accepted_args(
            self._batch_norm_fn, num_channels=num_channels, y_dim=y_dim,
            z_dim=z_dim, use_sn=self._spectral_norm, device=self._device)

    def jax_variables(self):
        """({jax_name: parameter}, {jax_name: buffer})."""
        return core.named_variables(self, self.name)


@gin.configurable("G", denylist=["name", "image_shape"])
class AbstractGenerator(_Arch):
    def __init__(self, name="generator", image_shape=None, z_dim=None,
                 num_classes=None, batch_norm_fn=None, spectral_norm=False,
                 device=None):
        super().__init__(name, batch_norm_fn, spectral_norm, device)
        self._image_shape = tuple(image_shape) if image_shape else None
        self._z_dim = z_dim
        self._num_classes = num_classes


@gin.configurable("D", denylist=["name"])
class AbstractDiscriminator(_Arch):
    def __init__(self, name="discriminator", image_shape=None,
                 num_classes=None, batch_norm_fn=None, layer_norm=False,
                 spectral_norm=False, device=None):
        super().__init__(name, batch_norm_fn, spectral_norm, device)
        self._layer_norm = layer_norm
        self._image_shape = tuple(image_shape) if image_shape else None
        self._num_classes = num_classes
