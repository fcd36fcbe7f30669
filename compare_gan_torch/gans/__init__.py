"""GAN trainers. Importing this package registers the configurables the
.gin files reference (losses, penalties, optimizers, the GAN class, the z
sampler and the tf.random aliases)."""

from compare_gan_torch.gans import consts  # noqa: F401
from compare_gan_torch.gans import loss_lib  # noqa: F401
from compare_gan_torch.gans import optimizers  # noqa: F401
from compare_gan_torch.gans import penalty_lib  # noqa: F401
from compare_gan_torch.gans.modular_gan import ModularGAN  # noqa: F401
