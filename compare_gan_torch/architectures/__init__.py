"""Architecture registry. Only BigGAN is ported so far."""

from compare_gan_torch.architectures import resnet_biggan
from compare_gan_torch.gans import consts as c

GENERATORS = {c.RESNET_BIGGAN_ARCH: resnet_biggan.Generator}
DISCRIMINATORS = {c.RESNET_BIGGAN_ARCH: resnet_biggan.Discriminator}
