"""Architecture registry: BigGAN and the SN-GAN CIFAR ResNet are ported."""

from compare_gan_torch.architectures import resnet_biggan, resnet_cifar
from compare_gan_torch.gans import consts as c

GENERATORS = {c.RESNET_BIGGAN_ARCH: resnet_biggan.Generator,
              c.RESNET_CIFAR_ARCH: resnet_cifar.Generator}
DISCRIMINATORS = {c.RESNET_BIGGAN_ARCH: resnet_biggan.Discriminator,
                  c.RESNET_CIFAR_ARCH: resnet_cifar.Discriminator}
