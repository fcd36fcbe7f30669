"""Architecture registry (counterpart of
compare_gan_tpu/architectures/__init__.py): every architecture of the JAX
package but BigGAN-deep."""

from compare_gan_torch.architectures import (
    dcgan,
    dummy,
    infogan,
    resnet5,
    resnet30,
    resnet_biggan,
    resnet_cifar,
    resnet_stl,
    sndcgan,
)
from compare_gan_torch.gans import consts as c

GENERATORS = {
    c.DCGAN_ARCH: dcgan.Generator,
    c.DUMMY_ARCH: dummy.Generator,
    c.INFOGAN_ARCH: infogan.Generator,
    c.RESNET5_ARCH: resnet5.Generator,
    c.RESNET30_ARCH: resnet30.Generator,
    c.RESNET_BIGGAN_ARCH: resnet_biggan.Generator,
    c.RESNET_CIFAR_ARCH: resnet_cifar.Generator,
    c.RESNET_STL_ARCH: resnet_stl.Generator,
    c.SNDCGAN_ARCH: sndcgan.Generator,
}

DISCRIMINATORS = {
    c.DCGAN_ARCH: dcgan.Discriminator,
    c.DUMMY_ARCH: dummy.Discriminator,
    c.INFOGAN_ARCH: infogan.Discriminator,
    c.RESNET5_ARCH: resnet5.Discriminator,
    c.RESNET30_ARCH: resnet30.Discriminator,
    c.RESNET_BIGGAN_ARCH: resnet_biggan.Discriminator,
    c.RESNET_CIFAR_ARCH: resnet_cifar.Discriminator,
    c.RESNET_STL_ARCH: resnet_stl.Discriminator,
    c.SNDCGAN_ARCH: sndcgan.Discriminator,
}
