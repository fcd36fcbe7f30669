"""Constants used across the port (compare_gan_tpu/gans/consts.py; the JAX
module cannot be imported without importing jax through its package)."""

DCGAN_ARCH = "dcgan_arch"
DUMMY_ARCH = "dummy_arch"
INFOGAN_ARCH = "infogan_arch"
RESNET5_ARCH = "resnet5_arch"
RESNET30_ARCH = "resnet30_arch"
RESNET_BIGGAN_ARCH = "resnet_biggan_arch"
RESNET_BIGGAN_DEEP_ARCH = "resnet_biggan_deep_arch"
RESNET_CIFAR_ARCH = "resnet_cifar_arch"
RESNET_STL_ARCH = "resnet_stl_arch"
SNDCGAN_ARCH = "sndcgan_arch"

ARCHITECTURES = [
    INFOGAN_ARCH, DCGAN_ARCH, RESNET_CIFAR_ARCH, SNDCGAN_ARCH, RESNET5_ARCH,
    RESNET30_ARCH, RESNET_BIGGAN_ARCH, RESNET_BIGGAN_DEEP_ARCH,
    RESNET_STL_ARCH, DUMMY_ARCH,
]

NORMAL_INIT = "normal"
TRUNCATED_INIT = "truncated"
ORTHOGONAL_INIT = "orthogonal"
INITIALIZERS = [NORMAL_INIT, TRUNCATED_INIT, ORTHOGONAL_INIT]
