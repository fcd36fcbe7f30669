"""The port's op library: arch_ops (layers), rng (random streams) and the
hand-written CUDA attention (fused_attention)."""

from compare_gan_torch.ops.arch_ops import (  # noqa: F401
    BatchNorm,
    ConditionalBatchNorm,
    Conv2d,
    Deconv2d,
    EvoNormS0,
    LayerNorm,
    Linear,
    NoBatchNorm,
    NonLocalBlock,
    SelfModulatedBatchNorm,
    SpectralNormKernel,
    StandardizeBatch,
    WeightNormConv2d,
    WeightNormDeconv2d,
    WeightNormLinear,
    conv1x1,
    lrelu,
    spectral_norm_sigma,
    weight_initializer,
)
