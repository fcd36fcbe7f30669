"""The port's op library: arch_ops (layers), rng (random streams) and the
hand-written CUDA attention (fused_attention).

The layer names below are re-exported from `arch_ops` on first access, not
at import: `arch_ops` pulls in the gin config, and a serving process that
imports only `fused_attention` (for its registered operator) must not."""

_ARCH_OPS = (
    "BatchNorm",
    "ConditionalBatchNorm",
    "Conv2d",
    "Deconv2d",
    "EvoNormS0",
    "LayerNorm",
    "Linear",
    "NoBatchNorm",
    "NonLocalBlock",
    "SelfModulatedBatchNorm",
    "SpectralNormKernel",
    "StandardizeBatch",
    "WeightNormConv2d",
    "WeightNormDeconv2d",
    "WeightNormLinear",
    "conv1x1",
    "lrelu",
    "spectral_norm_sigma",
    "weight_initializer",
)


def __getattr__(name):
    if name in _ARCH_OPS:
        from compare_gan_torch.ops import arch_ops
        return getattr(arch_ops, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
