"""The port's op library: arch_ops (layers), rng (random streams) and the
hand-written CUDA attention (fused_attention)."""
