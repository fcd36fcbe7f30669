"""compare_gan_torch: the PyTorch/CUDA port of compare_gan_tpu.

The JAX package (`compare_gan_tpu`) is the reference: every module here keeps
its counterpart's name, its public layouts (images NHWC, attention operands
[B, N, C], conv kernels HWIO in checkpoints) and its variable names, so each
part can be held against the JAX function on the same inputs.

The port imports torch and never jax. It reuses the JAX package's pure-numpy
modules (datasets, hooks) and a second, independent instance of its gin
implementation (`compare_gan_torch.config`).

The SAGAN attention of the non-local block, forward and backward, runs as
hand-written CUDA kernels (`csrc/attention.cu`, built with nvcc at first use
into `compare_gan_torch/_build/`).
"""

__version__ = "0.1.0"
