"""compare_gan_torch: the PyTorch/CUDA port of compare_gan_tpu.

The JAX package (`compare_gan_tpu`) is the reference: every module here keeps
its counterpart's name, its public layouts (images NHWC, attention operands
[B, N, C], conv kernels HWIO in checkpoints) and its variable names, so each
part can be held against the JAX function on the same inputs.

The port imports torch, never jax, and nothing of the JAX package: it keeps
its own copies of the numpy and standard-library modules it needs (the gin
implementation `config`, `datasets` with `polygons` and the native record
reader, `hooks`), which the tests hold to the originals.

The SAGAN attention of the non-local block, forward and backward, runs as
hand-written CUDA kernels (`csrc/attention.cu`, built with nvcc at first use
into `compare_gan_torch/_build/`).

Checkpoints are evaluated by `eval_gan_lib` (BN accumulator fill, EMA
sampling, Inception features from `metrics/inception_net.py` on the weights
of the JAX package's `.npz` layout, FID and IS) behind the CLI's
eval_after_train and continuous_eval schedules; `export` writes and loads
module exports in the JAX package's layout.
"""

__version__ = "0.1.0"
