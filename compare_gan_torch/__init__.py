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

Training runs in one process, or over several GPUs as synchronous data
parallelism with the JAX package's global-batch semantics (`parallel`:
one worker per device joined by torch.distributed, batch-norm moments and
losses over the global batch, gradients summed over the workers), launched
by `main --num_devices` or `--multihost`.

Checkpoints are evaluated by `eval_gan_lib` (BN accumulator fill, EMA
sampling, Inception features from `metrics/inception_net.py` on the weights
of the JAX package's `.npz` layout, and the ten eval tasks of `metrics/`)
behind the CLI's
eval_after_train and continuous_eval schedules; `export` writes and loads
module exports in the JAX package's layout.
"""

__version__ = "0.1.0"
