#!/usr/bin/env python3
"""Smoke run of the PyTorch port (compare_gan_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. Device: a CUDA card must be present; prints its name and power limit
   (nvidia-smi) and turns TF32 off for the comparisons.
2. Build: compiles the CUDA kernels of compare_gan_torch/csrc with nvcc
   (sm_90a) into compare_gan_torch/_build and prints the seconds it took
   and, per kernel, ptxas's registers and spill bytes.
3. Kernels: the attention forward and backward kernels against their plain
   PyTorch versions at the two training shapes (BigGAN-128 G after B4 and
   D after B1, batch 32), in f32 and bf16, and the forward at the eval
   shape (G after B4 at batch 64, f32: eval samples z in f32 and
   `compute_dtype` does not apply); S3GAN's D shape (batch 38) and
   BigGAN-deep's (G after B8 and D after B2: C = 32, Cg = 128) in both
   types, and BigGAN-deep's eval forward (batch 64, f32); and the
   convergence configurations' f32 shapes (BigGAN-128's G after B4 at its
   sub-step batch of 16; S3GAN-32's D after B1 on 152 rows of 16x16).
   Prints each
   tensor's max abs and
   relative error with its tolerance; the time per call of the kernel, of
   the plain version and of the library call that computes the same
   function (torch's scaled_dot_product_attention with one head and
   scale 1, forward, and its backward through torch.autograd.grad; the
   port never calls it), with the SDPA backend that served it (CUDA
   events, 20 calls after a warm-up); each kernel's bound (the least
   time the card could take: its operations over the tensor-core peak for
   the input type, bf16 or TF32 for f32, or its bytes over the memory
   rate, whichever is larger) with the kernel's share of it; and the
   forward's issued-MMA floor (the bf16 MMAs it issues, four per product
   for f32 inputs split into hi + lo parts, at the bf16 peak).
4. Main path: 3 BigGAN-128 training steps at full width through the port's
   CLI (compare_gan_torch.main.main) with the benchmark options: batch 16,
   bf16 activations, joint G forward for the D sub-steps, fake-only G loss,
   fake ImageNet-128 data, random weights from the default seed. Checks the
   parameter counts (G 70,433,988, D 87,982,370), finite losses,
   model.ckpt-3.npz and TRAIN_DONE, that every kernel ran during the run
   (launch counters reset to 0 just before it), and that G's samples are
   finite images in [0, 1]. Prints losses, counters, seconds per step
   after the first, and peak device memory.
5. Eval: in the same model_dir (with evaluation.eval_tasks = IS and FID),
   `compare_gan_torch.main.main` with
   --schedule=eval_after_train --eval_every_steps=0: restore model.ckpt-3,
   export the module to tfhub/3, fill the BN accumulators
   (evaluation.num_accu_examples = 1024 at batch 64: 16 G forwards), sample
   3 averaging runs of the 100 fake-ImageNet eval images with the EMA G (2
   batches each), Inception features of fakes and reals, FID and IS, one
   scores.csv row. Inception has random weights from a fixed seed (no real
   weights are in the repository), written as the JAX package's .npz;
   before the eval its features on the card are held against the CPU's on
   4 images. Checks the row (finite FID and IS, no sentinel), the export,
   the filled state (switch back at 0, 16 updates counted), eval-mode
   samples, and the attention launches (16 + 3 * 2 forwards). Prints the
   scores, the seconds and the peak device memory of each phase, and
   images per second.
6. Serving: the eval's accumulator-filled step-3 state of the main
   path's BigGAN-128 (EMA shadows) exported as a serving program
   (export.export_serving_program: one torch.export program with a dynamic
   batch, signatures gen_bs8, 16, 32 and 64) and as a module export.
   A fresh process (`serving_worker`) loads the program through
   serving.load_serving_program on the card and must import no module of
   compare_gan_torch.architectures, .gans or .config; it runs every
   signature once (images finite, in [0, 1], one forward launch) and 10
   times more (images/s), and gen_bs8 on the CPU (the plain operator, no
   launch). The card's images are held to eager export.load_generator on
   the module export (10 more calls each for its images/s) and gen_bs8 to
   the CPU's, f32 within 1e-4 of the largest entry. The artifact must be
   within 1.25x of G's weights and state. Then compare_gan_torch.demo on
   the module export: both PNGs decode to their grid shapes, D's
   predictions are finite, 3 forward launches. Prints export and load
   seconds, artifact bytes and images/s of program and eager.
7. Data parallel: (a) the BigGAN-128 phases' CLI run with --num_devices=1
   (3 steps at full width, batch 16, bf16) goes through the data-parallel
   path on a one-rank NCCL group: the same checks as phase 4 (parameter
   counts, finite losses, model.ckpt-3.npz, TRAIN_DONE, 5 forward and 4
   backward attention launches a step), every all-reduce counted and on
   NCCL; prints its seconds per step beside phase 4's; and
   --num_devices=2 must raise on a one-card machine. (b) Two spawned
   workers, both on cuda:0 over gloo (NCCL puts no two ranks on one
   device), take one BigGAN-128 step at full width and global batch 16
   (8 a worker) in f32 with TF32 off, deterministic cuDNN and Adam's
   epsilon at 1e-3; their states must be equal bitwise, and rank 0's is
   held to the one-process step on the same batch and draws, tensor by
   tensor and by state kind (parameters, Adam moments, BN accumulators, SN
   u, EMA) at the tolerances of DP_TOL. Beside it are printed the gaps of
   the one-process step run again and with autotuned cuDNN algorithms
   (the card's own spread), and of a control in which the workers do not
   sum their gradients, which must fail DP_TOL. Each worker runs 5
   forward and 4 backward attention launches at 8 rows. Its seconds are
   gloo through the host on one card, no figure for NCCL on several
   cards.
   Spatial (after (b)): two spawned gloo workers on cuda:0 as a `data 1
   x model 2` grid (image height in two bands of 64 rows: halo rows in
   every conv, moments over the grid, the attention on each band's 2048
   queries against all 1024 keys) take one BigGAN-128 step at full width
   with the benchmark options and Adam's epsilon at 1e-3, in bf16 and in
   f32 (TF32 off, deterministic cuDNN). The f32 state is held to the
   one-process step by state kind (DP_TOL), and two faulty controls
   (SPATIAL_CONTROLS: convs without halos; the gradients of what every
   model rank computes whole summed twice) must fail it; the bf16 gaps
   are printed beside the one-process step's own spread with autotuned
   cuDNN. Ranks bitwise equal, all finite, 5 forward and 4 backward
   launches a worker in each precision, every one at N 2048, M 1024 and
   held to the plain version on its operands. The bf16 step's launches
   count as the main path's.
8. S3GAN main path: 3 steps of S3GAN on BigGAN-128 at full width through
   the CLI with example_configs/s3gan32_polygons_partial.gin on fake
   ImageNet-128: batch 16, rotation (rotated_batch_fraction 4), projection
   and soft predictor heads, bf16, joint G forward, fake-only G loss off.
   D sees [real, real-rot, fake, fake-rot] = 2*16 + 2*3*1 = 38 rows, the
   shape the kernels phase also holds to plain (D after B1 at batch 38,
   f32 and bf16). Checks the parameter counts (G 70,433,988; D with its
   heads 89,525,518), finite losses (the rotation and class losses
   included), the three head scopes in model.ckpt-3.npz, TRAIN_DONE and
   the attention launches (5 forward and 4 backward per step). Prints
   seconds per step after the first and peak device memory.
9. SSGAN main path: 3 steps of SSGAN on ResNet-CIFAR-32 at its published
   widths through the CLI with example_configs/ssgan32_polygons_oriented.gin
   on fake CIFAR-10 (batch 64, 64 rotated examples: D sees 224 rows, f32).
   Checks the parameter counts (G 5,849,603; D with its head 1,483,653),
   finite losses (the rotation losses included), the checkpoint and that
   no attention kernel ran (the architecture has no attention). Prints
   seconds per step and peak device memory.
10. Study zoo: 3 steps each of resnet_lsun-bedroom128.gin (ResNet5,
   Wasserstein loss with the WGAN-GP penalty, lambda 10, 5 D sub-steps,
   each with a double backward), sndcgan_celebahq128.gin and
   dcgan_celeba64.gin through the CLI, as published (batch 64, 128, 128
   and 64 px, f32 with TF32 off) on fake data. Checks the parameter counts
   against the JAX package's (tests/test_torch_study_archs.py), finite
   losses, a WGAN-GP penalty > 0, the checkpoint and that no attention
   kernel ran. Then one WGAN-GP D sub-step's loss and D gradients on the
   card against the port's CPU run on the same weights, images and alpha
   (ResNet5 at ch 16, 128 px, batch 8), beside what another alpha moves
   them by; and that a gradient penalty through the attention kernel
   raises (its gradient is first order only). Prints seconds per step,
   peak device memory and the gradient gaps, and a `study_zoo {...}` line.
11. BigGAN-deep main path: 3 steps of BigGAN-deep-128 as published (ch
   128, z_dim 128; arXiv:1809.11096, Tables 7-9) through the CLI with the
   BigGAN-128 phases' config and options (batch 16, bf16, joint G forward,
   fake-only G loss, fake ImageNet-128) and options.architecture =
   'resnet_biggan_deep_arch'. G concatenates z to the f32 label embedding,
   so it runs in f32, as in the JAX package; D runs in bf16. Checks the
   parameter counts (G 50,244,484, D 34,590,210), finite losses, the
   checkpoint and the attention launches (5 forward and 4 backward a
   step). Then eval_after_train of its checkpoint at the eval phase's cut
   with IS, FID, KID, PRD, MS-SSIM and the fractal dimension: every metric
   finite in the row, 16 + 3 * 2 forward launches, each phase's and each
   task's seconds and peak memory.
12. G/D-access tasks: eval_after_train of the study zoo's DCGAN-64
   checkpoint (dcgan_celeba64.gin as published: unconditional, uniform z)
   with all ten tasks, adding the Jacobian's conditioning, D's accuracy
   and GILBO at its defaults (2,000 regressor steps at batch 64, its
   artifacts written and checked). Every metric finite; each task's
   seconds.
13. TF formats: the port reads and writes TensorFlow's files without
   TensorFlow (it checks that tensorflow, PIL and google.protobuf were never
   loaded). Every committed image fixture (tests/torch_fixtures: JPEG
   4:2:0, 4:4:4, 4:2:2, progressive, grayscale, restart intervals; PNG 8-
   and 16-bit, alpha, palette, interlaced) decodes bitwise to its
   tf.io.decode_image golden; prints the JPEG decode rate of the 128x96
   4:2:0 fixture in one thread and in the input pipeline's 8-thread pool,
   and the ImageNet-128 train pipeline's images per second. Writes TFDS's
   imagenet2012 layout from the RGB JPEG fixtures with the port's Example
   encoder and TFRecord framing (64 train, 100 validation records), trains
   BigGAN-128 on it through the CLI without --data_fake_dataset (the
   BigGAN-128 phases' options and checks: parameter counts, finite losses,
   5 forward and 4 backward launches a step, seconds per step), exports the
   trained TrainState as a reference TF checkpoint
   (export_reference_checkpoint, ~228 M values) and re-imports it through
   `python -m compare_gan_torch.import_tf_checkpoint`'s main: every
   variable of the re-imported checkpoint must equal the trained one
   bitwise; prints both times. Then eval_after_train of the re-imported
   model_dir at the eval phase's cut on 100 real validation images (the
   registry's 50,000 cut to 100), with the eval phase's checks.
14. Convergence tools: the port's convergence-proof tools
   (compare_gan_torch/tools) on short runs of the two convergence
   configurations as published (f32), on small polygon sets written by
   compare_gan_torch.polygons: BigGAN-128 at full width
   (biggan128_polygons_multiclass.gin, batch 16; 256 train and 128 test
   images at 128 px) for 24 steps with checkpoints at 12 and 24 and the
   EMA from step 4, then eval_ema_vs_raw at a fill of 256 samples (both
   rows' FIDs finite and EMA != raw, 24 forward launches), fid_anchors
   (real-vs-real below real-vs-noise) and tb_scalars (the event files and
   the JSONL rows give the same series, tag by tag); S3GAN-32
   (s3gan32_polygons_partial_oriented.gin, batch 64) for 24 steps, then
   s3gan_predictor_eval (a row per checkpoint, accuracy in [0, 1], 12
   forward launches) and rotation_probe (oriented test accuracy above the
   invariant one). Each run's launches are exact: 6 forward and 4
   backward a BigGAN-128 step, 3 and 3 an S3GAN-32 step.
15. Kernel trajectory: BigGAN-128 as published
   (biggan128_polygons_multiclass.gin: full width, batch 16, f32) with
   TF32 off, deterministic cuDNN, Adam's epsilon at 1e-3 and the
   attention gates opened to TRAJ_GATE, trained TRAJ_STEPS steps four
   times from one init on the same polygon batches and draws, the
   attention each time another way: `reference_attention` on the CUDA
   tensors, the same on operands rounded to the f32 kernels' own
   precision (bf16 hi + lo parts), through the kernels, and through the
   kernels fed bf16-rounded operands (a control). The first training
   check through the kernels over more than one call: at every step the
   kernel run's D and G loss gap to the plain run, and at the end its
   weights' rms gap over the update, must be at most TRAJ_MARGIN times the
   rounded plain run's (plus TRAJ_FLOOR for the losses); the control must
   exceed that bound. Launches: 6 forward and 4 backward a step through
   the kernels, none in the plain runs (a comparison: not counted as the
   main path's).
16. Prints the eval shape's forward row, the spatial bands' bf16 rows
   (`spatial_shape {...}`: G after B4 and D after B1 at B 32, N 2048, M
   1024, with the spatial step's launches), the spatial summary
   (`spatial {...}`), the S3GAN D shape's bf16 row and the BigGAN-deep
   rows as JSON lines of their own (`eval_shape_forward
   {...}`, `s3gan_shape {...}`, one `biggan_deep_shape {...}` per type and
   the eval forward: tolerances, SDPA backend, times, bound and share),
   the BigGAN-deep eval, G/D-task, data-parallel, TF-format and serving
   summaries, the convergence shapes (`convergence_shape {...}`), the
   convergence tools' summary (`convergence_tools {...}`), the trajectory
   gaps and bound (`kernel_trajectory_gaps {...}`),
   each phase's seconds, then
   one JSON line describing each kernel ("ms",
   "plain_ms", "library_ms", "bound_ms": one call at each bf16 training
   shape of BigGAN-128, G and D at batch 32, summed; "launches": every
   main-path run together, each counted from 0), then, as the last line,
   {"ok": true, "device": {...}}.
"""

import contextlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
# (B, N, M, C, Cg) of the non-local block on the main path at 128 px: the
# training shapes, run forward and backward in f32 and bf16, and the eval
# shape, run forward in f32.
SHAPES = {"G_B4": (32, 4096, 1024, 24, 96), "D_B1": (32, 4096, 1024, 12, 48)}
EVAL_SHAPE = ("G_B4_eval", (64, 4096, 1024, 24, 96))
# S3GAN's D batch at 16 per sub-step: real and fake, plus 3 rotations of
# 16 / 4 / 4 = 1 example each.
S3GAN_BATCH, S3GAN_ROTATED_FRACTION = 16, 4
S3GAN_D_ROWS = 2 * S3GAN_BATCH + 2 * 3 * (S3GAN_BATCH
                                          // S3GAN_ROTATED_FRACTION // 4)
S3GAN_SHAPE = ("D_B1_s3gan", (S3GAN_D_ROWS, 4096, 1024, 12, 48))
# BigGAN-deep-128 at ch 128: G after B8 and D after B2 are both the 64x64
# map with 256 channels (C = 32, Cg = 128), batch 32 in training (the
# joint G forward over two D sub-steps; D on real and fake); the eval's G
# forward at batch 64, f32.
DEEP_SHAPE = ("deep_B8_B2", (32, 4096, 1024, 32, 128))
DEEP_EVAL_SHAPE = ("deep_G_B8_eval", (64, 4096, 1024, 32, 128))
DEEP_PARAMS = (50244484, 34590210)
# The convergence configurations as published, in f32: BigGAN-128
# (biggan128_polygons_multiclass.gin) runs G after B4 at its sub-step
# batch of 16 (D after B1 on 32 rows is SHAPES' f32 row); S3GAN-32
# (s3gan32_polygons_partial_oriented.gin, batch 64) has attention in D
# only, after B1 at 16x16 (N 256, M 64) on 2 * 64 + 2 * 3 * 4 = 152 rows.
CONVERGENCE_SHAPES = (("G_B4_b16", (16, 4096, 1024, 24, 96)),
                      ("D_B1_s3gan32", (152, 256, 64, 24, 96)))
# The spatial phase's bands (BigGAN-128 at batch 16, bf16, image height in
# 2 bands): G after B4 and D after B1 on 32 rows, each worker's 2048 queries
# (32 of 64 rows of the 64x64 map) against all 1024 pooled keys.
SPATIAL_SHAPES = (("G_B4_band", (32, 2048, 1024, 24, 96)),
                  ("D_B1_band", (32, 2048, 1024, 12, 48)))
DEEP_BINDINGS = ("options.architecture = 'resnet_biggan_deep_arch'",
                 "options.z_dim = 128")
# The eval tasks of the two eval phases that add tasks (class names of
# compare_gan_torch.metrics): the six that read only samples and features
# on BigGAN-deep, and with them the three that need G or D on DCGAN-64
# (unconditional, uniform z: GILBO refuses any other prior and every G/D
# task a conditional model).
SESSION_TASKS = ("InceptionScoreTask", "FIDScoreTask", "KIDScoreTask",
                 "PRDTask", "MultiscaleSSIMTask", "FractalDimensionTask")
GAN_TASKS = ("GeneratorConditionNumberTask", "AccuracyTask", "GILBOTask")
# f32: the same f32 arithmetic summed in another order. bf16: both sides
# round one f32 result to bf16 (the JAX package's Pallas tests use 2e-2).
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
G_PARAMS, D_PARAMS = 70433988, 87982370
# G and D with its heads (tests/test_torch_resnet_cifar.py takes both from
# the JAX package's init_state).
S3GAN_PARAMS = (70433988, 89525518)
SSGAN_PARAMS = (5849603, 1483653)
# The study zoo's configurations as published, with the JAX package's
# (G, D) parameter counts (tests/test_torch_study_archs.py).
STUDY_ZOO = {
    "resnet5_wgangp": ("resnet_lsun-bedroom128.gin", (13786115, 15086529)),
    "sndcgan": ("sndcgan_celebahq128.gin", (19926019, 5983745)),
    "dcgan": ("dcgan_celeba64.gin", (5364739, 4314753)),
}
# The card-vs-CPU WGAN-GP D sub-step: ResNet5 at ch 16, 128 px, batch 8.
# Its gradients are f32 sums of the same products taken in another order by
# cuDNN and oneDNN (TF32 off), through ~20 convolutions forward and the
# penalty's double backward: each tensor within 1e-3 of its largest entry
# (1e-6 per conv compounded, with room); another alpha moves them by ~1e-1.
GRAD_CHECK_CH, GRAD_CHECK_BATCH, GRAD_TOL = 16, 8, 1e-3
HEAD_SCOPES = ("discriminator_rotation/", "discriminator_predictor/",
               "discriminator_projection/")
STEPS = 3
EVAL_BATCH, ACCU_EXAMPLES, AVERAGING_RUNS, EVAL_SAMPLES = 64, 1024, 3, 100
# Inception on the card against the CPU, both full f32: relative to the
# largest magnitude of the CPU's features.
INCEPTION_TOL = 1e-4
# Published peaks of one H100 SXM (dense) and the memory rate. f32 operands
# take the TF32 tensor-core rate, the card's fastest for them (67 TFLOP/s
# outside the tensor cores is no floor for a kernel that runs its f32
# products on the tensor cores, as this one does).
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 495e12}
PEAK_BYTES = 3.35e12
# torch.nn.attention.SDPBackend by value.
SDPA_BACKENDS = {0: "math", 1: "flash", 2: "efficient", 3: "cudnn",
                 4: "overrideable"}


def _phase(name):
    print(f"== {name}", flush=True)


def check_device(torch):
    _phase("device")
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available()"
                         " is False); nothing was run.")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60,
        check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device_count {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def ptxas_report(log):
    """[(kernel, registers, spill store bytes, spill load bytes)] of each
    entry function in nvcc's `-Xptxas -v` output, the kernel named as
    `attention_bwd_cols_kernel<bf16, 32, 128>` from its mangled name."""
    import re
    out, name, spills = [], None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name, spills = m.group(1), (0, 0)
            k = re.search(r"(attention_(?:fwd|bwd_rows|bwd_cols)_kernel)I"
                          r"(f|13__nv_bfloat16)Li(\d+)ELi(\d+)E", name)
            if k:
                dtype = "f32" if k.group(2) == "f" else "bf16"
                name = f"{k.group(1)}<{dtype}, {k.group(3)}, {k.group(4)}>"
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name is not None:
            out.append((name, int(m.group(1))) + spills)
            name = None
    return out


def build_kernels():
    _phase("build")
    from compare_gan_torch.ops import _build
    t0 = time.perf_counter()
    _build.library()
    print(f"build_seconds {time.perf_counter() - t0:.2f}")
    for name, registers, stores, loads in ptxas_report(_build.build_log):
        print(f"  ptxas {name}: {registers} registers, {stores} bytes "
              f"spill stores, {loads} bytes spill loads")


def _time_ms(torch, fn, iters=20):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _errors(torch, got, want, tol, what):
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    max_abs = diff.max().item()
    max_rel = (diff / want.abs().clamp_min(1e-6)).max().item()
    ok = bool((diff <= tol + tol * want.abs()).all().item())
    print(f"  {what:8s} max_abs {max_abs:.3e} max_rel {max_rel:.3e} "
          f"tol {tol:g} (abs + rel) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{what}: kernel and plain version disagree "
                             f"beyond {tol:g}")
    return max_abs


def bounds_ms(shape, dtype_name):
    """{kernel: (bound ms, "bytes" or "operations")} for one call at
    `shape`: the forward's products S = theta.phi^T and O = P.g take
    2*B*N*M*(C + Cg) flops; the backward's (S, dP = dout.g^T, dtheta,
    dphi, dg) 2*B*N*M*(3C + 2Cg). Bytes: each input read once, each output
    written once (mx, den, dphi, dg in f32)."""
    b, n, m, c, cg = shape
    e = 2 if dtype_name == "bfloat16" else 4
    work = {
        "fwd": (2 * b * n * m * (c + cg),
                e * (b * n * c + b * m * (c + cg) + b * n * cg) + 8 * b * n),
        "bwd": (2 * b * n * m * (3 * c + 2 * cg),
                e * (2 * b * n * c + b * m * (c + cg) + b * n * cg)
                + 8 * b * n + 4 * b * m * (c + cg)),
    }
    out = {}
    for k, (flops, nbytes) in work.items():
        t_ops, t_bytes = flops / PEAK_FLOPS[dtype_name], nbytes / PEAK_BYTES
        out[k] = (1e3 * max(t_ops, t_bytes),
                  "operations" if t_ops >= t_bytes else "bytes")
    return out


def issued_fwd_ms(shape, dtype_name):
    """The forward's own tensor-core floor: the bf16 MMAs it issues at its
    padded widths (csrc/attention.cu: C to CP, Cg to GP) over 989 TFLOP/s.
    f32 inputs are split into bf16 hi + lo parts, so S = theta.phi^T takes
    four MMAs per product and O = P.g (P rounded to bf16) two."""
    b, n, m, c, cg = shape
    cp, gp = (16, 48) if c <= 16 and cg <= 48 else (
        (32, 96) if cg <= 96 else (32, 128))
    s_mmas, o_mmas = (4, 2) if dtype_name == "float32" else (1, 1)
    return 1e3 * 2 * b * n * m * (s_mmas * cp + o_mmas * gp) \
        / PEAK_FLOPS["bfloat16"]


def _sdpa_backend(torch, q, k, v):
    try:
        return SDPA_BACKENDS.get(int(torch._fused_sdp_choice(q, k, v,
                                                             scale=1.0)),
                                 "unknown")
    except (AttributeError, RuntimeError, TypeError):
        return "unknown"


def _cases():
    """(name, shape, dtype name, with backward, summed into the JSON line)
    of every kernel comparison: the line sums the bf16 training shapes of
    BigGAN-128; the eval shape and the S3GAN D shape are reported on lines
    of their own."""
    for name, shape in SHAPES.items():
        for dtype_name in ("float32", "bfloat16"):
            yield name, shape, dtype_name, True, dtype_name == "bfloat16"
    yield EVAL_SHAPE + ("float32", False, False)
    for dtype_name in ("float32", "bfloat16"):
        yield S3GAN_SHAPE + (dtype_name, True, False)
    for dtype_name in ("float32", "bfloat16"):
        yield DEEP_SHAPE + (dtype_name, True, False)
    yield DEEP_EVAL_SHAPE + ("float32", False, False)
    for shape in CONVERGENCE_SHAPES:
        yield shape + ("float32", True, False)
    for shape in SPATIAL_SHAPES:
        yield shape + ("bfloat16", True, False)


def compare_kernels(torch):
    """Kernel vs plain version per shape and type. Returns per kernel its
    max abs error over every case, and times and bounds summed over the
    bf16 training shapes; the eval shape's forward row; the S3GAN D
    shape's bf16 row (forward and backward); the BigGAN-deep rows (each
    type's forward and backward at batch 32, the eval forward); the
    convergence configurations' f32 rows; and the spatial bands' bf16
    rows."""
    _phase("kernels")
    from compare_gan_torch.ops import fused_attention as fa
    sdpa = torch.nn.functional.scaled_dot_product_attention
    dev = torch.device("cuda")
    result = {k: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
                  "library_ms": 0.0, "bound_ms": 0.0, "bound_by": ""}
              for k in ("fwd", "bwd")}
    eval_row = s3gan_row = None
    deep_rows, convergence_rows, spatial_rows = [], [], []
    for name, (b, n, m, c, cg), dtype_name, with_bwd, summed in _cases():
        dtype = getattr(torch, dtype_name)
        tol = TOL[dtype_name]
        gen = torch.Generator(device=dev).manual_seed(0)
        # theta, phi scaled by C**-0.25: unit-normal scores.
        theta = (torch.randn(b, n, c, device=dev, generator=gen)
                 * c ** -0.25).to(dtype)
        phi = (torch.randn(b, m, c, device=dev, generator=gen)
               * c ** -0.25).to(dtype)
        g = torch.randn(b, m, cg, device=dev, generator=gen).to(dtype)
        dout = torch.randn(b, n, cg, device=dev, generator=gen).to(dtype)
        print(f"{name} B={b} N={n} M={m} C={c} Cg={cg} {dtype_name}"
              + ("" if with_bwd else " (forward only)"))

        out, mx, den = fa.attention_fwd(theta, phi, g)
        torch.cuda.synchronize()
        p_out, p_mx, p_den = fa.attention_fwd_plain(theta, phi, g)
        fwd_err = max(_errors(torch, out, p_out, tol, "out"),
                      _errors(torch, mx, p_mx, 1e-4, "mx"),
                      _errors(torch, den, p_den, 1e-4, "den"))
        result["fwd"]["max_abs_err"] = max(result["fwd"]["max_abs_err"],
                                           fwd_err)
        del p_out

        bwd_err = 0.0
        if with_bwd:
            dth, dph, dg = fa.attention_bwd(theta, phi, g, dout, mx, den)
            torch.cuda.synchronize()
            plain = fa.attention_bwd_plain(theta, phi, g, dout, p_mx, p_den)
            leaves = [x.detach().requires_grad_() for x in (theta, phi, g)]
            auto = torch.autograd.grad(fa.reference_attention(*leaves),
                                       leaves, grad_outputs=dout)
            err = 0.0
            for what, got, want_plain, want_auto in zip(
                    ("dtheta", "dphi", "dg"), (dth, dph, dg), plain, auto):
                err = max(err, _errors(torch, got, want_plain, tol, what),
                          _errors(torch, got.to(dtype), want_auto, tol,
                                  what + "*"))
            result["bwd"]["max_abs_err"] = max(result["bwd"]["max_abs_err"],
                                               err)
            bwd_err = err
            del plain, auto, leaves

        # The library call: one head, scale 1, value width Cg != C.
        q, k, v = (x.unsqueeze(1) for x in (theta, phi, g))
        times = {
            "fwd": _time_ms(torch, lambda: fa.attention_fwd(theta, phi, g)),
            "fwd_plain": _time_ms(torch, lambda: fa.attention_fwd_plain(
                theta, phi, g)),
            "fwd_library": _time_ms(torch, lambda: sdpa(q, k, v, scale=1.0)),
        }
        if with_bwd:
            leaves = [x.detach().requires_grad_() for x in (q, k, v)]
            lib_out = sdpa(*leaves, scale=1.0)
            lib_dout = dout.unsqueeze(1)
            times.update({
                "bwd": _time_ms(torch, lambda: fa.attention_bwd(
                    theta, phi, g, dout, mx, den)),
                "bwd_plain": _time_ms(torch, lambda: fa.attention_bwd_plain(
                    theta, phi, g, dout, mx, den)),
                "bwd_library": _time_ms(torch, lambda: torch.autograd.grad(
                    lib_out, leaves, grad_outputs=lib_dout,
                    retain_graph=True)),
            })
            del leaves, lib_out, lib_dout
        backend = _sdpa_backend(torch, q, k, v)
        print("  ms/call " + " ".join(f"{k} {v:.4f}"
                                      for k, v in times.items())
              + f" (sdpa backend {backend})")
        kerns = ("fwd", "bwd") if with_bwd else ("fwd",)
        shape = (b, n, m, c, cg)
        bounds = bounds_ms(shape, dtype_name)
        for kern in kerns:
            bound, by = bounds[kern]
            print(f"  {kern} bound {bound:.4f} ms ({by}, "
                  f"{PEAK_FLOPS[dtype_name] / 1e12:g} TFLOP/s, "
                  f"{PEAK_BYTES / 1e12:g} TB/s): kernel at "
                  f"{100 * bound / times[kern]:.1f}% of it")
            if summed:
                r = result[kern]
                r["ms"] += times[kern]
                r["plain_ms"] += times[kern + "_plain"]
                r["library_ms"] += times[kern + "_library"]
                r["bound_ms"] += bound
                r["bound_by"] = by
        issued = issued_fwd_ms(shape, dtype_name)
        print(f"  fwd issued-MMA floor {issued:.4f} ms (bf16 MMAs at "
              f"{PEAK_FLOPS['bfloat16'] / 1e12:g} TFLOP/s): kernel at "
              f"{100 * issued / times['fwd']:.1f}% of it")
        rows = {kern: {
            "name": f"attention_{kern}", "shape": name, "B": b,
            "dtype": dtype_name,
            "max_abs_err": fwd_err if kern == "fwd" else bwd_err,
            "ms": times[kern], "plain_ms": times[kern + "_plain"],
            "library_ms": times[kern + "_library"],
            "bound_ms": bounds[kern][0], "bound_by": bounds[kern][1]}
            for kern in kerns}
        if (name, shape) == EVAL_SHAPE:
            eval_row = dict(rows["fwd"], issued_mma_ms=issued)
        if (name, shape) == S3GAN_SHAPE and dtype_name == "bfloat16":
            s3gan_row = {"shape": name, "B": b, "dtype": dtype_name,
                         "fwd": dict(rows["fwd"], issued_mma_ms=issued),
                         "bwd": rows["bwd"]}
        if (name, shape) in (DEEP_SHAPE, DEEP_EVAL_SHAPE):
            deep_rows.append(deep_shape_row(name, b, dtype_name, backend,
                                            rows, issued))
        if (name, shape) in CONVERGENCE_SHAPES:
            convergence_rows.append(deep_shape_row(name, b, dtype_name,
                                                   backend, rows, issued))
        if (name, shape) in SPATIAL_SHAPES:
            spatial_rows.append(deep_shape_row(name, b, dtype_name, backend,
                                               rows, issued))
        del q, k, v, theta, phi, g, dout, out, mx, den, p_mx, p_den
        torch.cuda.empty_cache()
    return (result, eval_row, s3gan_row, deep_rows, convergence_rows,
            spatial_rows)


def deep_shape_row(name, b, dtype_name, backend, rows, issued):
    """The `biggan_deep_shape` line's object: the tolerances, the SDPA
    backend, per kernel ("fwd", "bwd" when timed) its row of
    `compare_kernels` with the kernel's share of its bound, and the
    forward's issued-MMA floor."""
    return {"shape": name, "B": b, "dtype": dtype_name,
            "tol": TOL[dtype_name], "mx_den_tol": 1e-4,
            "sdpa_backend": backend,
            **{kern: dict(row, share=row["bound_ms"] / row["ms"])
               for kern, row in rows.items()},
            "fwd_issued_mma_ms": issued}


def _cli_argv(model_dir, config, bindings, schedule="train",
              fake_data=True):
    """A CLI run on the card, on fake data unless `fake_data` is False:
    `config` from example_configs with `bindings` on top, 3 steps, one host
    sync per step, one checkpoint at the end."""
    return [
        f"--model_dir={model_dir}", f"--schedule={schedule}",
        "--device=cuda"] + (["--data_fake_dataset"] if fake_data else []) + [
        f"--gin_config={os.path.join(ROOT, 'example_configs', config)}",
        f"--gin_bindings=options.training_steps = {STEPS}",
        "--gin_bindings=run_config.iterations_per_loop = 1",
        f"--gin_bindings=run_config.save_checkpoints_steps = {STEPS}",
    ] + [f"--gin_bindings={b}" for b in bindings]


BIGGAN_BINDINGS = ("options.batch_size = 16",
                   "ModularGAN.compute_dtype = 'bfloat16'",
                   "ModularGAN.experimental_joint_gen_for_disc = True",
                   "ModularGAN.experimental_fake_only_g_loss = True")


def _argv(model_dir, schedule, extra=(), fake_data=True):
    """The CLI arguments of the BigGAN-128 phases: the benchmark
    options, and `extra` bindings."""
    return _cli_argv(model_dir, "biggan_imagenet128.gin",
                     list(BIGGAN_BINDINGS) + list(extra), schedule,
                     fake_data)


def _deep_argv(model_dir, schedule):
    """BigGAN-deep-128 as published (ch 128, z_dim 128; arXiv:1809.11096,
    Tables 7-9) with the BigGAN-128 phases' options."""
    return _argv(model_dir, schedule, DEEP_BINDINGS)


def _train_and_check(torch, model_dir, argv, params, expected_launches,
                     losses=(), head_scopes=()):
    """Train through the CLI with every launch counter at 0; check the
    parameter counts (G, D with its heads), finite losses (`losses` among
    them), the steps, model.ckpt-3.npz (with `head_scopes`), TRAIN_DONE
    and the attention launches; print seconds per step and peak memory.
    Returns (report, launches)."""
    from compare_gan_torch import config as gin
    from compare_gan_torch import core, main
    from compare_gan_torch.ops import fused_attention as fa
    gin.clear_config()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    fa.launches_fwd = fa.launches_bwd = 0
    report = main.main(argv)
    launches = {"fwd": fa.launches_fwd, "bwd": fa.launches_bwd}
    torch.cuda.synchronize()

    ts = report.state
    counts = (core.count_params(ts.generator),
              core.count_params(ts.discriminator)
              + core.count_params(ts.heads))
    print(f"params G {counts[0]:,} D with heads {counts[1]:,}")
    if counts != tuple(params):
        raise AssertionError(f"parameter counts {counts} != {params}")
    for step, metrics in zip(report.steps, report.metrics):
        print(f"step {step} " + " ".join(
            f"{k}={v:.6f}" for k, v in sorted(metrics.items())))
        if not all(v == v and abs(v) != float("inf")
                   for v in metrics.values()):
            raise AssertionError(f"non-finite losses at step {step}")
        missing = set(losses) - set(metrics)
        if missing:
            raise AssertionError(f"losses {sorted(missing)} not reported")
    if report.steps != list(range(1, STEPS + 1)) or ts.step != STEPS:
        raise AssertionError(f"trained steps {report.steps}, not {STEPS}")
    for name in (f"model.ckpt-{STEPS}.npz", "TRAIN_DONE"):
        if not os.path.exists(os.path.join(model_dir, name)):
            raise AssertionError(f"{name} was not written")
    if head_scopes:
        import numpy as np
        with np.load(os.path.join(model_dir, f"model.ckpt-{STEPS}.npz")) as d:
            found = [scope for scope in head_scopes if any(
                k.startswith(f".params['{scope}") for k in d.files)]
        print(f"checkpoint head scopes {found}")
        if found != list(head_scopes):
            raise AssertionError(f"checkpoint lacks head scopes: "
                                 f"{sorted(set(head_scopes) - set(found))}")
    print(f"kernel launches {launches} (expected {expected_launches})")
    if launches != expected_launches:
        raise AssertionError(f"kernel launches {launches} != "
                             f"{expected_launches}")
    per_step = report.seconds_per_step[1:]
    print("seconds_per_step_after_first " + " ".join(
        f"{s:.4f}" for s in per_step)
        + f" (first {report.seconds_per_step[0]:.3f})")
    print(f"peak_memory_allocated_GiB "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f}")
    return report, launches


def run_main_path(torch, model_dir):
    _phase("main path")
    from compare_gan_torch import core
    # Per step: the joint G forward (1 fwd); two D sub-steps on
    # concat(real, fake) (1 fwd + 1 bwd each); the G sub-step's G and D
    # forwards and their backward (2 fwd + 2 bwd).
    report, launches = _train_and_check(
        torch, model_dir, _argv(model_dir, "train"), (G_PARAMS, D_PARAMS),
        {"fwd": 5 * STEPS, "bwd": 4 * STEPS})
    run_main_path.seconds_per_step = report.seconds_per_step
    ts = report.state
    with torch.no_grad(), core.no_state_updates():
        z = torch.randn(4, 120, device="cuda").to(torch.bfloat16)
        y = torch.nn.functional.one_hot(torch.arange(4, device="cuda"),
                                        1000).float()
        images = ts.generator(z, y, is_training=True).float()
    if tuple(images.shape) != (4, 128, 128, 3) or not bool(
            torch.isfinite(images).all()) or images.min() < 0 \
            or images.max() > 1:
        raise AssertionError(f"bad samples: shape {tuple(images.shape)}, "
                             f"range [{images.min()}, {images.max()}]")
    print(f"samples {tuple(images.shape)} in [{images.min().item():.3f}, "
          f"{images.max().item():.3f}]")
    return launches


def run_s3gan(torch, model_dir):
    """S3GAN-128 at full width, batch 16, bf16: the joint G forward, two D
    sub-steps and the G sub-step each run the attention as BigGAN does (5
    forward and 4 backward launches a step), D on 38 rows."""
    _phase("S3GAN main path")
    argv = _cli_argv(model_dir, "s3gan32_polygons_partial.gin", [
        "dataset.name = 'imagenet_128'",
        f"options.batch_size = {S3GAN_BATCH}",
        f"S3GAN.rotated_batch_fraction = {S3GAN_ROTATED_FRACTION}",
        "S3GAN.compute_dtype = 'bfloat16'",
        "S3GAN.experimental_joint_gen_for_disc = True",
    ])
    _, launches = _train_and_check(
        torch, model_dir, argv, S3GAN_PARAMS,
        {"fwd": 5 * STEPS, "bwd": 4 * STEPS},
        losses=("loss/rotation_real_loss", "loss/rotation_fake_loss",
                "loss/rotation_accuracy_real", "loss/class_loss_real",
                "loss/label_frac"),
        head_scopes=HEAD_SCOPES)
    return launches


def run_ssgan(torch, model_dir):
    """SSGAN on ResNet-CIFAR-32 at its published widths and batch (64, 64
    rotated examples), f32: no attention on this path."""
    _phase("SSGAN main path")
    argv = _cli_argv(model_dir, "ssgan32_polygons_oriented.gin",
                     ["dataset.name = 'cifar10'"])
    _, launches = _train_and_check(
        torch, model_dir, argv, SSGAN_PARAMS, {"fwd": 0, "bwd": 0},
        losses=("loss/c_real_loss", "loss/c_fake_loss",
                "loss/rotation_accuracy"),
        head_scopes=HEAD_SCOPES[:1])
    return launches


def run_study_zoo(torch, model_dir):
    """The three study configurations through the CLI as published, f32;
    no attention on these paths. Returns (launches, per-config summary)."""
    _phase("study zoo")
    summary = {}
    launches = {"fwd": 0, "bwd": 0}
    for name, (config, params) in STUDY_ZOO.items():
        print(f"-- {name}: {config}")
        report, runs = _train_and_check(
            torch, os.path.join(model_dir, name),
            _cli_argv(os.path.join(model_dir, name), config, []), params,
            {"fwd": 0, "bwd": 0}, losses=("loss/penalty",))
        penalties = [m["loss/penalty"] for m in report.metrics]
        if name == "resnet5_wgangp" and not all(p > 0 for p in penalties):
            raise AssertionError(f"WGAN-GP penalty {penalties} is not > 0")
        summary[name] = {
            "params": list(params),
            "seconds_per_step": report.seconds_per_step,
            "peak_memory_GiB": torch.cuda.max_memory_allocated() / 2 ** 30,
            "penalty": penalties}
        for k in launches:
            launches[k] += runs[k]
    summary["penalty_gradients"] = check_penalty_gradients(torch)
    check_attention_penalty_raises(torch)
    return launches, summary


def check_penalty_gradients(torch):
    """One WGAN-GP D sub-step's loss and D gradients on the card against
    the CPU: the same weights (initialized on the CPU), images, fakes and
    alpha; resnet_lsun-bedroom128.gin at GRAD_CHECK_CH."""
    import functools

    import numpy as np
    from compare_gan_torch import config as gin
    from compare_gan_torch import datasets, gans, interop, runner_lib
    from compare_gan_torch.architectures import DISCRIMINATORS, GENERATORS
    from compare_gan_torch.architectures import resnet5
    del gans  # Imported for its gin registrations.
    gin.clear_config()
    gin.parse_config_files_and_bindings(
        [os.path.join(ROOT, "example_configs", "resnet_lsun-bedroom128.gin")],
        [])
    datasets.set_fake_dataset(True)
    # resnet5's width is a constructor argument, as in JAX.
    GENERATORS["resnet5_arch"] = functools.partial(resnet5.Generator,
                                                   ch=GRAD_CHECK_CH)
    DISCRIMINATORS["resnet5_arch"] = functools.partial(
        resnet5.Discriminator, ch=GRAD_CHECK_CH)
    options = runner_lib.get_options_dict()
    rng = np.random.RandomState(0)
    b = GRAD_CHECK_BATCH
    images, fakes = (rng.rand(b, 128, 128, 3).astype(np.float32)
                     for _ in range(2))
    alpha = rng.rand(b, 1, 1, 1).astype(np.float32)

    def sub_step(device, ts_from=None, alpha=alpha):
        gan = options["gan_class"](dataset=datasets.get_dataset(),
                                   parameters=options, model_dir="unused",
                                   device=device)
        ts = gan.init_state(seed=0)
        if ts_from is None:
            # D's kernels x5 put its slopes near 1 (about 1.17 here; 1e-5
            # at the init's stddev 0.02), where the penalty is informative.
            with torch.no_grad():
                for k, v in ts.d_params().items():
                    if k.endswith("/kernel"):
                        v.mul_(5.0)
        else:
            interop.load_state_dict(ts, interop.state_dict(ts_from))
        dev = torch.device(device)
        features = {
            "images": torch.from_numpy(images).to(dev),
            "generated": torch.from_numpy(fakes).to(dev),
            "penalty_draw": lambda n, s: torch.from_numpy(alpha).to(dev)}
        losses = gan.create_loss(features, None, is_training=True)
        d_params = ts.d_params()
        grads = torch.autograd.grad(losses["d_loss"], list(d_params.values()),
                                    materialize_grads=True)
        return ts, losses, {k: g.detach().cpu()
                            for k, g in zip(d_params, grads)}

    try:
        ts_cpu, cpu_losses, cpu = sub_step("cpu")
        t0 = time.perf_counter()
        _, card_losses, card = sub_step("cuda", ts_cpu)
        torch.cuda.synchronize()
        card_seconds = time.perf_counter() - t0
        _, _, other = sub_step("cpu", ts_cpu, alpha=1.0 - alpha)
    finally:
        GENERATORS["resnet5_arch"] = resnet5.Generator
        DISCRIMINATORS["resnet5_arch"] = resnet5.Discriminator

    def gap(a, b):
        return max(float((a[k] - b[k]).abs().max()
                         / b[k].abs().max().clamp_min(1e-30)) for k in b)

    out = {"d_loss_cpu": cpu_losses["d_loss"].item(),
           "d_loss_card": card_losses["d_loss"].item(),
           "penalty_cpu": cpu_losses["penalty_loss"].item(),
           "penalty_card": card_losses["penalty_loss"].item(),
           "max_rel_grad_gap": gap(card, cpu),
           "other_alpha_gap": gap(other, cpu), "tol": GRAD_TOL,
           "card_seconds": card_seconds}
    print("penalty gradients card vs cpu " + " ".join(
        f"{k} {v:.6g}" for k, v in out.items()))
    loss_gap = abs(out["d_loss_card"] - out["d_loss_cpu"]) / max(
        abs(out["d_loss_cpu"]), 1e-30)
    if out["max_rel_grad_gap"] > GRAD_TOL or loss_gap > GRAD_TOL:
        raise AssertionError(f"WGAN-GP D sub-step on the card disagrees "
                             f"with the CPU beyond {GRAD_TOL:g}: {out}")
    if out["other_alpha_gap"] <= 10 * GRAD_TOL:
        raise AssertionError("the gradient check cannot tell another alpha "
                             f"apart: {out}")
    return out


def check_attention_penalty_raises(torch):
    """A WGAN-GP penalty through a non-local block on the card: the
    attention kernel's gradient is first order only, so differentiating it
    again raises, naming the kernel."""
    from compare_gan_torch import core
    from compare_gan_torch.gans import penalty_lib
    from compare_gan_torch.ops import arch_ops as ops
    from compare_gan_torch.ops import fused_attention as fa
    block = ops.NonLocalBlock(64, use_sn=True, device="cuda")
    core.assign_scopes(block, "non_local_block")
    core.initialize(block, "non_local_block", 0)
    with torch.no_grad():
        block.sigma.fill_(0.5)
    x = torch.rand(4, 16, 16, 64, device="cuda")

    def d_logits_fn(xx):
        with core.no_state_updates():
            return block(xx).mean(dim=(1, 2, 3))[:, None]

    try:
        penalty_lib.wgangp_penalty(
            d_logits_fn, x, x.flip(0),
            lambda n, s: torch.rand(s, device="cuda")).backward()
    except RuntimeError as e:
        if fa.SECOND_ORDER_ERROR not in str(e):
            raise
        print(f"penalty through the attention kernel raises: {e}")
        return
    raise AssertionError("a gradient penalty through the attention kernel "
                         "did not raise")


def run_data_parallel(torch, model_dir):
    """(a) The CLI with --num_devices=1: the BigGAN-128 main path's argv
    through the data-parallel path, a one-rank NCCL group on the card
    (every all-reduce counted, with its backend); --num_devices=2 raises on
    a one-card machine. (b) Two spawned workers on cuda:0 over gloo, one
    BigGAN-128 step at global batch 16 against the one-process step.
    Returns (launches of (a), summary)."""
    _phase("data parallel")
    import torch.distributed as dist
    from compare_gan_torch import main
    print("-- (a) CLI --num_devices=1: one-rank NCCL group")
    reduces = {"calls": 0, "backends": set()}
    all_reduce = dist.all_reduce

    def counted(tensor, *args, **kwargs):
        reduces["calls"] += 1
        reduces["backends"].add(dist.get_backend(kwargs.get("group")))
        return all_reduce(tensor, *args, **kwargs)

    dist.all_reduce = counted
    try:
        argv = _argv(model_dir, "train", ()) + ["--num_devices=1"]
        report, launches = _train_and_check(
            torch, model_dir, argv, (G_PARAMS, D_PARAMS),
            {"fwd": 5 * STEPS, "bwd": 4 * STEPS})
    finally:
        dist.all_reduce = all_reduce
    print(f"all-reduces {reduces['calls']} on {sorted(reduces['backends'])}")
    if reduces["calls"] == 0 or reduces["backends"] != {"nccl"}:
        raise AssertionError(f"the data-parallel run made no NCCL "
                             f"all-reduce: {reduces}")
    dp_seconds = report.seconds_per_step[1:]
    main_seconds = run_main_path.seconds_per_step[1:]
    print("seconds_per_step_after_first one-rank NCCL group "
          + " ".join(f"{t:.4f}" for t in dp_seconds) + " | main path "
          + " ".join(f"{t:.4f}" for t in main_seconds))
    try:
        main.main(argv + ["--num_devices=2"])
    except ValueError as e:
        print(f"--num_devices=2 raises: {e}")
    else:
        raise AssertionError("--num_devices=2 ran on a one-card machine")

    print("-- (b) two gloo workers on cuda:0 against one process "
          "(gloo copies through the host on one card: its seconds are no "
          "figure for NCCL on several cards)")
    out = os.path.join(model_dir, "two_workers.json")
    from compare_gan_torch.parallel import mesh_utils
    t0 = time.perf_counter()
    torch.multiprocessing.start_processes(
        _dp_worker, args=(mesh_utils.free_port(), out), nprocs=2,
        join=True, start_method="spawn")
    with open(out) as f:
        two = json.load(f)
    two["seconds"] = time.perf_counter() - t0
    for kind, (rtol, atol) in DP_TOL.items():
        print(f"{kind} (rms gap of a tensor, tol {rtol:.3g} of its rms "
              f"+ {atol:.3g} of the largest): "
              + "; ".join(f"{run} {two[run][kind]['max']:.3g} abs, "
                          f"{two[run][kind]['ratio']:.3g} of tol"
                          for run in DP_RUNS))
    print(f"ranks bitwise equal: {two['bitwise']}; kernel launches per "
          f"rank {two['launches']}; step seconds (gloo over the host on one "
          f"card) {two['step_seconds']:.3f}, phase {two['seconds']:.1f}")
    failed = [k for k, g in two["two_workers"].items() if g["ratio"] > 1]
    if failed or not two["bitwise"] \
            or two["launches"] != [{"fwd": 5, "bwd": 4}] * 2:
        raise AssertionError(f"two workers disagree with one process: "
                             f"{failed} {two}")
    for control in ("unsummed", "local_bn"):
        caught = {k for k, g in two[control].items() if g["ratio"] > 1}
        if not {"params", "ema", "adam_mu", "adam_nu", "sn_u"} <= caught:
            raise AssertionError(f"DP_TOL passes the {control} control: "
                                 f"{caught} {two[control]}")
    return launches, {"one_rank_nccl": {
        "seconds_per_step": report.seconds_per_step,
        "main_path_seconds_per_step": run_main_path.seconds_per_step,
        "all_reduces": reduces["calls"]}, "two_gloo_workers": two}


# (b) runs the BigGAN-128 config with Adam's epsilon at 1e-3 (as
# tests/test_torch_dp_step.py and the JAX package's tests/test_parallel.py
# do): at the config's 1e-8 Adam's first update is lr * g / (|g| + eps),
# +-lr on the sign of a gradient that is rounding noise (a bias feeding a
# batch norm), so whole tensors of any two f32 runs differ by up to 2 lr,
# and SN u, one power iteration of the updated kernels, follows them.
DP_BINDINGS = ("options.batch_size = 16",
               "ModularGAN.experimental_joint_gen_for_disc = True",
               "ModularGAN.experimental_fake_only_g_loss = True",
               "tf.train.AdamOptimizer.epsilon = 1e-3")
# The runs whose state (b) holds to the one-process step's: the two
# workers; the one-process step again and with autotuned cuDNN (the card's
# own spread); and the controls, two workers that do not sum their
# gradients or that take BN moments of their own rows.
DP_RUNS = ("two_workers", "again", "autotuned", "unsummed", "local_bn")
# Tolerance by state kind, (rtol, atol): each tensor passes when
# rms(got - want) <= rtol * rms(ref) + atol * (the largest rms(ref) of its
# kind in its network, G or D); ref is a parameter's (and the EMA's)
# update in the step, any other tensor itself. The workers sum half-batch
# gradients and BN moments where one process sums the whole batch, and
# cuDNN runs other algorithms at batch 8 than at 16: f32 sums in another
# order, which can flip a ReLU whose input lies within rounding of 0: a
# few gradient entries move far past rounding (0.0164 in Adam's first
# moment here), and a parameter by up to 2 lr where its update's sign
# flips, so the check is per tensor, not per entry. The one-process
# step with autotuned cuDNN algorithms moves the state as far; run again
# with the same algorithms it is bitwise equal. rtol: parameters and EMA
# 5e-2 of the update, Adam's moments 2e-2, SN u (unit vectors) 1e-2.
# atol, for the biases that feed a batch norm, whose gradient is rounding
# noise and whose gap is as large as their update: 1e-4 of the largest
# update, and 1e-6 (first moment) or 1e-12 (second) of the largest
# moment. BN accumulators are not written in training, so equal. On an
# NVIDIA H100 80GB HBM3 at 700 W this phase measured the workers at 0.29
# of the tolerance (parameters), 0.099 (EMA), 0.17 (mu), 0.28 (nu) and
# 0.033 (u), and the controls, which must fail every kind but the
# accumulators, at 17.9 or more (parameters, EMA), 30.5 (mu), 46.2 (nu)
# and 3.57 (u).
DP_TOL = {"params": (5e-2, 1e-4), "ema": (5e-2, 1e-4),
          "adam_mu": (2e-2, 1e-6), "adam_nu": (2e-2, 1e-12),
          "sn_u": (1e-2, 0.0), "bn_accumulators": (0.0, 0.0)}


def _state_kind(key):
    if key.startswith(".ema_params"):
        return "ema"
    if key.startswith(".params"):
        return "params"
    if ".mu[" in key:
        return "adam_mu"
    if ".nu[" in key:
        return "adam_nu"
    if key.endswith("u_var']"):
        return "sn_u"
    return "bn_accumulators"


def _dp_worker(rank, port, out):
    """One of two gloo workers on cuda:0: one BigGAN-128 step of global
    batch 16 (8 here) with DP_BINDINGS, f32 with TF32 off and
    deterministic cuDNN; then its state against rank 0's bitwise, and the
    control step with unsummed gradients. Rank 0 then takes the
    one-process step of the same batch and draws, again, and with
    autotuned cuDNN, and writes each run's gaps (`_state_gaps`) to `out`
    as JSON."""
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch
    from compare_gan_torch import checkpoint
    from compare_gan_torch import config as gin
    from compare_gan_torch import datasets, gans, runner_lib
    from compare_gan_torch.ops import fused_attention as fa
    from compare_gan_torch.parallel import mesh_utils, tpu_ops
    del gans  # Imported for its gin registrations.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    device = torch.device("cuda", 0)
    replicas = mesh_utils.init_process_group(rank, 2, "127.0.0.1", port,
                                             device, backend="gloo")
    gin.parse_config_files_and_bindings(
        [os.path.join(ROOT, "example_configs", "biggan_imagenet128.gin")],
        list(DP_BINDINGS))
    datasets.set_fake_dataset(True)
    options = runner_lib.get_options_dict()
    batch_size = options["batch_size"]
    rng = np.random.RandomState(0)
    total = batch_size * (options["disc_iters"] + 1)
    batch = {"images": rng.rand(total, 128, 128, 3).astype(np.float32),
             "labels": rng.randint(0, 1000, total).astype(np.int32)}

    def step(reps, init=None):
        gan = options["gan_class"](dataset=datasets.get_dataset(),
                                   parameters=options, model_dir="unused",
                                   device=device)
        ts = gan.init_state(seed=0)
        if init is not None:  # The parameters and EMA before the step.
            init.update({k: v.detach().clone() for k, v in
                         checkpoint.live_tensors(ts).items()
                         if _state_kind(k) in ("params", "ema")})
        train_step = gan.make_train_step(batch_size, reps)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ts, _ = train_step(ts, batch)
        torch.cuda.synchronize()
        return checkpoint.live_tensors(ts), time.perf_counter() - t0

    moments = tpu_ops.cross_replica_moments
    controls = {  # Each a fault of a data-parallel step.
        "unsummed": (mesh_utils, "sum_over_replicas",
                     lambda tensors, reps: None),
        "local_bn": (tpu_ops, "cross_replica_moments",
                     lambda value, reps, axes=(0,), group_size=None:
                     moments(value, reps, axes, group_size=1))}
    try:
        fa.launches_fwd = fa.launches_bwd = 0
        states = {}
        states["two_workers"], seconds = step(replicas)
        launches = [{"fwd": fa.launches_fwd, "bwd": fa.launches_bwd}]
        try:
            mesh_utils.assert_replicated(states["two_workers"], replicas)
            bitwise = True
        except AssertionError:
            bitwise = False
        gathered = [None, None]
        torch.distributed.all_gather_object(gathered, launches[0])
        for name, (module, attr, fault) in controls.items():
            right = getattr(module, attr)
            setattr(module, attr, fault)
            try:
                states[name], _ = step(replicas)
            finally:
                setattr(module, attr, right)
    finally:
        mesh_utils.destroy_process_group()
    if rank != 0:
        return
    init = {}
    want, _ = step(None, init)
    states["again"], _ = step(None)
    torch.backends.cudnn.deterministic = False
    torch.backends.cudnn.benchmark = True
    states["autotuned"], _ = step(None)
    result = {run: _state_gaps(states[run], want, init) for run in DP_RUNS}
    with open(out, "w") as f:
        json.dump(dict(result, bitwise=bitwise, launches=gathered,
                       step_seconds=seconds), f)


# The spatial phase's faulty controls, each a fault of the spatial layout
# that DP_TOL must catch (tests/test_torch_spatial_step.py holds them to
# the CPU's tolerances too).
SPATIAL_CONTROLS = ("no_halo", "k_times")


@contextlib.contextmanager
def spatial_control(name):
    """Within the block the spatial layout runs with one fault (None: none).
    "no_halo": every conv pads its band with zero rows instead of its
    neighbours'. "k_times": each model rank's loss is its data rank's whole
    share, and the model group's sum passes its gradient back unsummed (a
    tensor-parallel layer's recipe): band gradients stay right, but those
    of what every model rank computes whole (D's last linear layer and
    projection embedding) are summed k times over the grid."""
    if name is None:
        yield
        return
    import torch
    from compare_gan_torch.parallel import tpu_ops
    summed = tpu_ops.model_sum

    class Unsummed(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return summed(x)

        @staticmethod
        def backward(ctx, grad):
            return grad

    def zero_halos(x, lo, hi, what=""):
        rest = tuple(x.shape[2:])
        return torch.cat([x.new_zeros((x.shape[0], lo) + rest), x,
                          x.new_zeros((x.shape[0], hi) + rest)], 1)

    faults = {"no_halo": {"exchange_halos": zero_halos},
              "k_times": {"model_sum": Unsummed.apply,
                          "loss_shares": lambda replicas:
                          replicas.data_size}}[name]
    right = {attr: getattr(tpu_ops, attr) for attr in faults}
    for attr, fault in faults.items():
        setattr(tpu_ops, attr, fault)
    try:
        yield
    finally:
        for attr, fn in right.items():
            setattr(tpu_ops, attr, fn)


# The spatial phase's precisions: bf16 is the benchmark options' main path;
# f32 (TF32 off) is where DP_TOL tells the layout from its faults. In bf16
# each band's sums round otherwise than the whole image's, and the step's
# gradients carry that through some forty layers of bf16 activations: in
# a dry run on the CPU at ch 16 (`_spatial_worker(..., device="cpu",
# bindings=...)`, batch 4) the bf16 grid's state lay 19.4 (parameters) to
# 1.70e3 (Adam's second moment) times DP_TOL from the one-process step's,
# as far as the f32 k_times control's (10.4 to 150), where the f32 grid's
# lay within 0.101. On an NVIDIA H100 80GB HBM3 at 700 W the one-process
# bf16 step with autotuned cuDNN itself lay 10.9-14.1 (parameters) and
# 34.6-62.7 (Adam's second moment) times DP_TOL from the deterministic
# one, the grid 18.5 and 146. So the bf16 step's gaps are printed beside
# that spread, and DP_TOL holds the f32 step.
SPATIAL_PRECISIONS = ("bfloat16", "float32")


def run_spatial(torch, model_dir):
    """Two spawned gloo workers on cuda:0 as a `data 1 x model 2` grid take
    one BigGAN-128 step at full width in the spatial layout (image height
    in two bands of 64 rows) with the benchmark options (batch 16, joint G
    forward, fake-only G loss) and Adam's epsilon at 1e-3, in bf16 and in
    f32 (SPATIAL_PRECISIONS). The f32 step is held to the one-process step
    by state kind (DP_TOL) and the faulty controls (SPATIAL_CONTROLS, f32)
    must fail it; the bf16 step's gaps are printed beside the one-process
    step's own spread. Every attention launch of either step runs on the
    band's 2048 queries against 1024 keys and is held to the plain version
    on its operands. Returns (both workers' launches in the bf16 step,
    summary)."""
    _phase("spatial")
    print("-- two gloo workers on cuda:0, a data 1 x model 2 grid, against "
          "one process (gloo copies through the host on one card: its "
          "seconds are no rate)")
    os.makedirs(model_dir, exist_ok=True)
    out = os.path.join(model_dir, "spatial.json")
    from compare_gan_torch.parallel import mesh_utils
    t0 = time.perf_counter()
    torch.multiprocessing.start_processes(
        _spatial_worker, args=(mesh_utils.free_port(), out), nprocs=2,
        join=True, start_method="spawn")
    with open(out) as f:
        result = json.load(f)
    result["seconds"] = time.perf_counter() - t0
    for precision in SPATIAL_PRECISIONS:
        gaps = result["gaps"][precision]
        for kind, (rtol, atol) in DP_TOL.items():
            print(f"{precision} {kind} (tol {rtol:.3g} of a tensor's rms + "
                  f"{atol:.3g} of the largest): " + "; ".join(
                      f"{run} {g[kind]['max']:.3g} abs, "
                      f"{g[kind]['ratio']:.3g} of tol"
                      for run, g in gaps.items()))
    print(f"ranks bitwise equal: {result['bitwise']}; all finite: "
          f"{result['finite']}; launches per rank {result['launches']}; "
          f"shapes (B, N, M) {result['shapes']}; largest kernel error over "
          f"the plain version, as a share of its tolerance: "
          f"{result['kernel_err_ratio']:.3g}; step seconds (gloo through "
          f"the host on one card) {result['step_seconds']}, phase "
          f"{result['seconds']:.1f}")
    failed = [k for k, g in result["gaps"]["float32"]["spatial"].items()
              if g["ratio"] > 1]
    shapes = {tuple(x) for rank in result["shapes"] for x in rank}
    if failed or not all(result["bitwise"].values()) \
            or not all(result["finite"].values()) \
            or any(per_rank != [{"fwd": 5, "bwd": 4}] * 2
                   for per_rank in result["launches"].values()) \
            or {(n, m) for _, n, m in shapes} != {(2048, 1024)} \
            or result["kernel_err_ratio"] > 1:
        raise AssertionError(f"the spatial step disagrees with one process "
                             f"or its kernels with plain: {failed} {result}")
    must_fail = {"no_halo": {"params", "ema", "adam_mu", "adam_nu", "sn_u"},
                 "k_times": {"params", "adam_mu", "adam_nu"}}
    for control in SPATIAL_CONTROLS:
        caught = {k for k, g in result["gaps"]["float32"][control].items()
                  if g["ratio"] > 1}
        if not must_fail[control] <= caught:
            raise AssertionError(f"DP_TOL passes the {control} control: "
                                 f"{caught}")
    launches = {k: sum(rank[k] for rank in result["launches"]["bfloat16"])
                for k in ("fwd", "bwd")}
    return launches, result


def _spatial_worker(rank, port, out, device="cuda", bindings=()):
    """One of two gloo workers on cuda:0 in a `data 1 x model 2` grid: one
    BigGAN-128 step of batch 16 (BIGGAN_BINDINGS, Adam's epsilon at 1e-3,
    and `bindings`) in each of SPATIAL_PRECISIONS, TF32 off and
    deterministic cuDNN, with every attention launch checked
    (`_checked_attention`); its state against rank 0's bitwise; then the
    f32 step with each control. Rank 0 then takes the one-process step of
    the same batch and draws in each precision, the f32 one again, then
    both with autotuned cuDNN, and writes each run's gaps (`_state_gaps`)
    to `out` as JSON. (device="cpu" and narrower `bindings` make a dry run
    off the card, with no launch.)"""
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch
    from compare_gan_torch import checkpoint
    from compare_gan_torch import config as gin
    from compare_gan_torch import datasets, gans, runner_lib
    from compare_gan_torch.ops import fused_attention as fa
    from compare_gan_torch.parallel import mesh_utils
    del gans  # Imported for its gin registrations.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    device = torch.device(device, 0) if device == "cuda" else torch.device(
        device)
    replicas = mesh_utils.init_process_group(
        rank, 2, "127.0.0.1", port, device, backend="gloo", model_size=2)
    gin.parse_config_files_and_bindings(
        [os.path.join(ROOT, "example_configs", "biggan_imagenet128.gin")],
        list(BIGGAN_BINDINGS) + ["tf.train.AdamOptimizer.epsilon = 1e-3"]
        + list(bindings))
    datasets.set_fake_dataset(True)
    options = runner_lib.get_options_dict()
    batch_size = options["batch_size"]
    rng = np.random.RandomState(0)
    total = batch_size * (options["disc_iters"] + 1)
    batch = {"images": rng.rand(total, 128, 128, 3).astype(np.float32),
             "labels": rng.randint(0, 1000, total).astype(np.int32)}

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()

    def step(reps, precision, init=None, control=None):
        gan = options["gan_class"](dataset=datasets.get_dataset(),
                                   parameters=options, model_dir="unused",
                                   device=device, compute_dtype=(
                                       None if precision == "float32"
                                       else precision))
        ts = gan.init_state(seed=0)
        if init is not None:  # The parameters and EMA before the step.
            init.update({k: v.detach().clone() for k, v in
                         checkpoint.live_tensors(ts).items()
                         if _state_kind(k) in ("params", "ema")})
        train_step = gan.make_train_step(batch_size, reps)
        sync()
        t0 = time.perf_counter()
        with spatial_control(control):
            ts, _ = train_step(ts, batch)
        sync()
        return checkpoint.live_tensors(ts), time.perf_counter() - t0

    states = {p: {} for p in SPATIAL_PRECISIONS}
    mine = {"launches": {}, "bitwise": {}, "finite": {}, "seconds": {}}
    checked = {"shapes": [], "ratio": 0.0}
    try:
        for precision in SPATIAL_PRECISIONS:
            with _checked_attention(torch, fa, checked):
                fa.launches_fwd = fa.launches_bwd = 0
                state, mine["seconds"][precision] = step(replicas, precision)
                mine["launches"][precision] = {"fwd": fa.launches_fwd,
                                               "bwd": fa.launches_bwd}
            states[precision]["spatial"] = state
            mine["finite"][precision] = all(
                bool(torch.isfinite(t).all()) for t in state.values()
                if t.is_floating_point())
            try:
                mesh_utils.assert_replicated(state, replicas)
                mine["bitwise"][precision] = True
            except AssertionError:
                mine["bitwise"][precision] = False
        mine.update(checked)
        gathered = [None, None]
        torch.distributed.all_gather_object(gathered, mine)
        for control in SPATIAL_CONTROLS:
            states["float32"][control], _ = step(replicas, "float32",
                                                 control=control)
    finally:
        mesh_utils.destroy_process_group()
    if rank != 0:
        return
    init = {p: {} for p in SPATIAL_PRECISIONS}
    want = {p: step(None, p, init[p])[0] for p in SPATIAL_PRECISIONS}
    states["float32"]["again"], _ = step(None, "float32")
    torch.backends.cudnn.deterministic = False
    torch.backends.cudnn.benchmark = True
    for precision in SPATIAL_PRECISIONS:
        states[precision]["autotuned"], _ = step(None, precision)
    gaps = {p: {run: _state_gaps(state, want[p], init[p])
                for run, state in states[p].items()}
            for p in SPATIAL_PRECISIONS}
    first = gathered[0]
    with open(out, "w") as f:
        json.dump({
            "gaps": gaps, "bitwise": first["bitwise"],
            "finite": first["finite"], "step_seconds": first["seconds"],
            "launches": {p: [g["launches"][p] for g in gathered]
                         for p in SPATIAL_PRECISIONS},
            "shapes": [g["shapes"] for g in gathered],
            "kernel_err_ratio": max(g["ratio"] for g in gathered)}, f)


@contextlib.contextmanager
def _checked_attention(torch, fa, checked):
    """Within the block each launch of the attention kernels is followed by
    the plain version on the same operands (no launch): its outputs must
    agree within TOL (abs + rel) of their type, mx and den within 1e-4.
    `checked` gathers each launch's (B, N, M) and the largest error as a
    share of its tolerance."""
    launch_fwd, launch_bwd = fa.attention_fwd, fa.attention_bwd

    def ratio(got, want, tol):
        got, want = got.float(), want.float()
        return float(((got - want).abs() / (tol + tol * want.abs())).max())

    def fwd(theta, phi, g):
        out = launch_fwd(theta, phi, g)
        plain = fa.attention_fwd_plain(theta, phi, g)
        tol = TOL[str(theta.dtype).split(".")[-1]]
        checked["shapes"].append(list(theta.shape[:2]) + [phi.shape[1]])
        checked["ratio"] = max([checked["ratio"]] + [
            ratio(a, b, t) for a, b, t in zip(out, plain, (tol, 1e-4, 1e-4))])
        return out

    def bwd(theta, phi, g, dout, mx, den):
        out = launch_bwd(theta, phi, g, dout, mx, den)
        plain = fa.attention_bwd_plain(theta, phi, g, dout, mx, den)
        tol = TOL[str(theta.dtype).split(".")[-1]]
        checked["ratio"] = max([checked["ratio"]] + [
            ratio(a, b, tol) for a, b in zip(out, plain)])
        return out

    fa.attention_fwd, fa.attention_bwd = fwd, bwd
    try:
        yield
    finally:
        fa.attention_fwd, fa.attention_bwd = launch_fwd, launch_bwd


def _state_gaps(got, want, init):
    """{state kind: {"max": largest |got - want| of an entry, "ratio":
    largest rms(got - want) / (rtol * rms(ref) + atol * largest rms(ref))
    of a tensor of the kind, with the kind's DP_TOL}}. `init` holds the
    parameters and EMA before the step: their ref is the step's update."""
    def rms(t):
        return float(t.square().mean().sqrt())

    refs = {key: (w.detach().double() - init[key].detach().double()
                  if key in init else w.detach().double())
            for key, w in want.items()}
    largest = {}
    for key, ref in refs.items():
        scope = (_state_kind(key), "generator/" in key)
        largest[scope] = max(largest.get(scope, 0.0), rms(ref))
    gaps = {kind: {"max": 0.0, "ratio": 0.0} for kind in DP_TOL}
    for key, ref in refs.items():
        kind = _state_kind(key)
        rtol, atol = DP_TOL[kind]
        diff = got[key].detach().double() - want[key].detach().double()
        gap, bound = rms(diff), (rtol * rms(ref) + atol
                                 * largest[kind, "generator/" in key])
        entry = gaps[kind]
        entry["max"] = max(entry["max"], float(diff.abs().max()))
        if gap:
            entry["ratio"] = max(entry["ratio"],
                                 gap / bound if bound else float("inf"))
    return gaps


def check_inception(torch, npz_path):
    """The port's Inception on the card against the same weights on the
    CPU, on 4 fake-ImageNet-sized images, both in full f32."""
    import numpy as np
    from compare_gan_torch.metrics import inception_net
    images = np.random.RandomState(0).rand(4, 128, 128, 3) * 255.0
    t0 = time.perf_counter()
    card = inception_net.make_feature_fn(npz_path, "cuda")(images)
    cpu = inception_net.make_feature_fn(npz_path, "cpu")(images)
    for what, got, want in zip(("pool_3", "logits"), card, cpu):
        scale = float(np.abs(want).max())
        err = float(np.abs(got - want).max())
        ok = err <= INCEPTION_TOL * scale
        print(f"  inception {what} card vs cpu: max_abs {err:.3e} "
              f"(max |cpu| {scale:.3e}), relative {err / scale:.3e} tol "
              f"{INCEPTION_TOL:g} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"Inception {what} on the card disagrees "
                                 f"with the CPU beyond {INCEPTION_TOL:g}")
    print(f"  inception check seconds {time.perf_counter() - t0:.2f}")


def setup_inception(torch, model_dir):
    """A random-init Inception `.npz` (no real weights are in the
    repository) that $COMPARE_GAN_INCEPTION_NPZ points every eval at,
    checked on the card against the CPU."""
    import numpy as np
    from compare_gan_torch import eval_utils
    from compare_gan_torch.metrics import inception_net
    npz_path = os.path.join(model_dir, "inception_random.npz")
    np.savez(npz_path, **inception_net.init_random(
        torch.Generator().manual_seed(0)))
    os.environ[eval_utils.INCEPTION_NPZ_ENV] = npz_path
    check_inception(torch, npz_path)


def _metric_keys(task_names):
    from compare_gan_torch import runner_lib
    from compare_gan_torch import config as gin
    runner_lib._import_eval_task_modules()
    return sorted(m for name in task_names
                  for m in gin.get_configurable(name)().metric_list())


def run_eval(torch, model_dir, argv, tasks, image_shape, attention,
             accumulators, phase="eval"):
    """eval_after_train on a trained model_dir through the CLI with the
    eval tasks `tasks` (class names). Checks that every metric of the
    tasks is finite in the scores.csv row, the export, the filled state
    (with `accumulators`), the attention launches (`attention` non-local
    blocks in G) and eval-mode samples of `image_shape`; prints each
    phase's and each task's seconds and the peak memory."""
    _phase(phase)
    import csv
    import numpy as np
    from compare_gan_torch import config as gin
    from compare_gan_torch import datasets, eval_gan_lib, main
    from compare_gan_torch import runner_lib
    from compare_gan_torch.ops import fused_attention as fa

    keys = _metric_keys(tasks)
    gin.clear_config()
    argv = argv + [
        "--eval_every_steps=0",
        f"--gin_bindings=evaluation.num_accu_examples = {ACCU_EXAMPLES}",
        "--gin_bindings=evaluation.eval_tasks = ["
        + ", ".join(f"@{t}()" for t in tasks) + "]"]
    torch.cuda.synchronize()
    print(f"memory_allocated_GiB_before_eval "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.2f}")
    fa.launches_fwd = fa.launches_bwd = 0
    t0 = time.perf_counter()
    report = main.main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {"fwd": fa.launches_fwd, "bwd": fa.launches_bwd}

    with open(os.path.join(model_dir, "scores.csv"), newline="") as f:
        rows = list(csv.DictReader(f))
    if [r["step"] for r in rows] != [str(STEPS)]:
        raise AssertionError(f"scores.csv rows for steps "
                             f"{[r['step'] for r in rows]}, not [{STEPS}]")
    for key in keys:
        value = float(rows[0][key + "_mean"])
        print(f"{key}_mean {rows[0][key + '_mean']} ({key}_list "
              f"{rows[0][key + '_list']})")
        if not np.isfinite(value) or value in (eval_gan_lib.NAN_DETECTED,
                                               4242.0):
            raise AssertionError(f"{key}_mean = {value}")
    export_dir = os.path.join(model_dir, "tfhub", str(STEPS))
    for name in ("module_spec.json", "module.npz"):
        if not os.path.exists(os.path.join(export_dir, name)):
            raise AssertionError(f"tfhub/{STEPS}/{name} was not written")
    fills = ACCU_EXAMPLES // EVAL_BATCH if accumulators else 0
    if accumulators:
        with np.load(os.path.join(export_dir,
                                  f"model.ckpt-{STEPS}.npz")) as data:
            switches = [float(data[k]) for k in data.files
                        if k.endswith("accu/update_accus']")]
            counters = [float(data[k]) for k in data.files
                        if k.endswith("accu/accu_counter']")]
        print(f"filled state: {len(switches)} accumulators, update_accus "
              f"{sorted(set(switches))}, accu_counter "
              f"{sorted(set(counters))}")
        if not switches or set(switches) != {0.0} or any(
                abs(c - fills) > 1e-3 for c in counters):
            raise AssertionError("the BN accumulators were not filled "
                                 f"{fills} times with the switch set back "
                                 f"to 0")

    # Per checkpoint: the fill's forwards and one forward per sampled batch
    # of each averaging run, times the non-local blocks of G; eval runs no
    # backward (the Jacobian of G runs on DCGAN, which has no attention).
    batches = -(-EVAL_SAMPLES // EVAL_BATCH)
    expected = {"fwd": attention * (fills + AVERAGING_RUNS * batches),
                "bwd": 0}
    print(f"eval kernel launches {launches} (expected {expected}: "
          f"{fills} fill + {AVERAGING_RUNS} runs * {batches} batches)")
    if launches != expected:
        raise AssertionError(f"eval kernel launches {launches} != "
                             f"{expected}")

    record = report.evals[0]
    phases = record["seconds"]
    print("eval_seconds " + " ".join(f"{k} {v:.3f}"
                                     for k, v in phases.items())
          + f" total {seconds:.3f}")
    print("eval_task_seconds " + " ".join(
        f"{k} {v:.3f}" for k, v in record["task_seconds"].items()))
    # Each phase starts from a reset of the allocator's peak.
    peaks = {k: v / 2 ** 30 for k, v in record["peak_bytes"].items()}
    if set(peaks) != set(phases):
        raise AssertionError(f"peak memory of phases {sorted(peaks)}, "
                             f"timed {sorted(phases)}")
    top = max(peaks, key=peaks.get)
    print("eval_peak_memory_allocated_GiB " + " ".join(
        f"{k} {v:.2f}" for k, v in peaks.items()) + f" (peak in {top})")
    sampled = AVERAGING_RUNS * batches * EVAL_BATCH
    inception_seconds = phases["inception_fake"] + phases.get(
        "inception_real", 0.0)
    print(f"sampling_images_per_second {sampled / phases['sampling']:.1f} "
          f"inception_images_per_second "
          f"{(sampled + EVAL_SAMPLES) / inception_seconds:.1f} "
          f"peak_memory_allocated_GiB {peaks[top]:.2f}")

    # Eval-mode samples of the evaluated checkpoint: EMA weights and, with
    # accumulators, the filled BN statistics.
    options = runner_lib.get_options_dict()
    gan = options["gan_class"](dataset=datasets.get_dataset(),
                               parameters=options, model_dir=model_dir,
                               device="cuda")
    path = (os.path.join(export_dir, f"model.ckpt-{STEPS}.npz")
            if accumulators else
            os.path.join(model_dir, f"model.ckpt-{STEPS}.npz"))
    ts = eval_gan_lib.restored_state(gan, path, eval_gan_lib.EvalCache())
    z, labels = eval_gan_lib.eval_draws(gan, EVAL_BATCH, "run0", 0)
    images = gan.sample(ts, z, labels).float()
    if tuple(images.shape) != (EVAL_BATCH,) + tuple(image_shape) or not \
            bool(torch.isfinite(images).all()) or images.min() < 0 \
            or images.max() > 1:
        raise AssertionError(f"bad eval samples: shape "
                             f"{tuple(images.shape)}, range "
                             f"[{images.min()}, {images.max()}]")
    print(f"eval samples {tuple(images.shape)} in "
          f"[{images.min().item():.3f}, {images.max().item():.3f}]")
    return launches, {"seconds": phases, "task_seconds":
                      record["task_seconds"], "total_seconds": seconds,
                      "peak_memory_GiB": peaks,
                      "scores": {k: float(rows[0][k + "_mean"])
                                 for k in keys}}


def run_biggan_deep(torch, model_dir):
    """BigGAN-deep-128 at full width, batch 16, bf16, through the CLI: the
    joint G forward, two D sub-steps and the G sub-step run the attention
    as BigGAN does (5 forward and 4 backward launches a step). G
    concatenates z to the f32 label embedding, so it runs in f32 (as in
    the JAX package); D runs in bf16."""
    _phase("BigGAN-deep main path")
    _, launches = _train_and_check(
        torch, model_dir, _deep_argv(model_dir, "train"), DEEP_PARAMS,
        {"fwd": 5 * STEPS, "bwd": 4 * STEPS})
    return launches


def run_gan_tasks(torch, model_dir):
    """All ten eval tasks on the study zoo's DCGAN-64 checkpoint
    (dcgan_celeba64.gin as published: unconditional, uniform z, z_dim 128),
    GILBO at its defaults (2,000 regressor steps at batch 64) with its
    artifacts written to <model_dir>/gilbo."""
    outdir = os.path.join(model_dir, "gilbo")
    argv = _cli_argv(model_dir, "dcgan_celeba64.gin",
                     [f"GILBOTask.outdir = '{outdir}'"], "eval_after_train")
    launches, summary = run_eval(torch, model_dir, argv,
                                 SESSION_TASKS + GAN_TASKS, (64, 64, 3),
                                 attention=0, accumulators=False,
                                 phase="G/D-access tasks")
    files = sorted(os.listdir(outdir))
    print(f"gilbo artifacts {files}")
    for want in ("eval_dists.p", "train_consistency_dists.p",
                 "eval_consistency_dists.p", "self_consistency_dists.p"):
        if want not in files:
            raise AssertionError(f"GILBO did not write {want}")
    for prefix in ("gilbo_model-", "consistency_image_self_"):
        if not any(f.startswith(prefix) for f in files):
            raise AssertionError(f"GILBO wrote no {prefix}* file")
    return launches, summary


# The serving phase: the main path's BigGAN-128 G as a serving program at
# the reference's TF-Hub batch signatures, served by a fresh process that
# loads no model code. The program runs f32 (z's type: `compute_dtype` does
# not apply to inference), so its attention repeats the eval shape's forward
# at B 64 (and runs at B 8, 16, 32). Each signature is called once (checked)
# and SERVING_CALLS more times (timed), the eager loader likewise.
SERVING_CALLS = 10
SERVING_MODEL_MODULES = ("compare_gan_torch.architectures",
                         "compare_gan_torch.gans", "compare_gan_torch.config")
# The program stores G's weights once: its file within 1.25x of G's
# inference params and state.
SERVING_BYTES_RATIO = 1.25


def _checked_images(np, images, batch, what):
    if images.shape != (batch, 128, 128, 3) or not np.isfinite(images).all() \
            or images.min() < 0 or images.max() > 1:
        raise AssertionError(f"{what}: bad images, shape {images.shape}, "
                             f"range [{images.min()}, {images.max()}]")


def serving_worker(export_dir):
    """The serving phase's fresh process: load the program of `export_dir`
    through `serving.load_serving_program` on the card (TF32 off, as in the
    parent) and on the CPU; run every signature on the inputs the parent
    wrote, once checked (one forward launch) and SERVING_CALLS times timed;
    gen_bs8 on the CPU (no launch). Writes outputs.npz and prints a JSON
    report as its last line; raises if a model module was imported."""
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from compare_gan_torch import serving
    from compare_gan_torch.ops import fused_attention as fa

    with np.load(os.path.join(export_dir, "inputs.npz")) as f:
        z, labels = f["z"], f["labels"]
    t0 = time.perf_counter()
    torch.cuda.init()  # The process's CUDA context, timed apart.
    torch.zeros(1, device="cuda")
    cuda_init_seconds = time.perf_counter() - t0
    t0 = time.perf_counter()
    spec, signatures = serving.load_serving_program(export_dir, "cuda")
    torch.cuda.synchronize()
    load_seconds = time.perf_counter() - t0
    outputs, rates, launches = {}, {}, 0
    for name, batch in spec["signatures"].items():
        fa.launches_fwd = 0
        images = signatures[name](z[:batch], labels[:batch])
        outputs[name] = images.cpu().numpy()
        _checked_images(np, outputs[name], batch, name)
        if fa.launches_fwd != 1:
            raise AssertionError(f"{name}: {fa.launches_fwd} forward "
                                 f"launches, not 1")
        z_card = torch.as_tensor(z[:batch], device="cuda")
        labels_card = torch.as_tensor(labels[:batch], device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(SERVING_CALLS):
            signatures[name](z_card, labels_card)
        torch.cuda.synchronize()
        rates[name] = batch * SERVING_CALLS / (time.perf_counter() - t0)
        if fa.launches_fwd != 1 + SERVING_CALLS:
            raise AssertionError(f"{name}: {fa.launches_fwd} forward "
                                 f"launches in {1 + SERVING_CALLS} calls")
        launches += fa.launches_fwd
    _, cpu_signatures = serving.load_serving_program(export_dir, "cpu")
    fa.launches_fwd = 0
    outputs["cpu_gen_bs8"] = cpu_signatures["gen_bs8"](z[:8],
                                                       labels[:8]).numpy()
    if fa.launches_fwd:
        raise AssertionError("the program on the CPU launched a kernel")
    np.savez(os.path.join(export_dir, "outputs.npz"), **outputs)
    model_modules = sorted(m for m in sys.modules
                           if m.startswith(SERVING_MODEL_MODULES))
    if model_modules:
        raise AssertionError(f"the serving process imported model code: "
                             f"{model_modules}")
    print(json.dumps({"load_seconds": load_seconds,
                      "cuda_init_seconds": cuda_init_seconds,
                      "images_per_second": rates, "launches": launches,
                      "model_modules": model_modules}))


def _held(np, got, want, what):
    """Max abs error of `got` against `want`, within TOL["float32"] of
    want's largest entry."""
    err = float(np.abs(got - want).max())
    scale = float(np.abs(want).max())
    ok = err <= TOL["float32"] * scale
    print(f"  {what}: max_abs {err:.3e} (max |want| {scale:.3f}) tol "
          f"{TOL['float32']:g} of it {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{what}: beyond {TOL['float32']:g}")
    return err


def run_serving(torch, model_dir):
    """Export the main path's BigGAN-128 G (the eval's accumulator-filled
    step-3 state, EMA shadows) as a serving program with the four
    signatures and a module export of the same state; serve the program
    from a fresh process (`serving_worker`); hold its images to eager
    `export.load_generator` on the module export and to its own CPU run;
    run `compare_gan_torch.demo` on the module export. The module export
    of tfhub/<step> is written before the eval fills the accumulators, so
    it is not this state: with unfilled accumulators BN divides by
    sqrt(epsilon). Returns (launches, summary)."""
    _phase("serving")
    import numpy as np
    from compare_gan_torch import config as gin
    from compare_gan_torch import datasets, demo, eval_gan_lib, export
    from compare_gan_torch import gans, runner_lib, serving
    from compare_gan_torch.ops import fused_attention as fa
    from compare_gan_torch.tf_io import image_codec
    del gans  # Registers the configurables of the config.

    gin.clear_config()
    gin.parse_config_files_and_bindings(
        [os.path.join(ROOT, "example_configs", "biggan_imagenet128.gin")],
        list(BIGGAN_BINDINGS))
    datasets.set_fake_dataset(True)
    options = runner_lib.get_options_dict()
    gan = options["gan_class"](dataset=datasets.get_dataset(),
                               parameters=options, model_dir=model_dir,
                               device="cuda")
    ts = eval_gan_lib.restored_state(
        gan, os.path.join(model_dir, "tfhub", str(STEPS),
                          f"model.ckpt-{STEPS}.npz"),
        eval_gan_lib.EvalCache())
    program_dir = os.path.join(model_dir, "serving", "program")
    module_dir = os.path.join(model_dir, "serving", "module")
    t0 = time.perf_counter()
    export.export_serving_program(gan, ts, program_dir)
    export_seconds = time.perf_counter() - t0
    artifact = os.path.getsize(os.path.join(program_dir,
                                            serving.SERVING_PROGRAM))
    weights = sum(v.numel() * v.element_size() for k, v in {
        **gan._inference_params(ts), **ts.state()}.items()
        if k.startswith("generator/"))
    print(f"export_seconds {export_seconds:.2f} artifact_bytes {artifact} "
          f"weight_bytes {weights} ratio {artifact / weights:.4f}")
    if artifact > SERVING_BYTES_RATIO * weights:
        raise AssertionError(f"the program holds {artifact} bytes for "
                             f"{weights} bytes of weights")
    export.export_module(gan, ts, module_dir)
    with open(os.path.join(program_dir, serving.SERVING_SPEC)) as f:
        spec = json.load(f)
    print(f"serving spec {spec}")
    if list(spec["signatures"]) != ["gen_bs8", "gen_bs16", "gen_bs32",
                                    "gen_bs64"] or spec["dtype"] != "float32":
        raise AssertionError(f"serving spec {spec}")

    # z as the config draws it (normal), labels with an unlabeled -1.
    rng = np.random.RandomState(0)
    z = rng.randn(64, gan.z_dim).astype(np.float32)
    labels = rng.randint(0, 1000, 64).astype(np.int32)
    labels[0] = -1
    np.savez(os.path.join(program_dir, "inputs.npz"), z=z, labels=labels)
    proc = subprocess.run(
        [sys.executable, "-c",
         f"import chip_smoke; chip_smoke.serving_worker({program_dir!r})"],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise AssertionError(f"the serving process failed (rc "
                             f"{proc.returncode}):\n{proc.stderr[-4000:]}")
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    print(f"serving process: load_seconds {report['load_seconds']:.2f} "
          f"(after {report['cuda_init_seconds']:.2f} s of CUDA init), "
          f"model modules {report['model_modules']}, forward launches "
          f"{report['launches']}")
    with np.load(os.path.join(program_dir, "outputs.npz")) as f:
        outputs = dict(f)

    generate, _ = export.load_generator(module_dir, "cuda")
    eager_rates, errors, eager_launches = {}, {}, 0
    for name, batch in spec["signatures"].items():
        fa.launches_fwd = 0
        want = generate(z[:batch], labels[:batch]).float().cpu().numpy()
        _checked_images(np, want, batch, f"eager {name}")
        errors[name] = _held(np, outputs[name], want,
                             f"{name} program vs eager load_generator")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(SERVING_CALLS):
            generate(z[:batch], labels[:batch])
        torch.cuda.synchronize()
        eager_rates[name] = batch * SERVING_CALLS / (time.perf_counter()
                                                     - t0)
        if fa.launches_fwd != 1 + SERVING_CALLS:
            raise AssertionError(f"eager {name}: {fa.launches_fwd} forward "
                                 f"launches in {1 + SERVING_CALLS} calls")
        eager_launches += fa.launches_fwd
    errors["card_vs_cpu_gen_bs8"] = _held(
        np, outputs["gen_bs8"], outputs["cpu_gen_bs8"],
        "gen_bs8 on the card vs the CPU")
    rates = {name: {"program": report["images_per_second"][name],
                    "eager": eager_rates[name]}
             for name in spec["signatures"]}
    print("serving_images_per_second " + " ".join(
        f"{k} program {v['program']:.1f} eager {v['eager']:.1f}"
        for k, v in rates.items()))

    out_dir = os.path.join(model_dir, "serving", "demo")
    fa.launches_fwd = 0
    t0 = time.perf_counter()
    result = demo.main([f"--export_dir={module_dir}",
                        f"--out_dir={out_dir}", "--device=cuda"])
    demo_seconds = time.perf_counter() - t0
    # G for the grid and the interpolation, D (attention at B1) once.
    demo_launches = fa.launches_fwd
    shapes = {}
    for name in ("samples.png", "interpolation.png"):
        with open(os.path.join(out_dir, name), "rb") as f:
            shapes[name] = image_codec.decode_png(f.read()).shape
    print(f"demo {demo_seconds:.2f} s, pngs {shapes}, D predictions "
          f"{result['predictions'].tolist()}, forward launches "
          f"{demo_launches}")
    if shapes != {"samples.png": (3 * 128, 4 * 128, 3),
                  "interpolation.png": (128, 8 * 128, 3)} or \
            not np.isfinite(result["predictions"]).all() or \
            demo_launches != 3:
        raise AssertionError("the demo's outputs or launches are wrong")
    launches = report["launches"] + eager_launches + demo_launches
    return {"fwd": launches, "bwd": 0}, {
        "images_per_second": rates, "max_abs_err": errors,
        "export_seconds": export_seconds,
        "load_seconds": report["load_seconds"],
        "cuda_init_seconds": report["cuda_init_seconds"],
        "artifact_bytes": artifact,
        "weight_bytes": weights, "demo_seconds": demo_seconds,
        "launches": {"program": report["launches"], "eager": eager_launches,
                     "demo": demo_launches}}


# The "tf formats" phase: TFRecord data, JPEG/PNG decode and reference
# checkpoints without TensorFlow. Its dataset is TFDS's imagenet2012 layout
# written here from the committed fixtures (the card has no encoder): the
# RGB JPEGs (4:2:0, 4:4:4, 4:2:2, progressive, restart intervals; 26x37 to
# 128x96 px) cycled into 64 train and EVAL_SAMPLES validation records.
FIXTURES = os.path.join(ROOT, "tests", "torch_fixtures")
TF_TRAIN_RECORDS = 64
DECODE_RATE_IMAGE = "jpeg_420_q85_128x96.jpg"  # 4:2:0 baseline, quality 85
DECODE_RATE_COUNT = 2000
POOL_THREADS = 8  # the input pipeline's pool (num_parallel_calls)
BLOCKED_MODULES = ("tensorflow", "PIL", "google.protobuf")


def _fixture_images():
    """{name: (encoded bytes, tf.io.decode_image's golden)} of every
    committed fixture."""
    import numpy as np
    out = {}
    for name in sorted(os.listdir(FIXTURES)):
        if name.endswith((".jpg", ".png")):
            with open(os.path.join(FIXTURES, name), "rb") as f:
                out[name] = (f.read(), np.load(os.path.join(
                    FIXTURES, os.path.splitext(name)[0] + ".npy")))
    return out


def check_decode(fixtures):
    """Every fixture decodes bitwise to its golden; the JPEG decode rate of
    the 4:2:0 image in this thread and in a pool of POOL_THREADS threads
    (the input pipeline's). Returns the rates."""
    import concurrent.futures
    import numpy as np
    from compare_gan_torch.tf_io import image_codec
    for name, (data, golden) in fixtures.items():
        got = image_codec.decode_image(data)
        ok = got.shape == golden.shape and got.dtype == golden.dtype and \
            bool((got == golden).all())
        print(f"  decode {name} {golden.shape} "
              f"{'bitwise' if ok else 'DIFFERS'}")
        if not ok:
            raise AssertionError(f"{name} does not decode to its golden")
    data, golden = fixtures[DECODE_RATE_IMAGE]
    image_codec.decode_image(data)
    t0 = time.perf_counter()
    for _ in range(DECODE_RATE_COUNT):
        image_codec.decode_image(data)
    one = DECODE_RATE_COUNT / (time.perf_counter() - t0)
    with concurrent.futures.ThreadPoolExecutor(POOL_THREADS) as pool:
        list(pool.map(image_codec.decode_image, [data] * POOL_THREADS))
        t0 = time.perf_counter()
        list(pool.map(image_codec.decode_image, [data] * DECODE_RATE_COUNT))
        pooled = DECODE_RATE_COUNT / (time.perf_counter() - t0)
    pixels = golden.shape[0] * golden.shape[1]
    print(f"jpeg_decode_images_per_second {DECODE_RATE_IMAGE} "
          f"{golden.shape[1]}x{golden.shape[0]} one_worker {one:.1f} "
          f"pool_{POOL_THREADS}_threads {pooled:.1f} (megapixels/s "
          f"{one * pixels / 1e6:.2f} / {pooled * pixels / 1e6:.2f}; "
          f"os.cpu_count {os.cpu_count()})")
    return {"image": DECODE_RATE_IMAGE, "one_worker": one,
            "pool": pooled, "pool_threads": POOL_THREADS,
            "pixels": pixels}


def write_imagenet_records(data_dir, fixtures):
    """TFDS's imagenet2012 layout under `data_dir`, written with the port's
    Example encoder and TFRecord framing: `image`, `label` (seeded),
    `file_name`; train in two shards, validation in one."""
    import numpy as np
    from compare_gan_torch.tf_io import protobuf, tfrecord
    jpegs = [(n, d) for n, (d, g) in fixtures.items()
             if n.endswith(".jpg") and g.shape[2] == 3]
    rng = np.random.RandomState(0)
    out = os.path.join(data_dir, "imagenet2012")
    os.makedirs(out, exist_ok=True)

    def records(split, n):
        for i in range(n):
            name, data = jpegs[i % len(jpegs)]
            yield protobuf.encode_example({
                "image": data, "label": int(rng.randint(1000)),
                "file_name": f"{split}_{i:05d}_{name}".encode()})

    half = TF_TRAIN_RECORDS // 2
    for shard, payloads in enumerate((records("train", half),
                                      records("train", half))):
        tfrecord.write_tfrecords(os.path.join(
            out, f"imagenet2012-train.tfrecord-{shard:05d}-of-00002"),
            payloads)
    tfrecord.write_tfrecords(os.path.join(
        out, "imagenet2012-validation.tfrecord-00000-of-00001"),
        records("validation", EVAL_SAMPLES))
    print(f"wrote {TF_TRAIN_RECORDS} train and {EVAL_SAMPLES} validation "
          f"records of {len(jpegs)} JPEG fixtures to {out}")


def pipeline_rate(batch_size=32, batches=20):
    """Images per second of the ImageNet-128 train pipeline alone (record
    read, JPEG decode, distorted crop, resize; host only)."""
    from compare_gan_torch import datasets
    it = datasets.get_dataset("imagenet_128").train_input_fn(batch_size)
    try:
        next(it)
        t0 = time.perf_counter()
        for _ in range(batches):
            next(it)
        return batch_size * batches / (time.perf_counter() - t0)
    finally:
        it.close()


def _checkpoint_arrays(path):
    import numpy as np
    with np.load(path) as data:
        return {k: data[k] for k in data.files
                if k.startswith((".params", ".state", ".ema_params"))}


def run_tf_formats(torch, model_dir):
    """BigGAN-128 at full width on TFRecord JPEG data through the CLI (no
    --data_fake_dataset), its reference-checkpoint export and re-import
    (bitwise), and the eval of the re-imported model_dir."""
    _phase("tf formats")
    import numpy as np
    from compare_gan_torch import datasets, export, import_tf_checkpoint
    from compare_gan_torch import config as gin
    fixtures = _fixture_images()
    summary = {"decode": check_decode(fixtures)}
    data_dir = os.path.join(model_dir, "data")
    write_imagenet_records(data_dir, fixtures)
    saved = datasets.DATA_DIR, datasets.DATASETS["imagenet_128"]
    datasets.DATA_DIR = data_dir
    # The eval's cut: EVAL_SAMPLES real validation images (the registry's
    # 50,000 cut to the eval phase's 100).
    datasets.DATASETS["imagenet_128"] = datasets._imagenet(
        128, eval_samples=EVAL_SAMPLES)
    launches = {"fwd": 0, "bwd": 0}
    try:
        summary["pipeline_images_per_second"] = pipeline_rate()
        print(f"pipeline_images_per_second (ImageNet-128 train transform, "
              f"{POOL_THREADS} threads) "
              f"{summary['pipeline_images_per_second']:.1f}")
        trained = os.path.join(model_dir, "trained")
        report, runs = _train_and_check(
            torch, trained, _argv(trained, "train", fake_data=False),
            (G_PARAMS, D_PARAMS), {"fwd": 5 * STEPS, "bwd": 4 * STEPS})
        launches = {k: launches[k] + runs[k] for k in launches}
        summary["seconds_per_step"] = report.seconds_per_step
        ts = report.state

        values = sum(v.numel() for tree in (ts.params(), ts.state(),
                                            ts.ema_params)
                     for v in tree.values())
        export_dir = os.path.join(model_dir, "tf_export")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prefix = export.export_reference_checkpoint(
            None, ts, os.path.join(export_dir, f"model.ckpt-{STEPS}"))
        summary["export_seconds"] = time.perf_counter() - t0
        del report, ts
        size = sum(os.path.getsize(os.path.join(export_dir, f))
                   for f in os.listdir(export_dir))
        reimported = os.path.join(model_dir, "reimported")
        gin.clear_config()
        t0 = time.perf_counter()
        config = os.path.join(ROOT, "example_configs",
                              "biggan_imagenet128.gin")
        import_tf_checkpoint.main(
            [f"--checkpoint={export_dir}", f"--model_dir={reimported}",
             "--device=cuda", f"--gin_config={config}"]
            + [f"--gin_bindings={b}" for b in BIGGAN_BINDINGS])
        torch.cuda.synchronize()
        summary["import_seconds"] = time.perf_counter() - t0
        summary["values"] = values
        print(f"export {prefix}: {values:,} values, {size / 2 ** 20:.1f} "
              f"MiB, {summary['export_seconds']:.2f} s; import through "
              f"the CLI {summary['import_seconds']:.2f} s")
        before = _checkpoint_arrays(os.path.join(trained,
                                                 f"model.ckpt-{STEPS}.npz"))
        after = _checkpoint_arrays(os.path.join(reimported,
                                                f"model.ckpt-{STEPS}.npz"))
        same = set(before) == set(after) and all(
            before[k].dtype == after[k].dtype
            and np.array_equal(before[k], after[k]) for k in before)
        print(f"export then import: {len(after)} variables "
              f"{'bitwise equal' if same else 'DIFFER'}")
        if not same:
            raise AssertionError("export -> import is not bitwise")

        eval_launches, summary["eval"] = run_eval(
            torch, reimported,
            _argv(reimported, "eval_after_train", fake_data=False),
            SESSION_TASKS[:2], (128, 128, 3), attention=1,
            accumulators=True, phase="tf formats eval")
        launches = {k: launches[k] + eval_launches[k] for k in launches}
    finally:
        datasets.DATA_DIR, datasets.DATASETS["imagenet_128"] = saved
        shutil.rmtree(model_dir, ignore_errors=True)
    loaded = sorted(m for m in sys.modules if m.startswith(BLOCKED_MODULES))
    print(f"modules of tensorflow, PIL, google.protobuf loaded: {loaded}")
    if loaded:
        raise AssertionError(f"the port loaded {loaded}")
    return launches, summary


# The "convergence tools" phase: the port's convergence-proof tools
# (compare_gan_torch/tools) on short runs of the two convergence
# configurations as published, on small polygon sets written here.
CONV_STEPS, CONV_SAVE = 24, 12
CONV_ACCU = 256  # The ema-vs-raw fill, cut from the config's 16,384.
CONV_EMA_START = 4  # EMA from step 4 (the config's 1,000): EMA != raw.
CONV_BIGGAN_SIZES = (256, 128, 128)  # train, test, holdout at 128 px
CONV_S3GAN_SIZES = (1024, 256, 256)  # at 32 px, both probe sets
CONV_PREDICTOR_EXAMPLES = 256
CONV_PROBE = ("--n_train=1024", "--n_test=256", "--steps=200")
# Attention launches a step of each configuration (f32, no joint G
# forward): BigGAN-128 runs G after B4 in both D sub-steps and the G
# sub-step, D after B1 in each (6 forward, 4 backward); S3GAN-32 runs D
# after B1 in each sub-step (3 forward, 3 backward).
CONV_BIGGAN_LAUNCHES = {"fwd": 6, "bwd": 4}
CONV_S3GAN_LAUNCHES = {"fwd": 3, "bwd": 3}


def _conv_train(torch, model_dir, config, extra, per_step):
    """CONV_STEPS steps of `config` through the CLI, checkpoints every
    CONV_SAVE; checks finite losses, the checkpoints and the launches."""
    import numpy as np
    from compare_gan_torch import checkpoint as ckpt_lib
    from compare_gan_torch import config as gin
    from compare_gan_torch import main
    from compare_gan_torch.ops import fused_attention as fa
    gin.clear_config()
    fa.launches_fwd = fa.launches_bwd = 0
    argv = [f"--model_dir={model_dir}", "--schedule=train", "--device=cuda",
            f"--gin_config={os.path.join(ROOT, 'example_configs', config)}",
            f"--gin_bindings=options.training_steps = {CONV_STEPS}",
            "--gin_bindings=run_config.iterations_per_loop = 4",
            f"--gin_bindings=run_config.save_checkpoints_steps = {CONV_SAVE}",
            ] + [f"--gin_bindings={b}" for b in extra]
    t0 = time.perf_counter()
    report = main.main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {"fwd": fa.launches_fwd, "bwd": fa.launches_bwd}
    expected = {k: v * CONV_STEPS for k, v in per_step.items()}
    steps = [ckpt_lib.step_of(p) for p in ckpt_lib.all_checkpoints(model_dir)]
    print(f"{config}: {CONV_STEPS} steps in {seconds:.2f} s, checkpoints "
          f"{steps}, launches {launches} (expected {expected}), last "
          f"losses {report.metrics[-1]}")
    if not all(np.isfinite(v) for m in report.metrics for v in m.values()):
        raise AssertionError(f"{config}: non-finite losses")
    if steps != [0, CONV_SAVE, CONV_STEPS]:
        raise AssertionError(f"{config}: checkpoints {steps}")
    if launches != expected:
        raise AssertionError(f"{config}: launches {launches} != {expected}")
    if report.train_launches != launches:
        raise AssertionError(f"{config}: the report's training launches "
                             f"{report.train_launches} != {launches}")
    return launches, {"seconds": seconds,
                      "seconds_per_step": report.seconds_per_step}


def _tool_launches(torch, fn, argv):
    """A tool's main(argv) with the counters at 0: (result, launches)."""
    from compare_gan_torch import config as gin
    from compare_gan_torch.ops import fused_attention as fa
    gin.clear_config()
    fa.launches_fwd = fa.launches_bwd = 0
    out = fn(argv + ["--device=cuda"])
    torch.cuda.synchronize()
    return out, {"fwd": fa.launches_fwd, "bwd": fa.launches_bwd}


def run_convergence_tools(torch, model_dir):
    """BigGAN-128 at full width (batch 16) and S3GAN-32 (batch 64) as
    published, CONV_STEPS steps each, then every tool of
    compare_gan_torch/tools that reads a run or a dataset on them."""
    _phase("convergence tools")
    import csv
    import numpy as np
    from compare_gan_torch import datasets, polygons
    from compare_gan_torch.tools import (
        eval_ema_vs_raw, fid_anchors, rotation_probe, s3gan_predictor_eval,
        tb_scalars)
    t0 = time.perf_counter()
    data_dir = os.path.join(model_dir, "data")
    polygons.write_multiclass128_npz_dataset(
        data_dir, *CONV_BIGGAN_SIZES)
    for write in (polygons.write_partial_oriented_npz_dataset,
                  polygons.write_partial_npz_dataset):
        write(data_dir, n_train=CONV_S3GAN_SIZES[0],
              n_test=CONV_S3GAN_SIZES[1], n_holdout=CONV_S3GAN_SIZES[2])
    summary = {"data_seconds": time.perf_counter() - t0}
    saved = (datasets.DATA_DIR, dict(datasets.DATASETS),
             os.environ.get("COMPARE_GAN_DATA_DIR"))
    # The tools that read the .npz splits themselves take the environment's.
    os.environ["COMPARE_GAN_DATA_DIR"] = datasets.DATA_DIR = data_dir
    datasets.cut_eval_split("convex_polygons_multiclass_128",
                            CONV_BIGGAN_SIZES[1])
    datasets.cut_eval_split("convex_polygons_partial_oriented",
                            CONV_S3GAN_SIZES[1])
    runs = []
    try:
        biggan = os.path.join(model_dir, "biggan128")
        config = "biggan128_polygons_multiclass.gin"
        launches, summary["biggan128_train"] = _conv_train(
            torch, biggan, config,
            [f"ModularGAN.ema_start_step = {CONV_EMA_START}"],
            CONV_BIGGAN_LAUNCHES)
        runs.append(launches)

        # EMA against raw G at a cut fill: 2 checkpoints x 2 views x
        # (fill batches + sampled batches) forward launches, G's B4 only.
        out = os.path.join(model_dir, "ema_vs_raw.csv")
        t0 = time.perf_counter()
        _, launches = _tool_launches(torch, eval_ema_vs_raw.main, [
            f"--model_dir={biggan}", "--gin_config",
            os.path.join(ROOT, "example_configs", config), "--gin_bindings",
            f"evaluation.num_accu_examples = {CONV_ACCU}", f"--out={out}"])
        runs.append(launches)
        with open(out, newline="") as f:
            rows = [{k: float(v) for k, v in r.items()}
                    for r in csv.DictReader(f)]
        per_view = CONV_ACCU // EVAL_BATCH + -(-CONV_BIGGAN_SIZES[1]
                                               // EVAL_BATCH)
        expected = {"fwd": 2 * 2 * per_view, "bwd": 0}
        print(f"ema_vs_raw {rows} in {time.perf_counter() - t0:.2f} s, "
              f"launches {launches} (expected {expected})")
        if [r["step"] for r in rows] != [CONV_SAVE, CONV_STEPS] or not all(
                np.isfinite(r["fid_ema"]) and np.isfinite(r["fid_raw"])
                and r["fid_ema"] != r["fid_raw"] for r in rows):
            raise AssertionError(f"ema_vs_raw rows {rows}")
        if launches != expected:
            raise AssertionError(f"ema_vs_raw launches {launches} != "
                                 f"{expected}")
        summary["ema_vs_raw"] = {"rows": rows, "launches": launches,
                                 "seconds": time.perf_counter() - t0}

        t0 = time.perf_counter()
        anchors, _ = _tool_launches(torch, fid_anchors.main, [
            "--dataset=convex_polygons_multiclass_128",
            f"--max_per_split={CONV_BIGGAN_SIZES[1]}"])
        print(f"fid_anchors {anchors} in {time.perf_counter() - t0:.2f} s")
        if not 0 <= anchors["real_vs_real"] < anchors["real_vs_noise"]:
            raise AssertionError(f"anchors {anchors}")
        summary["anchors"] = anchors

        same, tags = tb_scalars.forms_agree(biggan)
        print(f"tb_scalars: event files and JSONL rows "
              f"{'agree' if same else 'DIFFER'} on tags {tags}")
        if not same or "loss/d_0" not in tags:
            raise AssertionError("event and JSONL series differ")
        csv_dir = os.path.join(model_dir, "loss_traces")
        tb_scalars.main([f"--model_dir={biggan}", f"--out_dir={csv_dir}"])
        summary["tb_scalars"] = {"tags": tags,
                                 "csvs": sorted(os.listdir(csv_dir))}

        s3gan = os.path.join(model_dir, "s3gan32")
        config = "s3gan32_polygons_partial_oriented.gin"
        launches, summary["s3gan32_train"] = _conv_train(
            torch, s3gan, config, [], CONV_S3GAN_LAUNCHES)
        runs.append(launches)
        rows, launches = _tool_launches(torch, s3gan_predictor_eval.main, [
            f"--model_dir={s3gan}", "--gin_config",
            os.path.join(ROOT, "example_configs", config),
            f"--num_examples={CONV_PREDICTOR_EXAMPLES}",
            f"--out_csv={os.path.join(model_dir, 'predictor.csv')}"])
        runs.append(launches)
        # D (one attention block) on every whole batch of every checkpoint.
        expected = {"fwd": 3 * (CONV_PREDICTOR_EXAMPLES // EVAL_BATCH),
                    "bwd": 0}
        accs = [float(r["predictor_accuracy"]) for r in rows]
        print(f"s3gan_predictor_eval {rows}, launches {launches} "
              f"(expected {expected})")
        if [r["step"] for r in rows] != [0, CONV_SAVE, CONV_STEPS] or not \
                all(0.0 <= a <= 1.0 for a in accs):
            raise AssertionError(f"predictor rows {rows}")
        if launches != expected:
            raise AssertionError(f"predictor launches {launches} != "
                                 f"{expected}")
        summary["predictor_accuracy"] = accs

        t0 = time.perf_counter()
        probe, _ = _tool_launches(torch, rotation_probe.main, [
            "--datasets", "convex_polygons_partial",
            "convex_polygons_partial_oriented", *CONV_PROBE])
        invariant, oriented = (r["test_accuracy"] for r in probe)
        print(f"rotation_probe test accuracy: invariant {invariant:.4f}, "
              f"oriented {oriented:.4f} ({time.perf_counter() - t0:.2f} s)")
        if not oriented > invariant:
            raise AssertionError(f"probe {probe}")
        summary["probe"] = {"invariant": invariant, "oriented": oriented}
    finally:
        datasets.DATA_DIR = saved[0]
        datasets.DATASETS.clear()
        datasets.DATASETS.update(saved[1])
        if saved[2] is None:
            del os.environ["COMPARE_GAN_DATA_DIR"]
        else:
            os.environ["COMPARE_GAN_DATA_DIR"] = saved[2]
        shutil.rmtree(model_dir, ignore_errors=True)
    launches = {k: sum(r[k] for r in runs) for k in ("fwd", "bwd")}
    summary["launches"] = launches
    return launches, summary


# Steps of the trajectory phase, and the attention gates (`sigma` of
# each non-local block) it starts from. The recipe's gates start at 0, so
# over the first steps the attention reaches the losses only through
# sigma's own gradient: on an NVIDIA H100 80GB HBM3 at 700 W, bf16
# operands moved the 5-step losses less (1.7e-4) than the plain attention
# on hi + lo rounded operands did (8.8e-4), and over 10 and 30 steps every
# perturbation reached the same gaps (at 30 steps all parted at steps
# 13-15, as chaotic trajectories do). With the gates at TRAJ_GATE, as the
# forward parity tests open them, the attention is in every loss from the
# first step.
TRAJ_STEPS = 5
TRAJ_GATE = 0.5
TRAJ_SIZES = (256, 48, 48)  # train, test, holdout at 128 px
TRAJ_SEED = 547  # The CLI's default seed.
# Adam's epsilon at 1e-3, as in the data-parallel phase: at the recipe's
# 1e-8 with beta1 0, Adam's first update is lr * sign(gradient), so any
# rounding flips the update of every entry whose gradient is rounding
# noise (a bias feeding a batch norm) and a gap no longer grows with the
# size of the perturbation.
TRAJ_BINDINGS = ("tf.train.AdamOptimizer.epsilon = 1e-3",)
# At every step the kernel run's loss gap to the plain run may be at most
# TRAJ_MARGIN times that of the plain run on operands rounded to the f32
# kernels' own precision (bf16 hi + lo parts), plus TRAJ_FLOOR (f32
# rounding of an O(1) loss); so may its final weights' rms gap. The bound
# is the spread that rounding at the kernels' precision grows to along
# the same trajectory, measured in this run. The bf16 control must exceed
# it at some step or in the weights.
TRAJ_MARGIN = 8.0
TRAJ_FLOOR = 1e-6


def _round_hilo(torch, x):
    """x rounded to what the f32 kernels multiply: a bf16 hi part plus a
    bf16 lo part of the remainder."""
    hi = x.to(torch.bfloat16).float()
    return hi + (x - hi).to(torch.bfloat16).float()


def _round_bf16(torch, x):
    return x.to(torch.bfloat16).float()


def _rounded_operands(torch, attend, rounding):
    """`attend` on operands rounded by `rounding`, gradients passed
    straight through the rounding."""
    def fn(theta, phi, g):
        r = [x + (rounding(torch, x) - x).detach() for x in (theta, phi, g)]
        return attend(*r)
    return fn


def _step_loss_gaps(run, ref):
    """Each step's loss gap: the largest over the D and G losses of
    |a - b| / max(|b|, 1) (a hinge loss may reach 0)."""
    return [max(abs(a - b) / max(abs(b), 1.0) for a, b in zip(ra, rb))
            for ra, rb in zip(run["losses"], ref["losses"])]


def _trajectory_gaps(torch, run, ref, init):
    """The per-step loss gaps (`_step_loss_gaps`) and the final weights'
    rms gap over the rms of the reference's update."""
    diff = upd = 0.0
    for k, p in ref["params"].items():
        diff += float(((run["params"][k] - p).double() ** 2).sum())
        upd += float(((p - init[k]).double() ** 2).sum())
    return {"loss_gaps": _step_loss_gaps(run, ref),
            "rms_gap": (diff / upd) ** 0.5}


def _within(gaps, bound):
    """Every step's loss gap and the rms gap within `bound`."""
    return all(g <= b for g, b in zip(gaps["loss_gaps"], bound["loss_gaps"])
               ) and gaps["rms_gap"] <= bound["rms_gap"]


def run_kernel_trajectory(torch, model_dir, steps=TRAJ_STEPS,
                          gate=TRAJ_GATE, check=True):
    """BigGAN-128 as published (biggan128_polygons_multiclass.gin, full
    width, batch 16, f32; Adam's epsilon as TRAJ_BINDINGS) with its
    attention gates at `gate`, for `steps` train steps with TF32 off and
    deterministic cuDNN, four times from one init, on the same polygon
    batches and the port's own draws: the attention through
    `reference_attention` on the CUDA tensors, the same on operands rounded
    to the f32 kernels' hi + lo precision, through the kernels, and through
    the kernels fed bf16-rounded operands (a control). With `check`, the
    kernel run must stay within the bound of TRAJ_MARGIN at every step and
    in the final weights, and the control must not. Other `steps` and
    `gate` with `check=False` give the longer and gate-closed runs that
    PERF.md reports."""
    _phase("kernel trajectory")
    from compare_gan_torch import config as gin
    from compare_gan_torch import datasets, interop, polygons, runner_lib
    from compare_gan_torch.gans import modular_gan  # noqa: F401
    from compare_gan_torch.ops import fused_attention as fa
    t0 = time.perf_counter()
    data_dir = os.path.join(model_dir, "data")
    polygons.write_multiclass128_npz_dataset(data_dir, *TRAJ_SIZES,
                                             n_workers=8)
    saved = (datasets.DATA_DIR, torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark, fa.fused_attention)
    datasets.DATA_DIR = data_dir
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    kernel = fa.fused_attention
    variants = {
        "reference": fa.reference_attention,
        "reference_hilo": _rounded_operands(torch, fa.reference_attention,
                                            _round_hilo),
        "kernel": kernel,
        "kernel_bf16_operands": _rounded_operands(torch, kernel,
                                                  _round_bf16)}
    runs = {}
    try:
        gin.clear_config()
        gin.parse_config_files_and_bindings([os.path.join(
            ROOT, "example_configs", "biggan128_polygons_multiclass.gin")],
            list(TRAJ_BINDINGS))
        options = runner_lib.get_options_dict()
        gan = options["gan_class"](
            dataset=datasets.get_dataset(seed=TRAJ_SEED),
            parameters=options, model_dir=model_dir, device="cuda")
        batch_size = options["batch_size"]
        init = {k: (torch.full_like(v, gate)
                    if k.endswith("non_local_block/sigma']") else
                    v.detach().cpu().clone()) for k, v in
                interop.state_dict(gan.init_state(TRAJ_SEED)).items()}
        batches = gan.input_batches(batch_size)
        batches = [next(batches) for _ in range(steps)]
        step = gan.make_train_step(batch_size)
        for name, attend in variants.items():
            ts = gan.init_state(TRAJ_SEED)  # Fresh optimizer states.
            interop.load_state_dict(ts, init)
            fa.fused_attention = attend
            fa.launches_fwd = fa.launches_bwd = 0
            t1 = time.perf_counter()
            losses = []
            for batch in batches:
                ts, m = step(ts, batch)
                losses.append([float(m[k]) for k in
                               ("loss/d_0", "loss/d_1", "loss/g")])
            torch.cuda.synchronize()
            runs[name] = {
                "losses": losses, "seconds": time.perf_counter() - t1,
                "launches": {"fwd": fa.launches_fwd,
                             "bwd": fa.launches_bwd},
                "params": {k: v.detach().cpu().clone()
                           for k, v in ts.params().items()}}
            fa.fused_attention = kernel
            print(f"{name}: {steps} steps in {runs[name]['seconds']:.2f}"
                  f" s, launches {runs[name]['launches']}, losses at step "
                  f"{steps} {losses[-1]}")
    finally:
        (datasets.DATA_DIR, torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark, fa.fused_attention) = saved
        shutil.rmtree(data_dir, ignore_errors=True)
    init = {k[len(".params['"):-2]: v for k, v in init.items()
            if k.startswith(".params")}
    ref = runs["reference"]
    gaps = {name: _trajectory_gaps(torch, runs[name], ref, init)
            for name in variants if name != "reference"}
    hilo = gaps["reference_hilo"]
    bound = {"loss_gaps": [TRAJ_MARGIN * g + TRAJ_FLOOR
                           for g in hilo["loss_gaps"]],
             "rms_gap": TRAJ_MARGIN * hilo["rms_gap"]}
    summary = {
        "steps": steps, "gate": gate, "margin": TRAJ_MARGIN,
        "floor": TRAJ_FLOOR, "bound": bound, "gaps": gaps,
        "within": {name: _within(g, bound) for name, g in gaps.items()},
        "losses": {k: r["losses"] for k, r in runs.items()},
        "launches": {k: r["launches"] for k, r in runs.items()},
        "seconds": time.perf_counter() - t0,
        "step_seconds": {k: r["seconds"] / steps for k, r in runs.items()}}
    print("kernel_trajectory " + json.dumps(summary))
    if not check:
        return summary
    expected = {k: v * steps for k, v in CONV_BIGGAN_LAUNCHES.items()}
    for name in ("kernel", "kernel_bf16_operands"):
        if runs[name]["launches"] != expected:
            raise AssertionError(f"{name}: launches {runs[name]['launches']}"
                                 f" != {expected}")
    for name in ("reference", "reference_hilo"):
        if runs[name]["launches"] != {"fwd": 0, "bwd": 0}:
            raise AssertionError(f"{name} launched a kernel")
    if not summary["within"]["kernel"]:
        raise AssertionError(f"the kernels part from the reference over "
                             f"{steps} steps beyond the bound {bound}: "
                             f"{gaps['kernel']}")
    if summary["within"]["kernel_bf16_operands"]:
        raise AssertionError(f"the bound {bound} cannot tell bf16 operands "
                             f"apart: {gaps['kernel_bf16_operands']}")
    return summary


def main():
    if not os.path.isdir(os.path.join(ROOT, "compare_gan_torch")):
        raise SystemExit("chip_smoke: run from a checkout of the repository "
                         "(compare_gan_torch/ is missing).")
    sys.path.insert(0, ROOT)
    import torch

    t_start = time.perf_counter()
    check_device(torch)
    build_kernels()
    (kernels, eval_row, s3gan_row, deep_rows, convergence_rows,
     spatial_rows) = compare_kernels(torch)
    model_dir = tempfile.mkdtemp(prefix="chip_smoke_")
    runs, seconds = {}, {}

    def timed(name, fn, *args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        seconds[name] = time.perf_counter() - t0
        print(f"phase_seconds {name} {seconds[name]:.2f}")
        return out

    try:
        biggan = os.path.join(model_dir, "biggan")
        deep = os.path.join(model_dir, "biggan_deep")
        dcgan = os.path.join(model_dir, "study_zoo", "dcgan")
        runs["train"] = timed("train", run_main_path, torch, biggan)
        setup_inception(torch, model_dir)
        runs["eval"], _ = timed(
            "eval", run_eval, torch, biggan,
            _argv(biggan, "eval_after_train"), SESSION_TASKS[:2],
            (128, 128, 3), attention=1, accumulators=True)
        runs["serving"], serving = timed("serving", run_serving, torch,
                                         biggan)
        runs["data_parallel"], data_parallel = timed(
            "data_parallel", run_data_parallel, torch,
            os.path.join(model_dir, "data_parallel"))
        runs["spatial"], spatial = timed(
            "spatial", run_spatial, torch, os.path.join(model_dir, "spatial"))
        runs["s3gan"] = timed("s3gan", run_s3gan, torch,
                              os.path.join(model_dir, "s3gan"))
        runs["ssgan"] = timed("ssgan", run_ssgan, torch,
                              os.path.join(model_dir, "ssgan"))
        runs["study_zoo"], study_zoo = timed(
            "study_zoo", run_study_zoo, torch,
            os.path.join(model_dir, "study_zoo"))
        runs["deep_train"] = timed("deep_train", run_biggan_deep, torch,
                                   deep)
        runs["deep_eval"], deep_eval = timed(
            "deep_eval", run_eval, torch, deep,
            _deep_argv(deep, "eval_after_train"), SESSION_TASKS,
            (128, 128, 3), attention=1, accumulators=True,
            phase="BigGAN-deep eval")
        runs["gan_tasks"], gan_tasks = timed("gan_tasks", run_gan_tasks,
                                             torch, dcgan)
        runs["tf_formats"], tf_formats = timed(
            "tf_formats", run_tf_formats, torch,
            os.path.join(model_dir, "tf_formats"))
        runs["convergence_tools"], convergence_tools = timed(
            "convergence_tools", run_convergence_tools, torch,
            os.path.join(model_dir, "convergence_tools"))
        # A comparison of the kernels with the plain attention: its
        # launches are not the main path's.
        trajectory = timed("kernel_trajectory", run_kernel_trajectory,
                           torch, os.path.join(model_dir, "trajectory"))
    finally:
        shutil.rmtree(model_dir, ignore_errors=True)
    launches = {k: sum(r[k] for r in runs.values()) for k in ("fwd", "bwd")}

    source = "compare_gan_torch/csrc/attention.cu"
    replaces = {"fwd": "compare_gan_tpu/ops/pallas_attention.py:90",
                "bwd": "compare_gan_tpu/ops/pallas_attention.py:146"}
    eval_row["launches"] = runs["eval"]["fwd"]
    print("eval_shape_forward " + json.dumps(eval_row))
    # The counters count calls, not shapes: of the S3GAN phase's 5 forward
    # and 4 backward launches a step, 3 of each run at D's 38 rows.
    for kern in ("fwd", "bwd"):
        s3gan_row[kern]["phase_launches"] = runs["s3gan"][kern]
    print("s3gan_shape " + json.dumps(s3gan_row))
    # BigGAN-deep's training launches (G's in f32, D's in bf16) and its
    # eval's forwards, all at C = 32, Cg = 128.
    for row in deep_rows:
        row["phase_launches"] = (runs["deep_eval"] if "eval" in row["shape"]
                                 else runs["deep_train"])
        print("biggan_deep_shape " + json.dumps(row))
    print("biggan_deep_eval " + json.dumps(deep_eval))
    print("gan_tasks " + json.dumps(gan_tasks))
    print("study_zoo " + json.dumps(study_zoo))
    print("data_parallel " + json.dumps(data_parallel))
    # The bands' rows, with both workers' launches of the spatial step.
    for row in spatial_rows:
        row["phase_launches"] = runs["spatial"]
        print("spatial_shape " + json.dumps(row))
    print("spatial " + json.dumps(spatial))
    print("tf_formats " + json.dumps(tf_formats))
    # The convergence configurations' f32 shapes, with the launches of the
    # phase's runs and tools that ran them (the counters count calls).
    for row in convergence_rows:
        row["phase_launches"] = convergence_tools["launches"]
        print("convergence_shape " + json.dumps(row))
    print("convergence_tools " + json.dumps(convergence_tools))
    print("kernel_trajectory_gaps " + json.dumps(
        {k: trajectory[k] for k in ("steps", "gate", "margin", "floor",
                                    "bound", "gaps", "within")}))
    print("serving " + json.dumps(serving))
    seconds["total"] = time.perf_counter() - t_start
    print("phase_seconds " + json.dumps(seconds))
    print(json.dumps({"kernels": [
        {"name": f"attention_{k}", "route": "cuda", "source": source,
         "replaces": replaces[k], "launches": launches[k],
         **kernels[k]} for k in ("fwd", "bwd")]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
