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
   types, and BigGAN-deep's eval forward (batch 64, f32). Prints each
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
6. S3GAN main path: 3 steps of S3GAN on BigGAN-128 at full width through
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
7. SSGAN main path: 3 steps of SSGAN on ResNet-CIFAR-32 at its published
   widths through the CLI with example_configs/ssgan32_polygons_oriented.gin
   on fake CIFAR-10 (batch 64, 64 rotated examples: D sees 224 rows, f32).
   Checks the parameter counts (G 5,849,603; D with its head 1,483,653),
   finite losses (the rotation losses included), the checkpoint and that
   no attention kernel ran (the architecture has no attention). Prints
   seconds per step and peak device memory.
8. Study zoo: 3 steps each of resnet_lsun-bedroom128.gin (ResNet5,
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
9. BigGAN-deep main path: 3 steps of BigGAN-deep-128 as published (ch
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
10. G/D-access tasks: eval_after_train of the study zoo's DCGAN-64
   checkpoint (dcgan_celeba64.gin as published: unconditional, uniform z)
   with all ten tasks, adding the Jacobian's conditioning, D's accuracy
   and GILBO at its defaults (2,000 regressor steps at batch 64, its
   artifacts written and checked). Every metric finite; each task's
   seconds.
11. Prints the eval shape's forward row, the S3GAN D shape's bf16 row and
   the BigGAN-deep rows as JSON lines of their own (`eval_shape_forward
   {...}`, `s3gan_shape {...}`, one `biggan_deep_shape {...}` per type and
   the eval forward: tolerances, SDPA backend, times, bound and share),
   the BigGAN-deep eval and G/D-task summaries, each phase's seconds, then
   one JSON line describing each kernel ("ms",
   "plain_ms", "library_ms", "bound_ms": one call at each bf16 training
   shape of BigGAN-128, G and D at batch 32, summed; "launches": every
   main-path run together, each counted from 0), then, as the last line,
   {"ok": true, "device": {...}}.
"""

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


def compare_kernels(torch):
    """Kernel vs plain version per shape and type. Returns per kernel its
    max abs error over every case, and times and bounds summed over the
    bf16 training shapes; the eval shape's forward row; the S3GAN D
    shape's bf16 row (forward and backward); and the BigGAN-deep rows
    (each type's forward and backward at batch 32, the eval forward)."""
    _phase("kernels")
    from compare_gan_torch.ops import fused_attention as fa
    sdpa = torch.nn.functional.scaled_dot_product_attention
    dev = torch.device("cuda")
    result = {k: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
                  "library_ms": 0.0, "bound_ms": 0.0, "bound_by": ""}
              for k in ("fwd", "bwd")}
    eval_row = s3gan_row = None
    deep_rows = []
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
        del q, k, v, theta, phi, g, dout, out, mx, den, p_mx, p_den
        torch.cuda.empty_cache()
    return result, eval_row, s3gan_row, deep_rows


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


def _cli_argv(model_dir, config, bindings, schedule="train"):
    """A CLI run on the card with fake data: `config` from example_configs
    with `bindings` on top, 3 steps, one host sync per step, one
    checkpoint at the end."""
    return [
        f"--model_dir={model_dir}", f"--schedule={schedule}",
        "--device=cuda", "--data_fake_dataset",
        f"--gin_config={os.path.join(ROOT, 'example_configs', config)}",
        f"--gin_bindings=options.training_steps = {STEPS}",
        "--gin_bindings=run_config.iterations_per_loop = 1",
        f"--gin_bindings=run_config.save_checkpoints_steps = {STEPS}",
    ] + [f"--gin_bindings={b}" for b in bindings]


def _argv(model_dir, schedule, extra=()):
    """The CLI arguments of both BigGAN-128 phases: the benchmark
    options, and `extra` bindings."""
    return _cli_argv(model_dir, "biggan_imagenet128.gin", [
        "options.batch_size = 16",
        "ModularGAN.compute_dtype = 'bfloat16'",
        "ModularGAN.experimental_joint_gen_for_disc = True",
        "ModularGAN.experimental_fake_only_g_loss = True",
    ] + list(extra), schedule)


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


def main():
    if not os.path.isdir(os.path.join(ROOT, "compare_gan_torch")):
        raise SystemExit("chip_smoke: run from a checkout of the repository "
                         "(compare_gan_torch/ is missing).")
    sys.path.insert(0, ROOT)
    import torch

    t_start = time.perf_counter()
    check_device(torch)
    build_kernels()
    kernels, eval_row, s3gan_row, deep_rows = compare_kernels(torch)
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
