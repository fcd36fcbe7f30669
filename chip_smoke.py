#!/usr/bin/env python3
"""Smoke run of the PyTorch port (compare_gan_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. Device: a CUDA card must be present; prints its name and power limit
   (nvidia-smi) and turns TF32 off for the comparisons.
2. Build: compiles the CUDA kernels of compare_gan_torch/csrc with nvcc
   (sm_90a) into compare_gan_torch/_build and prints the seconds it took.
3. Kernels: the attention forward and backward kernels against their plain
   PyTorch versions at the two main-path shapes (BigGAN-128 G after B4 and
   D after B1, batch 32), in f32 and bf16. Prints each tensor's max abs and
   relative error with its tolerance; the time per call of the kernel, of
   the plain version and of the library call that computes the same
   function (torch's scaled_dot_product_attention with one head and
   scale 1, forward, and its backward through torch.autograd.grad; the
   port never calls it), with the SDPA backend that served it (CUDA
   events, 20 calls after a warm-up); and each kernel's bound (the least
   time the card could take: its operations over the peak rate for the
   input type, or its bytes over the memory rate, whichever is larger)
   with the kernel's share of it.
4. Main path: 3 BigGAN-128 training steps at full width through the port's
   CLI (compare_gan_torch.main.main) with the benchmark options: batch 16,
   bf16 activations, joint G forward for the D sub-steps, fake-only G loss,
   fake ImageNet-128 data, random weights from the default seed. Checks the
   parameter counts (G 70,433,988, D 87,982,370), finite losses,
   model.ckpt-3.npz and TRAIN_DONE, that every kernel ran during the run
   (launch counters reset to 0 just before it), and that G's samples are
   finite images in [0, 1]. Prints losses, counters, seconds per step
   after the first, and peak device memory.
5. Prints one JSON line describing each kernel ("ms", "plain_ms",
   "library_ms", "bound_ms": one call at each of the two main-path shapes
   in bf16, summed), then, as the last line, {"ok": true, "device": {...}}.
"""

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
# (B, N, M, C, Cg) of the non-local block on the main path at 128 px.
SHAPES = {"G_B4": (32, 4096, 1024, 24, 96), "D_B1": (32, 4096, 1024, 12, 48)}
# f32: the same f32 arithmetic summed in another order. bf16: both sides
# round one f32 result to bf16 (the JAX package's Pallas tests use 2e-2).
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
G_PARAMS, D_PARAMS = 70433988, 87982370
STEPS = 3
# Published peaks of one H100 SXM (dense): tensor-core bf16, float32 outside
# the tensor cores, and the memory rate.
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
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


def build_kernels():
    _phase("build")
    from compare_gan_torch.ops import _build
    t0 = time.perf_counter()
    _build.library()
    print(f"build_seconds {time.perf_counter() - t0:.2f}")
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas", line.strip())


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


def _sdpa_backend(torch, q, k, v):
    try:
        return SDPA_BACKENDS.get(int(torch._fused_sdp_choice(q, k, v,
                                                             scale=1.0)),
                                 "unknown")
    except (AttributeError, RuntimeError, TypeError):
        return "unknown"


def compare_kernels(torch):
    """Kernel vs plain version per shape and type; returns per-kernel
    max abs error and bf16 main-path times and bounds."""
    _phase("kernels")
    from compare_gan_torch.ops import fused_attention as fa
    sdpa = torch.nn.functional.scaled_dot_product_attention
    dev = torch.device("cuda")
    result = {k: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
                  "library_ms": 0.0, "bound_ms": 0.0, "bound_by": ""}
              for k in ("fwd", "bwd")}
    for name, (b, n, m, c, cg) in SHAPES.items():
        for dtype_name in ("float32", "bfloat16"):
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
            print(f"{name} B={b} N={n} M={m} C={c} Cg={cg} {dtype_name}")

            out, mx, den = fa.attention_fwd(theta, phi, g)
            torch.cuda.synchronize()
            p_out, p_mx, p_den = fa.attention_fwd_plain(theta, phi, g)
            err = max(_errors(torch, out, p_out, tol, "out"),
                      _errors(torch, mx, p_mx, 1e-4, "mx"),
                      _errors(torch, den, p_den, 1e-4, "den"))
            result["fwd"]["max_abs_err"] = max(result["fwd"]["max_abs_err"],
                                               err)

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
            del plain, auto, leaves

            # The library call: one head, scale 1, value width Cg != C.
            q, k, v = (x.unsqueeze(1) for x in (theta, phi, g))
            leaves = [x.detach().requires_grad_() for x in (q, k, v)]
            lib_out = sdpa(*leaves, scale=1.0)
            lib_dout = dout.unsqueeze(1)
            times = {
                "fwd": _time_ms(torch, lambda: fa.attention_fwd(theta, phi,
                                                                g)),
                "fwd_plain": _time_ms(torch, lambda: fa.attention_fwd_plain(
                    theta, phi, g)),
                "fwd_library": _time_ms(torch, lambda: sdpa(q, k, v,
                                                            scale=1.0)),
                "bwd": _time_ms(torch, lambda: fa.attention_bwd(
                    theta, phi, g, dout, mx, den)),
                "bwd_plain": _time_ms(torch, lambda: fa.attention_bwd_plain(
                    theta, phi, g, dout, mx, den)),
                "bwd_library": _time_ms(torch, lambda: torch.autograd.grad(
                    lib_out, leaves, grad_outputs=lib_dout,
                    retain_graph=True)),
            }
            print("  ms/call " + " ".join(f"{k} {v:.4f}"
                                          for k, v in times.items())
                  + f" (sdpa backend {_sdpa_backend(torch, q, k, v)})")
            bounds = bounds_ms((b, n, m, c, cg), dtype_name)
            for kern, (bound, by) in bounds.items():
                print(f"  {kern} bound {bound:.4f} ms ({by}, "
                      f"{PEAK_FLOPS[dtype_name] / 1e12:g} TFLOP/s, "
                      f"{PEAK_BYTES / 1e12:g} TB/s): kernel at "
                      f"{100 * bound / times[kern]:.1f}% of it")
            if dtype_name == "bfloat16":
                for kern in ("fwd", "bwd"):
                    r = result[kern]
                    r["ms"] += times[kern]
                    r["plain_ms"] += times[kern + "_plain"]
                    r["library_ms"] += times[kern + "_library"]
                    r["bound_ms"] += bounds[kern][0]
                    r["bound_by"] = bounds[kern][1]
            del q, k, v, leaves, lib_out, lib_dout
            torch.cuda.empty_cache()
    return result


def run_main_path(torch, model_dir):
    _phase("main path")
    from compare_gan_torch import core, main
    from compare_gan_torch.ops import fused_attention as fa
    argv = [
        f"--model_dir={model_dir}", "--schedule=train", "--device=cuda",
        "--data_fake_dataset",
        f"--gin_config={os.path.join(ROOT, 'example_configs', 'biggan_imagenet128.gin')}",
        "--gin_bindings=options.batch_size = 16",
        f"--gin_bindings=options.training_steps = {STEPS}",
        "--gin_bindings=run_config.iterations_per_loop = 1",
        f"--gin_bindings=run_config.save_checkpoints_steps = {STEPS}",
        "--gin_bindings=ModularGAN.compute_dtype = 'bfloat16'",
        "--gin_bindings=ModularGAN.experimental_joint_gen_for_disc = True",
        "--gin_bindings=ModularGAN.experimental_fake_only_g_loss = True",
    ]
    torch.cuda.reset_peak_memory_stats()
    fa.launches_fwd = fa.launches_bwd = 0
    report = main.main(argv)
    launches = {"fwd": fa.launches_fwd, "bwd": fa.launches_bwd}
    torch.cuda.synchronize()

    ts = report.state
    g_count = core.count_params(ts.generator)
    d_count = core.count_params(ts.discriminator)
    print(f"params G {g_count:,} D {d_count:,}")
    if (g_count, d_count) != (G_PARAMS, D_PARAMS):
        raise AssertionError(f"parameter counts {g_count}, {d_count} != "
                             f"{G_PARAMS}, {D_PARAMS}")
    for step, losses in zip(report.steps, report.metrics):
        print(f"step {step} " + " ".join(
            f"{k}={v:.6f}" for k, v in sorted(losses.items())))
        if not all(v == v and abs(v) != float("inf")
                   for v in losses.values()):
            raise AssertionError(f"non-finite losses at step {step}")
    if report.steps != list(range(1, STEPS + 1)) or ts.step != STEPS:
        raise AssertionError(f"trained steps {report.steps}, not {STEPS}")
    for name in (f"model.ckpt-{STEPS}.npz", "TRAIN_DONE"):
        if not os.path.exists(os.path.join(model_dir, name)):
            raise AssertionError(f"{name} was not written")
    # Per step: the joint G forward (1 fwd); two D sub-steps on
    # concat(real, fake) (1 fwd + 1 bwd each); the G sub-step's G and D
    # forwards and their backward (2 fwd + 2 bwd).
    expected = {"fwd": 5 * STEPS, "bwd": 4 * STEPS}
    print(f"kernel launches {launches} (expected {expected})")
    if launches != expected:
        raise AssertionError(f"kernel launches {launches} != {expected}")
    per_step = report.seconds_per_step[1:]
    print("seconds_per_step_after_first " + " ".join(
        f"{s:.4f}" for s in per_step)
        + f" (first {report.seconds_per_step[0]:.3f})")
    print(f"peak_memory_allocated_GiB "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f}")

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


def main():
    if not os.path.isdir(os.path.join(ROOT, "compare_gan_torch")):
        raise SystemExit("chip_smoke: run from a checkout of the repository "
                         "(compare_gan_torch/ is missing).")
    sys.path.insert(0, ROOT)
    import torch

    check_device(torch)
    build_kernels()
    kernels = compare_kernels(torch)
    model_dir = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        launches = run_main_path(torch, model_dir)
    finally:
        shutil.rmtree(model_dir, ignore_errors=True)

    source = "compare_gan_torch/csrc/attention.cu"
    replaces = {"fwd": "compare_gan_tpu/ops/pallas_attention.py:90",
                "bwd": "compare_gan_tpu/ops/pallas_attention.py:146"}
    print(json.dumps({"kernels": [
        {"name": f"attention_{k}", "route": "cuda", "source": source,
         "replaces": replaces[k], "launches": launches[k],
         **kernels[k]} for k in ("fwd", "bwd")]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
