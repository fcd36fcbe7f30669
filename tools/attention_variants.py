#!/usr/bin/env python3
"""Where the attention kernels' time goes: time variants of
compare_gan_torch/csrc/attention.cu with one part of the work removed.

    python3 tools/attention_variants.py

Each variant is the source with named text substitutions (the results are
wrong; only the times count): no_stage (no key/row tiles are copied into
shared memory), no_exp (ex2 replaced by its argument), no_pv (the forward's
O += P.g and the column pass's dg += P^T.dout products dropped), no_sync
(no cp.async wait, proxy fence or barrier around a tile); and one that
keeps the work, bf16_bwd_uncapped (the bf16 backward at Cg > 96 without
the 128-register cap of `min_blocks`). nvcc builds all
variants at once into compare_gan_torch/_build/variants/; each is loaded
with ctypes in place of the port's library, and the bf16 forward, row pass
and column pass are timed at the two main-path shapes (batch 32), at
S3GAN's D batch of 38 and at BigGAN-deep's C = 32, Cg = 128 with
torch.profiler's device times. Prints one line per variant and shape.
Needs a CUDA card.
"""

import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = {"G_B4": (32, 4096, 1024, 24, 96), "D_B1": (32, 4096, 1024, 12, 48),
          "D_B1_s3gan": (38, 4096, 1024, 12, 48),
          "deep_B8_B2": (32, 4096, 1024, 32, 128)}

SUBSTITUTIONS = {
    "no_stage": [(
        "  auto issue = [&](int j, int buf) {\n",
        "  auto issue = [&](int j, int buf) {\n    return;\n", 3)],
    "no_exp": [(
        "        s[nt][e] = ex2(fmaf(s[nt][e], kLog2e, nb[e >> 1]));",
        "        s[nt][e] = fmaf(s[nt][e], kLog2e, nb[e >> 1]);", 1), (
        "ex2(fmaf(s[nt][e], kLog2e, nb[e >> 1])) * inv[e >> 1]",
        "fmaf(s[nt][e], kLog2e, nb[e >> 1]) * inv[e >> 1]", 1), (
        "ok ? ex2(fmaf(s[nt][e], kLog2e, nb)) * inv : 0.f;",
        "ok ? fmaf(s[nt][e], kLog2e, nb) * inv : 0.f;", 1)],
    "no_pv": [(
        "      wgmma_acc<kSplit, GP, 1>(&o[0][0], pa[kk],",
        "      if (kk < 0) wgmma_acc<kSplit, GP, 1>(&o[0][0], pa[kk],", 1), (
        """        mma<true, kSplit>(dgv[2 * np], pa, b0);
        mma<true, kSplit>(dgv[2 * np + 1], pa, b1);""",
        """        dgv[2 * np][0] += __uint_as_float(b0.h[0] ^ pa.h[0]);
        dgv[2 * np + 1][0] += __uint_as_float(b1.h[1] ^ pa.l[3]);""", 1)],
    # Not a removal: the bf16 backward at Cg > 96 (BigGAN-deep's
    # <32, 128>) without the 128-register cap, as the f32 backward at
    # Cg > 48 already runs.
    "bf16_bwd_uncapped": [(
        "  return split && backward && GP > 48 ? 1 : 2;",
        "  return backward && GP > (split ? 48 : 96) ? 1 : 2;", 1)],
    "no_sync": [(
        """      cp_async_wait<1>();
      fence_proxy_async();
      __syncthreads();
      body(j, j & 1);
      __syncthreads();  // buffer j & 1 is refilled at iteration j + 1""",
        "      body(j, j & 1);", 1)],
}


def _variant_source(text, subs):
    for old, new, count in subs:
        if text.count(old) != count:
            raise RuntimeError(f"substitution no longer applies ({count} "
                               f"expected, {text.count(old)} found):\n{old}")
        text = text.replace(old, new)
    return text


def _load(path):
    lib = ctypes.CDLL(path)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.cgt_attention_fwd.argtypes = [ptr] * 6 + [i32] * 6 + [ptr]
    lib.cgt_attention_fwd.restype = i32
    lib.cgt_attention_bwd.argtypes = [ptr] * 10 + [i32] * 6 + [ptr]
    lib.cgt_attention_bwd.restype = i32
    lib.cgt_error_string.argtypes = [i32]
    lib.cgt_error_string.restype = ctypes.c_char_p
    return lib


def main():
    sys.path.insert(0, ROOT)
    import torch
    from torch.profiler import ProfilerActivity, profile
    if not torch.cuda.is_available():
        raise SystemExit("attention_variants: no CUDA device.")
    from compare_gan_torch.ops import _build
    from compare_gan_torch.ops import fused_attention as fa

    with open(os.path.join(_build.SRC_DIR, "attention.cu")) as f:
        base = f.read()
    out_dir = os.path.join(_build.BUILD_DIR, "variants")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, subs in [("base", [])] + list(SUBSTITUTIONS.items()):
        src = os.path.join(out_dir, f"{name}.cu")
        with open(src, "w") as f:
            f.write(_variant_source(base, subs))
        lib = os.path.join(out_dir, f"{name}.so")
        procs[name] = (lib, subprocess.Popen(
            [_build.nvcc_path(), *_build.FLAGS, "-o", lib, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        libs[name] = _load(lib)

    print(torch.cuda.get_device_name(0))
    dev = torch.device("cuda")
    for shape, (b, n, m, c, cg) in SHAPES.items():
        gen = torch.Generator(device=dev).manual_seed(0)
        theta = (torch.randn(b, n, c, device=dev, generator=gen)
                 * c ** -0.25).bfloat16()
        phi = (torch.randn(b, m, c, device=dev, generator=gen)
               * c ** -0.25).bfloat16()
        g = torch.randn(b, m, cg, device=dev, generator=gen).bfloat16()
        dout = torch.randn(b, n, cg, device=dev, generator=gen).bfloat16()
        _, mx, den = fa.attention_fwd_plain(theta, phi, g)
        for name, lib in libs.items():
            _build._lib = lib
            for _ in range(3):  # warm-up
                fa.attention_fwd(theta, phi, g)
                fa.attention_bwd(theta, phi, g, dout, mx, den)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(10):
                    fa.attention_fwd(theta, phi, g)
                    fa.attention_bwd(theta, phi, g, dout, mx, den)
                torch.cuda.synchronize()
            us = {}
            for a in prof.key_averages():
                for kern in ("fwd", "rows", "cols"):
                    if f"attention_{'bwd_' if kern != 'fwd' else ''}{kern}" \
                            in a.key:
                        us[kern] = a.device_time_total / a.count
            print(f"{shape} {name:9s} fwd {us['fwd']:8.1f} us  rows "
                  f"{us['rows']:8.1f} us  cols {us['cols']:8.1f} us",
                  flush=True)
    _build._lib = None


if __name__ == "__main__":
    main()
