#!/usr/bin/env python3
"""Where the attention kernels' time goes: time variants of
compare_gan_torch/csrc/attention.cu with one part of the work removed.

    python3 tools/attention_variants.py [SHAPE ...]

Each variant is the source with named text substitutions (the results are
wrong; only the times count): no_stage (no key/row tiles are copied into
shared memory: the forward's cp.async and the backward producer's TMA,
cp.async or plain fills), no_exp (ex2 replaced by its argument), no_pv
(the forward's O += P.g and the column pass's dg += P^T.dout products
dropped), no_scores (the backward's score products S and dP dropped),
no_second (its products of dtheta's terms and of dphi dropped), no_sync
(the forward's cp.async wait, proxy fence and barriers around a tile
dropped; the backward keeps its waits, without which its producer would
overrun the phases of the ring's barriers). nvcc builds all variants at
once (`_build.compile_library`) into compare_gan_torch/_build/variants/;
each is loaded with ctypes in place of the port's library, and the
forward, row pass and column pass are timed in bf16 and f32 at the two
main-path shapes (batch 32), at S3GAN's D batch of 38, at
BigGAN-deep-128's C = 32, Cg = 128 and at the 512 px models' (48, 192)
and (64, 256) (two column chunks each) with torch.profiler's device times
(only the SHAPEs named, if any). Prints one line per variant, shape and
type. Needs a CUDA card.
"""

import concurrent.futures
import ctypes
import itertools
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = {"G_B4": (32, 4096, 1024, 24, 96), "D_B1": (32, 4096, 1024, 12, 48),
          "D_B1_s3gan": (38, 4096, 1024, 12, 48),
          "deep_B8_B2": (32, 4096, 1024, 32, 128),
          "G_B4_512": (32, 4096, 1024, 48, 192),
          "deep512": (32, 4096, 1024, 64, 256)}

SUBSTITUTIONS = {
    "no_stage": [(
        "  auto issue = [&](int j, int buf) {\n",
        "  auto issue = [&](int j, int buf) {\n    return;\n", 1), (
        "    auto fill = [&](int j, int s) {\n",
        "    auto fill = [&](int j, int s) {\n      return;\n", 2)],
    "no_exp": [(
        "      s[nt][e] = ex2(fmaf(s[nt][e], kLog2e, nb[e >> 1]));",
        "      s[nt][e] = fmaf(s[nt][e], kLog2e, nb[e >> 1]);", 1), (
        "        const float p = ex2(fmaf(sc[nt][e], kLog2e, nb[e >> 1]));",
        "        const float p = fmaf(sc[nt][e], kLog2e, nb[e >> 1]);", 1), (
        "          const float p = ex2(fmaf(sc[nt][e], kLog2e, bv));",
        "          const float p = fmaf(sc[nt][e], kLog2e, bv);", 1)],
    "no_pv": [(
        "    wgmma_acc<kSplit, kSplit, GP, 1>(\n        &o[0][0], pa[kk],",
        "    if (kk < 0) wgmma_acc<kSplit, kSplit, GP, 1>(\n"
        "        &o[0][0], pa[kk],", 1), (
        "      wgmma_acc<kSplit, kSplit, GP, 1>(&dgv[0][0], pa[kk],",
        "      if (kk < 0) wgmma_acc<kSplit, kSplit, GP, 1>(&dgv[0][0], "
        "pa[kk],",
        1)],
    # The backward's score products S, dP (S^T, dP^T in the column pass)
    # dropped, and its products of the rows' (keys') own outputs:
    # (P*dP).phi and P.phi in the row pass, dS^T.theta in the column pass.
    "no_scores": [(
        "      wgmma_ss<kSplit>(&sc[0][0], ",
        "      if (kc < 0) wgmma_ss<kSplit>(&sc[0][0], ", 2), (
        "      wgmma_ss<kSplit>(&dp[0][0], ",
        "      if (kc < 0) wgmma_ss<kSplit>(&dp[0][0], ", 2)],
    "no_second": [(
        "      wgmma_acc<true, kSplit, CP, 1>(",
        "      if (kk < 0) wgmma_acc<true, kSplit, CP, 1>(", 3)],
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




def main():
    sys.path.insert(0, ROOT)
    import torch
    from torch.profiler import ProfilerActivity, profile
    if not torch.cuda.is_available():
        raise SystemExit("attention_variants: no CUDA device.")
    from compare_gan_torch.ops import _build
    from compare_gan_torch.ops import fused_attention as fa

    with open(_build.SOURCE) as f:
        base = f.read()
    out_dir = os.path.join(_build.BUILD_DIR, "variants")
    os.makedirs(out_dir, exist_ok=True)
    paths = {}
    for name, subs in [("base", [])] + list(SUBSTITUTIONS.items()):
        src = os.path.join(out_dir, f"{name}.cu")
        with open(src, "w") as f:
            f.write(_variant_source(base, subs))
        paths[name] = (src, os.path.join(out_dir, f"{name}.so"))
    # Every variant's build (one nvcc per object of each) at once.
    with concurrent.futures.ThreadPoolExecutor(len(paths)) as pool:
        for _ in pool.map(lambda p: _build.compile_library(*p),
                          paths.values()):
            pass
    libs = {name: _build.bind(ctypes.CDLL(lib))
            for name, (_, lib) in paths.items()}

    print(torch.cuda.get_device_name(0))
    dev = torch.device("cuda")
    shapes = {k: v for k, v in SHAPES.items()
              if k in sys.argv[1:] or len(sys.argv) == 1}
    for (shape, (b, n, m, c, cg)), dtype in itertools.product(
            shapes.items(), (torch.bfloat16, torch.float32)):
        gen = torch.Generator(device=dev).manual_seed(0)
        theta = (torch.randn(b, n, c, device=dev, generator=gen)
                 * c ** -0.25).to(dtype)
        phi = (torch.randn(b, m, c, device=dev, generator=gen)
               * c ** -0.25).to(dtype)
        g = torch.randn(b, m, cg, device=dev, generator=gen).to(dtype)
        dout = torch.randn(b, n, cg, device=dev, generator=gen).to(dtype)
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
            print(f"{shape} {str(dtype)[6:]} {name:9s} fwd {us['fwd']:8.1f} us"
                  f"  rows "
                  f"{us['rows']:8.1f} us  cols {us['cols']:8.1f} us",
                  flush=True)
    _build._lib = None


if __name__ == "__main__":
    main()
