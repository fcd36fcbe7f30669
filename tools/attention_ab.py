#!/usr/bin/env python3
"""Time the attention kernels of the checkout this runs from, to compare two
checkouts on one card.

    python3 tools/attention_ab.py LABEL

Builds the checkout's kernels (compare_gan_torch/_build/) and times the
forward and the backward (CUDA events, 50 calls after a warm-up) at the
main-path shapes (BigGAN-128's G after B4 and D after B1, batch 32), at
S3GAN's D batch of 38 and at the 512 px models' (48, 192) and (64, 256),
in bf16 and f32, on the inputs chip_smoke.py draws. Prints one JSON line,
LABEL then {"shape dtype": [forward ms, backward ms], ...}. Run it in each
checkout in turns (A, B, B, A) within one call: two calls may land on two
cards. Needs a CUDA card.
"""

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = (("G_B4", (32, 4096, 1024, 24, 96)),
          ("D_B1", (32, 4096, 1024, 12, 48)),
          ("D_B1_s3gan", (38, 4096, 1024, 12, 48)),
          ("deep512_G_D", (32, 4096, 1024, 64, 256)),
          ("G_B4_512", (32, 4096, 1024, 48, 192)))


def main(label):
    sys.path.insert(0, ROOT)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("attention_ab: no CUDA device.")
    import chip_smoke
    from compare_gan_torch.ops import fused_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    out = {}
    for name, (b, n, m, c, cg) in SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            gen = torch.Generator(device=dev).manual_seed(0)
            theta, phi = ((torch.randn(b, rows, c, device=dev, generator=gen)
                           * c ** -0.25).to(dtype) for rows in (n, m))
            g = torch.randn(b, m, cg, device=dev, generator=gen).to(dtype)
            dout = torch.randn(b, n, cg, device=dev, generator=gen).to(dtype)
            _, mx, den = fa.attention_fwd(theta, phi, g)
            fwd = chip_smoke._time_ms(
                torch, lambda: fa.attention_fwd(theta, phi, g), iters=50)
            bwd = chip_smoke._time_ms(
                torch, lambda: fa.attention_bwd(theta, phi, g, dout, mx, den),
                iters=50)
            out[f"{name} {str(dtype).split('.')[-1]}"] = [round(fwd, 4),
                                                          round(bwd, 4)]
    print(label, json.dumps(out), flush=True)


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "run")
