#!/usr/bin/env python3
"""Profile one of the port's train steps on one CUDA card.

    python3 tools/torch_profile_step.py
        [--config biggan|biggan_deep|s3gan|ssgan|resnet5|sndcgan|dcgan]
        [--warmup 3] [--steps 3] [--trace DIR]

Builds a training configuration as chip_smoke.py drives it, on fake data
with seed 547, from the port's own pieces (gin, datasets, the GAN class):

- `biggan` (default): example_configs/biggan_imagenet128.gin at full
  width, batch 16, bf16 activations, joint G forward, fake-only G loss;
- `biggan_deep`: the same with options.architecture =
  'resnet_biggan_deep_arch' and z_dim 128 (BigGAN-deep-128 at ch 128);
- `s3gan`: example_configs/s3gan32_polygons_partial.gin on ImageNet-128
  (BigGAN at ch 96), batch 16, bf16, joint G forward;
- `ssgan`: example_configs/ssgan32_polygons_oriented.gin on CIFAR-10
  (ResNet-CIFAR-32), batch 64, f32 with TF32 off, as the smoke runs it;
- `resnet5`, `sndcgan`, `dcgan`: the study zoo's
  resnet_lsun-bedroom128.gin (WGAN-GP), sndcgan_celebahq128.gin and
  dcgan_celeba64.gin as published, f32 with TF32 off, as the smoke runs
  them.

It runs warm-up steps, then:

1. times `--steps` steps on the host clock, ending in a synchronize;
2. traces as many steps with torch.profiler (CPU and CUDA activities) and
   prints the device's busy time per step (the union of the kernels' time
   intervals), its idle share of the traced wall time, the largest device
   items by op (`key_averages`, device time including children, so rows
   overlap where one op calls another) and by kernel (self time), the
   attention kernels' time per step and their launches, and the peak device
   memory.

`--trace DIR` also writes the Chrome trace there. Imports nothing of JAX.
"""

import argparse
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (gin file, bindings) of each configuration.
CONFIGS = {
    "biggan": ("biggan_imagenet128.gin", [
        "options.batch_size = 16",
        "ModularGAN.compute_dtype = 'bfloat16'",
        "ModularGAN.experimental_joint_gen_for_disc = True",
        "ModularGAN.experimental_fake_only_g_loss = True"]),
    "biggan_deep": ("biggan_imagenet128.gin", [
        "options.architecture = 'resnet_biggan_deep_arch'",
        "options.z_dim = 128",
        "options.batch_size = 16",
        "ModularGAN.compute_dtype = 'bfloat16'",
        "ModularGAN.experimental_joint_gen_for_disc = True",
        "ModularGAN.experimental_fake_only_g_loss = True"]),
    "s3gan": ("s3gan32_polygons_partial.gin", [
        "dataset.name = 'imagenet_128'",
        "options.batch_size = 16",
        "S3GAN.compute_dtype = 'bfloat16'",
        "S3GAN.experimental_joint_gen_for_disc = True"]),
    "ssgan": ("ssgan32_polygons_oriented.gin", [
        "dataset.name = 'cifar10'"]),
    "resnet5": ("resnet_lsun-bedroom128.gin", []),
    "sndcgan": ("sndcgan_celebahq128.gin", []),
    "dcgan": ("dcgan_celeba64.gin", []),
}


def _build(torch, model_dir, config):
    from compare_gan_torch import config as gin
    from compare_gan_torch import datasets, runner_lib
    from compare_gan_torch import gans  # noqa: F401 (registers the GANs)
    datasets.set_fake_dataset(True)
    gin_file, bindings = CONFIGS[config]
    gin.parse_config_files_and_bindings(
        [os.path.join(ROOT, "example_configs", gin_file)], bindings)
    options = runner_lib.get_options_dict()
    gan = options["gan_class"](dataset=datasets.get_dataset(seed=547),
                               parameters=options, model_dir=model_dir,
                               device=torch.device("cuda"))
    batch_size = options["batch_size"]
    return (gan.init_state(547), gan.make_train_step(batch_size),
            gan.input_batches(batch_size))


def _busy_ms(events):
    """Union of the CUDA kernels' [start, end) intervals, in ms."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, end = 0.0, None
    for s, e in spans:
        if end is None or s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy / 1e3


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--config", choices=sorted(CONFIGS), default="biggan")
    p.add_argument("--warmup", type=int, default=3)
    p.add_argument("--steps", type=int, default=3)
    p.add_argument("--trace", default=None)
    args = p.parse_args()
    sys.path.insert(0, ROOT)
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    if not torch.cuda.is_available():
        raise SystemExit("torch_profile_step: no CUDA device.")
    from compare_gan_torch.ops import fused_attention as fa
    # As chip_smoke.py: f32 convs and matmuls at full f32 precision.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    with tempfile.TemporaryDirectory() as model_dir:
        ts, step, batches = _build(torch, model_dir, args.config)
        for _ in range(args.warmup):
            ts, _ = step(ts, next(batches))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(args.steps):
            ts, _ = step(ts, next(batches))
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / args.steps

        torch.cuda.reset_peak_memory_stats()
        fa.launches_fwd = fa.launches_bwd = 0
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(args.steps):
                ts, _ = step(ts, next(batches))
            torch.cuda.synchronize()
            traced_wall = (time.perf_counter() - t0) / args.steps
        launches = (fa.launches_fwd, fa.launches_bwd)

    n = args.steps
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = _busy_ms(kernels) / n
    print(f"{args.config}: {torch.cuda.get_device_name(0)}")
    print(f"wall_s_per_step {wall:.4f} (untraced), traced "
          f"{traced_wall:.4f}")
    print(f"device_busy_ms_per_step {busy:.2f}; idle share of the traced "
          f"wall {100 * (1 - busy / (1e3 * traced_wall)):.1f}%")
    print(f"peak_memory_allocated_GiB "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f}")
    print(f"attention launches per step: fwd {launches[0] / n:g}, "
          f"bwd {launches[1] / n:g}")

    def dev_total(a):
        return getattr(a, "device_time_total", 0.0)

    print("top ops by device time per step (ms, calls per step; rows "
          "overlap):")
    ops = sorted(prof.key_averages(), key=dev_total, reverse=True)
    for a in ops[:15]:
        print(f"  {dev_total(a) / 1e3 / n:8.3f}  {a.count / n:7.1f}  "
              f"{a.key[:90]}")
    by_kernel = {}
    for e in kernels:
        t, c = by_kernel.get(e.name, (0.0, 0))
        by_kernel[e.name] = (t + e.time_range.elapsed_us(), c + 1)
    print("top kernels by self time per step (ms, launches per step):")
    for name, (t, c) in sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[
            :15]:
        print(f"  {t / 1e3 / n:8.3f}  {c / n:7.1f}  {name[:90]}")
    attn = sum(t for name, (t, _) in by_kernel.items() if "attention_" in
               name and "anonymous" in name)
    print(f"attention kernels ms per step: {attn / 1e3 / n:.3f}")
    if args.trace:
        os.makedirs(args.trace, exist_ok=True)
        prof.export_chrome_trace(os.path.join(args.trace, "step.json"))


if __name__ == "__main__":
    main()
