"""chip_smoke.py off the card: its bounds are the hand count of the kernels'
work, and without a CUDA device, or outside a checkout, it fails and prints
no result."""

import json
import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402


@pytest.mark.parametrize("shape,fwd_us,bwd_us", [
    # 2*B*N*M*(C + Cg) and 2*B*N*M*(3C + 2Cg) flops at 989 TFLOP/s.
    ((32, 4096, 1024, 24, 96), 32.57, 71.66),
    ((32, 4096, 1024, 12, 48), 16.28, 35.83),
    ((38, 4096, 1024, 12, 48), 19.34, 42.55),
])
def test_bf16_bounds_are_the_flop_count(shape, fwd_us, bwd_us):
    bounds = chip_smoke.bounds_ms(shape, "bfloat16")
    assert bounds["fwd"][1] == bounds["bwd"][1] == "operations"
    assert abs(1e3 * bounds["fwd"][0] - fwd_us) < 0.01
    assert abs(1e3 * bounds["bwd"][0] - bwd_us) < 0.01


def test_s3gan_shape_is_the_d_batch_of_the_s3gan_phase():
    """At 16 per sub-step with rotated_batch_fraction 4, S3GAN's D sees 16
    real, 3 rotations of 1 real, 16 fake and 3 rotations of 1 fake: 38
    rows, at D B1's widths. The phase pins the counts of
    tests/test_torch_resnet_cifar.py."""
    assert chip_smoke.S3GAN_SHAPE == ("D_B1_s3gan", (38, 4096, 1024, 12, 48))
    assert chip_smoke.S3GAN_SHAPE[1][1:] == chip_smoke.SHAPES["D_B1"][1:]
    assert chip_smoke.S3GAN_PARAMS == (70433988, 89525518)
    assert chip_smoke.SSGAN_PARAMS == (5849603, 1483653)
    cases = [(name, dtype, bwd, summed) for name, _, dtype, bwd, summed
             in chip_smoke._cases() if name == "D_B1_s3gan"]
    assert cases == [("D_B1_s3gan", "float32", True, False),
                     ("D_B1_s3gan", "bfloat16", True, False)]


def test_study_zoo_phase_runs_the_published_configs():
    """The study zoo phase trains three example configs as they are and
    pins the JAX package's parameter counts
    (tests/test_torch_study_archs.py)."""
    assert chip_smoke.STUDY_ZOO == {
        "resnet5_wgangp": ("resnet_lsun-bedroom128.gin",
                           (13786115, 15086529)),
        "sndcgan": ("sndcgan_celebahq128.gin", (19926019, 5983745)),
        "dcgan": ("dcgan_celeba64.gin", (5364739, 4314753))}
    for config, _ in chip_smoke.STUDY_ZOO.values():
        assert os.path.exists(os.path.join(REPO, "example_configs", config))
    assert chip_smoke.GRAD_TOL == 1e-3


def test_f32_bound_takes_the_tf32_tensor_core_rate():
    """The eval shape (G after B4 at batch 64, f32): 2*B*N*M*(C + Cg)
    flops at 495 TFLOP/s."""
    ms, by = chip_smoke.bounds_ms((64, 4096, 1024, 24, 96), "float32")["fwd"]
    assert by == "operations" and abs(1e3 * ms - 130.15) < 0.01


@pytest.mark.parametrize("shape,dtype_name,us", [
    # f32: 2*B*N*M*(4*CP + 2*GP) at 989 TFLOP/s (CP, GP = 32, 96 for G;
    # 16, 48 for D); bf16: 2*B*N*M*(CP + GP).
    ((64, 4096, 1024, 24, 96), "float32", 173.71),
    ((32, 4096, 1024, 12, 48), "float32", 43.43),
    ((32, 4096, 1024, 12, 48), "bfloat16", 17.37),
])
def test_issued_mma_floor_counts_the_split_and_the_padding(shape, dtype_name,
                                                           us):
    assert abs(1e3 * chip_smoke.issued_fwd_ms(shape, dtype_name) - us) < 0.01


def test_a_memory_bound_shape_is_bound_by_bytes():
    """With one key the work is a copy: bytes over 3.35 TB/s."""
    b, n, m, c, cg = 4, 8192, 1, 32, 128
    ms, by = chip_smoke.bounds_ms((b, n, m, c, cg), "float32")["fwd"]
    nbytes = 4 * (b * n * c + b * m * (c + cg) + b * n * cg) + 8 * b * n
    assert by == "bytes" and abs(ms - 1e3 * nbytes / 3.35e12) < 1e-9


def _run(script, cwd):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def _printed_a_result(stdout):
    for line in stdout.splitlines():
        try:
            if isinstance(json.loads(line), dict):
                return True
        except ValueError:
            continue
    return False


def test_fails_without_a_card_and_outside_a_checkout(tmp_path):
    out = _run(os.path.join(REPO, "chip_smoke.py"), REPO)
    assert out.returncode != 0 and not _printed_a_result(out.stdout)
    assert "no CUDA device" in out.stderr
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), alone)
    out = _run(str(alone), tmp_path)
    assert out.returncode != 0 and not _printed_a_result(out.stdout)
    assert "compare_gan_torch/ is missing" in out.stderr


@pytest.mark.parametrize("shape,dtype_name,kern,us", [
    # BigGAN-deep-128 at ch 128: C = 32, Cg = 128. 2*B*N*M*(C + Cg) and
    # 2*B*N*M*(3C + 2Cg) flops at 989 (bf16) or 495 (TF32) TFLOP/s.
    ((32, 4096, 1024, 32, 128), "bfloat16", "fwd", 43.43),
    ((32, 4096, 1024, 32, 128), "bfloat16", "bwd", 95.54),
    ((32, 4096, 1024, 32, 128), "float32", "fwd", 86.77),
    ((32, 4096, 1024, 32, 128), "float32", "bwd", 190.89),
    ((64, 4096, 1024, 32, 128), "float32", "fwd", 173.53),
])
def test_biggan_deep_bounds(shape, dtype_name, kern, us):
    ms, by = chip_smoke.bounds_ms(shape, dtype_name)[kern]
    assert by == "operations" and abs(1e3 * ms - us) < 0.01


def test_biggan_deep_phases_run_the_published_shape_and_tasks():
    """G after B8 and D after B2 of BigGAN-deep-128 share one shape; the
    kernels phase holds it in both types forward and backward, and the
    eval forward at batch 64 in f32. The eval phases name task classes
    that the port registers."""
    from compare_gan_torch import config as tgin
    from compare_gan_torch import runner_lib
    assert chip_smoke.DEEP_SHAPE == ("deep_B8_B2", (32, 4096, 1024, 32, 128))
    assert chip_smoke.DEEP_EVAL_SHAPE[1] == (64, 4096, 1024, 32, 128)
    assert chip_smoke.DEEP_PARAMS == (50244484, 34590210)
    cases = [(name, dtype, bwd) for name, _, dtype, bwd, _
             in chip_smoke._cases() if name.startswith("deep_")]
    assert cases == [("deep_B8_B2", "float32", True),
                     ("deep_B8_B2", "bfloat16", True),
                     ("deep_G_B8_eval", "float32", False)]
    runner_lib._import_eval_task_modules()
    tasks = chip_smoke.SESSION_TASKS + chip_smoke.GAN_TASKS
    assert len(set(tasks)) == 9
    for name in tasks:
        assert tgin.get_configurable(name)().metric_list()


def test_biggan_deep_shape_line_parses():
    """The `biggan_deep_shape` line is its tag and one JSON object: the
    tolerances, the SDPA backend, each kernel's times, bound and share."""
    shape = (32, 4096, 1024, 32, 128)
    bounds = chip_smoke.bounds_ms(shape, "bfloat16")
    rows = {kern: {"name": f"attention_{kern}", "max_abs_err": 1e-3,
                   "ms": 2 * bounds[kern][0], "plain_ms": 1.0,
                   "library_ms": 0.5, "bound_ms": bounds[kern][0],
                   "bound_by": bounds[kern][1]} for kern in ("fwd", "bwd")}
    row = chip_smoke.deep_shape_row("deep_B8_B2", 32, "bfloat16", "cudnn",
                                    rows, 0.05)
    line = "biggan_deep_shape " + json.dumps(row)
    tag, text = line.split(" ", 1)
    parsed = json.loads(text)
    assert tag == "biggan_deep_shape"
    assert parsed["tol"] == 2e-2 and parsed["mx_den_tol"] == 1e-4
    assert parsed["sdpa_backend"] == "cudnn"
    for kern in ("fwd", "bwd"):
        assert parsed[kern]["share"] == pytest.approx(0.5)
        assert parsed[kern]["bound_by"] == "operations"
        assert {"ms", "plain_ms", "library_ms", "bound_ms",
                "max_abs_err"} <= set(parsed[kern])


def test_ptxas_report_names_each_kernel_and_its_spills():
    log = (
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_125"
        "attention_bwd_cols_kernelI13__nv_bfloat16Li32ELi128EEEvPKT_' for "
        "'sm_90a'\n"
        "ptxas info    : Function properties for _ZN46_GLOBAL__N__"
        "attention_cu_d52b45ab25attention_bwd_cols_kernelI13__nv_bfloat16"
        "Li32ELi128EEEvPKT_\n"
        "    240 bytes stack frame, 644 bytes spill stores, 732 bytes spill "
        "loads\n"
        "ptxas info    : Used 128 registers, used 1 barriers, 240 bytes "
        "cumulative stack size, 46592 bytes smem\n"
        "ptxas info    : Function properties for _ZN12_GLOBAL__N_120"
        "attention_fwd_kernelIfLi16ELi48EEEvPKT_\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 113 registers, used 1 barriers, 16384 bytes "
        "smem\n")
    assert chip_smoke.ptxas_report(log) == [
        ("attention_bwd_cols_kernel<bf16, 32, 128>", 128, 644, 732),
        ("attention_fwd_kernel<f32, 16, 48>", 113, 0, 0)]
