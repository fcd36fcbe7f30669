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
