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


def test_data_parallel_phase_sorts_every_state_entry_into_a_kind():
    """The two-worker check holds every checkpoint entry of a BigGAN
    TrainState (tiny width here) to one of DP_TOL's state kinds. A state
    against itself, or with every parameter moved by one f32 rounding,
    passes; one Adam first moment halved (a gradient not summed over two
    workers) or one parameter moved by 1e-4 (a step at G's rate) fails
    its kind."""
    from compare_gan_torch import checkpoint
    from compare_gan_torch import config as tgin
    from compare_gan_torch import datasets, gans, runner_lib
    del gans
    tgin.clear_config()
    try:
        tgin.parse_config_files_and_bindings(
            [os.path.join(REPO, "example_configs", "biggan_imagenet128.gin")],
            ["resnet_biggan.Generator.ch = 16",
             "resnet_biggan.Discriminator.ch = 16",
             "options.batch_size = 2"])
        datasets.set_fake_dataset(True)
        options = runner_lib.get_options_dict()
        gan = options["gan_class"](dataset=datasets.get_dataset(),
                                   parameters=options, model_dir="unused",
                                   device="cpu")
        ts = gan.init_state(seed=0)
        init = {k: v.clone() for k, v in checkpoint.live_tensors(ts).items()
                if chip_smoke._state_kind(k) in ("params", "ema")}
        ts, _ = gan.make_train_step(2)(ts, next(gan.input_batches(2)))
        keys = checkpoint.live_tensors(ts)
    finally:
        datasets.set_fake_dataset(False)
        tgin.clear_config()
    kinds = {chip_smoke._state_kind(k) for k in keys}
    assert kinds == set(chip_smoke.DP_TOL)
    assert all(g["ratio"] == 0 for g in
               chip_smoke._state_gaps(keys, keys, init).values())
    rounded = {k: (v * (1 + 2 ** -24) if chip_smoke._state_kind(k)
                   == "params" else v) for k, v in keys.items()}
    assert all(g["ratio"] <= 1 for g in
               chip_smoke._state_gaps(rounded, keys, init).values())
    mu = next(k for k in keys if chip_smoke._state_kind(k) == "adam_mu"
              and "kernel" in k)
    param = next(k for k in keys if chip_smoke._state_kind(k) == "params")
    broken = dict(keys, **{mu: keys[mu] / 2, param: keys[param] + 1e-4})
    gaps = chip_smoke._state_gaps(broken, keys, init)
    assert [k for k, g in gaps.items() if g["ratio"] > 1] == [
        "params", "adam_mu"]


def _main_function():
    import ast
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    return next(node for node in tree.body
                if isinstance(node, ast.FunctionDef) and node.name == "main")


def test_serving_phase_runs_after_the_eval_inside_the_model_dir():
    """main() times the serving phase on the BigGAN-128 model_dir right
    after its eval (which writes the accumulator-filled checkpoint the
    phase serves) and before the model_dir is removed; its launches join
    the kernels line."""
    import ast
    main = _main_function()
    block = next(node for node in main.body if isinstance(node, ast.Try))
    phases = [call.args[0].value for call in ast.walk(ast.Module(
        body=block.body, type_ignores=[])) if isinstance(call, ast.Call)
        and getattr(call.func, "id", None) == "timed"]
    assert phases[:3] == ["train", "eval", "serving"]
    serving = next(call for call in ast.walk(ast.Module(
        body=block.body, type_ignores=[])) if isinstance(call, ast.Call)
        and getattr(call.func, "id", None) == "timed"
        and call.args[0].value == "serving")
    assert [ast.unparse(a) for a in serving.args[1:]] == [
        "run_serving", "torch", "biggan"]
    assert "shutil.rmtree(model_dir" in ast.unparse(block.finalbody[0])
    assert chip_smoke.SERVING_MODEL_MODULES == (
        "compare_gan_torch.architectures", "compare_gan_torch.gans",
        "compare_gan_torch.config")
    assert chip_smoke.SERVING_BYTES_RATIO == 1.25


def test_the_last_two_lines_are_the_kernels_and_the_device():
    """main() ends by printing the kernels line (its two entries, every
    key of the contract) and then {"ok": true, "device": {...}}."""
    import ast
    main = _main_function()
    prints = [node.value for node in main.body
              if isinstance(node, ast.Expr) and isinstance(node.value,
                                                           ast.Call)
              and getattr(node.value.func, "id", None) == "print"]
    kernels, ok = (ast.unparse(p) for p in prints[-2:])
    assert kernels.startswith("print(json.dumps({'kernels': [")
    for key in ("name", "route", "source", "replaces", "launches"):
        assert f"'{key}'" in kernels
    assert "for k in ('fwd', 'bwd')" in kernels
    assert ok == ("print(json.dumps({'ok': True, 'device': {'platform': "
                  "'gpu', 'kind': torch.cuda.get_device_name(0), 'count': "
                  "torch.cuda.device_count()}}))")


@pytest.mark.parametrize("config,launches,shape", [
    ("biggan128_polygons_multiclass.gin", "CONV_BIGGAN_LAUNCHES",
     "G_B4_b16"),
    ("s3gan32_polygons_partial_oriented.gin", "CONV_S3GAN_LAUNCHES",
     "D_B1_s3gan32")])
def test_convergence_phase_launches_are_those_of_the_configs(
        tmp_path, monkeypatch, config, launches, shape):
    """The "convergence tools" phase holds each run to an exact launch
    count a step, and the kernels phase times the shapes those runs give
    the kernels. Counted here on the CPU (the plain attention stands in
    for the kernels) at ch 16 over two steps of each published config:
    calls a step, calls that will be differentiated, and the batch of the
    convergence shape among the calls' batches."""
    from compare_gan_torch import config as tgin
    from compare_gan_torch import datasets, main, polygons
    from compare_gan_torch.ops import fused_attention
    data_dir = str(tmp_path / "data")
    polygons.write_multiclass128_npz_dataset(data_dir, n_train=16,
                                             n_test=4, n_holdout=4)
    polygons.write_partial_oriented_npz_dataset(data_dir, n_train=256,
                                                n_test=4, n_holdout=4)
    monkeypatch.setattr(datasets, "DATA_DIR", data_dir)
    calls = []
    plain = fused_attention.reference_attention

    def counted(theta, phi, g):
        out = plain(theta, phi, g)
        calls.append((theta.shape[0], out.requires_grad))
        return out

    monkeypatch.setattr(fused_attention, "reference_attention", counted)
    tgin.clear_config()
    main.main([f"--model_dir={tmp_path / 'run'}", "--device=cpu",
               f"--gin_config={os.path.join(REPO, 'example_configs', config)}",
               "--gin_bindings=options.training_steps = 2",
               "--gin_bindings=run_config.iterations_per_loop = 1",
               "--gin_bindings=resnet_biggan.Generator.ch = 16",
               "--gin_bindings=resnet_biggan.Discriminator.ch = 16"])
    tgin.clear_config()
    per_step = {"fwd": len(calls) // 2,
                "bwd": sum(grad for _, grad in calls) // 2}
    assert per_step == getattr(chip_smoke, launches)
    batch = dict(chip_smoke.CONVERGENCE_SHAPES)[shape][0]
    assert batch in {b for b, _ in calls}


def test_spatial_shapes_are_the_main_path_shapes_in_two_bands():
    """Each worker of the spatial phase's `1 x 2` grid holds 32 of the 64
    rows of the 64x64 map: half the queries, all the pooled keys."""
    for (name, band), (whole_name, whole) in zip(chip_smoke.SPATIAL_SHAPES,
                                                 chip_smoke.SHAPES.items()):
        assert name == whole_name + "_band"
        b, n, m, c, cg = whole
        assert band == (b, n // 2, m, c, cg) == (32, 2048, 1024, c, cg)


def test_spatial_controls_patch_the_collectives_and_restore_them():
    import torch
    from compare_gan_torch.parallel import mesh_utils, tpu_ops
    right = (tpu_ops.exchange_halos, tpu_ops.model_sum, tpu_ops.loss_shares)
    grid = mesh_utils.Replicas(rank=3, world=4, model_size=2)
    with chip_smoke.spatial_control("no_halo"):
        x = torch.ones(1, 2, 3, 1)
        padded = tpu_ops.exchange_halos(x, 1, 2)
        assert padded.shape == (1, 5, 3, 1)
        assert padded.sum() == x.sum()  # Zero rows, not a neighbour's.
        assert tpu_ops.loss_shares(grid) == 4
    with chip_smoke.spatial_control("k_times"):
        assert tpu_ops.loss_shares(grid) == 2  # The data ranks only.
        assert tpu_ops.model_sum is not right[1]
    assert (tpu_ops.exchange_halos, tpu_ops.model_sum,
            tpu_ops.loss_shares) == right
