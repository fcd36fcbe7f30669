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


@pytest.mark.parametrize("shape,dtype_name,us", [
    # Per (row, key) and chunk, bf16: rows CP + GP + 2*2*CP, columns
    # CP + GP + 2*CP + GP; f32: rows 4*(CP + GP) + 2*4*CP, columns
    # 4*(CP + GP) + 4*CP + 4*GP; times 2*B*N*M*nz at 989 TFLOP/s.
    ((32, 4096, 1024, 24, 96), "bfloat16", 147.65),
    ((32, 4096, 1024, 12, 48), "bfloat16", 73.83),
    ((32, 4096, 1024, 24, 96), "float32", 486.39),
    # Two column chunks of 128, each recomputing S.
    ((32, 4096, 1024, 64, 256), "float32", 1528.64),
])
def test_backward_issued_mma_floor_counts_the_hi_lo_products(shape,
                                                             dtype_name, us):
    assert abs(1e3 * chip_smoke.issued_bwd_ms(shape, dtype_name) - us) < 0.01


@pytest.mark.parametrize("shape,us", [
    # 2*B*N*M*nz ex2 at 16 a clock on 132 SMs at 1.98 GHz.
    ((32, 4096, 1024, 24, 96), 64.19),
    ((32, 4096, 1024, 64, 256), 128.38),
])
def test_exp_floor_counts_both_passes_and_the_column_chunks(shape, us):
    assert abs(1e3 * chip_smoke.exp_floor_ms(shape) - us) < 0.01


def test_pass_kind_sorts_the_backward_kernels_of_a_trace():
    assert chip_smoke.pass_kind(
        "void (anonymous namespace)::attention_bwd_rows_kernel<__nv_bfloat16,"
        " 32, 96>(CUtensorMap_st, ...)") == "rows"
    assert chip_smoke.pass_kind(
        "void (anonymous namespace)::attention_bwd_cols_wide_kernel<float, "
        "128>(float const*, ...)") == "cols"
    assert chip_smoke.pass_kind(
        "void (anonymous namespace)::sum_parts_kernel<float>(...)") == "sums"
    assert chip_smoke.pass_kind(
        "void (anonymous namespace)::attention_fwd_kernel<float, 16, 48>"
        "(...)") is None


def test_backward_kernel_names_follow_the_padded_widths():
    assert chip_smoke.bwd_kernel_names((32, 4096, 1024, 12, 48),
                                       "bfloat16") == (
        "attention_bwd_rows_kernel<bf16, 16, 48>",
        "attention_bwd_cols_kernel<bf16, 16, 48>")
    assert chip_smoke.bwd_kernel_names((32, 4096, 1024, 64, 256),
                                       "float32") == (
        "attention_bwd_rows_kernel<f32, 64, 128>",
        "attention_bwd_cols_kernel<f32, 64, 128>")
    assert chip_smoke.bwd_kernel_names((32, 64, 16, 192, 768),
                                       "bfloat16") == (
        "attention_bwd_rows_wide_kernel<bf16, 128>",
        "attention_bwd_cols_wide_kernel<bf16, 128>")


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


def test_eight_band_shapes_are_the_main_path_shapes_in_eight_bands():
    """Each worker of the `1 x 8` grid holds 8 of the 64 rows of the 64x64
    map: an eighth of the queries, all the pooled keys; the case's
    launches run at those widths."""
    bands = dict(chip_smoke.SPATIAL_SHAPES)
    for name, (b, n, m, c, cg) in chip_smoke.SHAPES.items():
        assert bands[name + "_band8"] == (b, n // 8, m, c, cg) == (
            32, 512, 1024, c, cg)
    case = chip_smoke.SPATIAL_CASES["biggan128_k8"]
    assert case["model"] == 8 and 128 % case["model"] == 0
    assert case["attention"] == {shape[1:] for name, shape in bands.items()
                                 if name.endswith("_band8")}
    assert set(case["controls"]) == {"whole_as_band", "no_halo"}


def test_spatial_shapes_hold_the_zoo_bands():
    """BigGAN-deep's B8/B2 map (C 32, Cg 128) and S3GAN's D after B1 on
    its 38 rows, each worker's half of the queries, are band rows too, and
    every case's attention widths are among the band rows'."""
    bands = dict(chip_smoke.SPATIAL_SHAPES)
    deep_b, deep_n, deep_m, c, cg = chip_smoke.DEEP_SHAPE[1]
    assert bands["G_B8_D_B2_deep_band"] == (deep_b, deep_n // 2, deep_m, c, cg)
    s3_b, s3_n, s3_m, c, cg = chip_smoke.S3GAN_SHAPE[1]
    assert bands["D_B1_s3gan_band"] == (s3_b, s3_n // 2, s3_m, c, cg) \
        == (38, 2048, 1024, 12, 48)
    widths = {shape[1:] for shape in bands.values()}
    for case in chip_smoke.SPATIAL_CASES.values():
        assert case["attention"] <= widths
    assert {c for case in chip_smoke.SPATIAL_CASES.values()
            for c in case["controls"]} == set(chip_smoke.SPATIAL_CONTROLS)


def test_spatial_zoo_controls_patch_the_band_ops_and_restore_them():
    import torch
    from compare_gan_torch.parallel import mesh_utils, tpu_ops
    right = (tpu_ops.rotate_bands, tpu_ops.image_sum)
    x = torch.arange(2 * 2 * 4, dtype=torch.float32).reshape(1, 2, 4, 2)
    with chip_smoke.spatial_control("local_rotation"):
        with mesh_utils.replica_context(mesh_utils.Replicas(
                rank=1, world=2, model_size=2)):
            turned = tpu_ops.rotate_bands(x, rot90_scalars=(1, 2))
        # Each band turned by itself, read back in the band's shape, with
        # no collective: a scramble of its own pixels.
        assert turned.shape == (2, 2, 4, 2)
        assert sorted(turned[0].flatten().tolist()) == \
            sorted(x.flatten().tolist())
    with chip_smoke.spatial_control("band_slope"):
        assert tpu_ops.image_sum is not right[1]
        assert tpu_ops.image_sum(x).tolist() == [x.sum().item()]
    assert (tpu_ops.rotate_bands, tpu_ops.image_sum) == right


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
    # A whole map's sums run over the model group as a band's would.
    right_group = tpu_ops.band_group
    with mesh_utils.replica_context(grid):
        whole = tpu_ops.split_bands(torch.ones(1, 3, 2, 1))
        assert isinstance(whole, tpu_ops.Whole)
        assert tpu_ops.band_group(whole) is None
        with chip_smoke.spatial_control("whole_as_band"):
            assert tpu_ops.band_group(whole) is grid
    assert tpu_ops.band_group is right_group


def test_hires_shapes_are_the_published_models_blocks():
    """The 512 px phases' rows are the non-local blocks of the published
    BigGAN-512 and BigGAN-deep-512 (built on the meta device from
    chip_smoke's bindings): (channels / 8, channels / 2) on the 64x64 map,
    at the parameter counts the phases pin (tests/test_architectures.py,
    tests/test_torch_biggan_deep.py)."""
    from compare_gan_torch import config as tgin
    from compare_gan_torch import core
    from compare_gan_torch import gans  # noqa: F401 (gin)
    from compare_gan_torch.architectures import (DISCRIMINATORS,
                                                 GENERATORS)

    def widths(bindings, arch):
        tgin.clear_config()
        tgin.parse_config_files_and_bindings(
            [os.path.join(REPO, "example_configs",
                          "biggan_imagenet128.gin")], list(bindings))
        assert "options.z_dim = 160" in bindings
        out = []
        for module in (GENERATORS[arch](image_shape=(512, 512, 3),
                                        z_dim=160, num_classes=1000,
                                        device="meta"),
                       DISCRIMINATORS[arch](image_shape=(512, 512, 3),
                                            num_classes=1000,
                                            device="meta")):
            block = module.non_local_block
            out.append((core.count_params(module), block.attn_ch,
                        block.g_ch))
        tgin.clear_config()
        return out

    (g_count, g_c, g_cg), (d_count, d_c, d_cg) = widths(
        chip_smoke.B512_BINDINGS, "resnet_biggan_arch")
    assert (g_count, d_count) == chip_smoke.B512_PARAMS
    assert (g_c, g_cg) == chip_smoke.B512_SHAPE[1][3:] == (48, 192)
    assert (d_c, d_cg) == chip_smoke.SHAPES["G_B4"][3:] == (24, 96)
    deep = widths(chip_smoke.DEEP512_BINDINGS[1:], "resnet_biggan_deep_arch")
    assert (deep[0][0], deep[1][0]) == chip_smoke.DEEP512_PARAMS
    assert deep[0][1:] == deep[1][1:] == chip_smoke.DEEP512_SHAPE[1][3:] \
        == (64, 256)
    cases = [(name, dtype, bwd) for name, _, dtype, bwd, _
             in chip_smoke._cases() if name in dict(chip_smoke.HIRES_SHAPES)]
    assert cases == [("G_B4_512", "float32", True),
                     ("G_B4_512", "bfloat16", True),
                     ("deep512_G_D", "float32", True),
                     ("deep512_G_D", "bfloat16", True),
                     ("G_B4_512_eval", "float32", False)]


@pytest.mark.parametrize("shape,dtype_name,us", [
    # Two column chunks, each recomputing S: 2*B*N*M*nz*(s*CP + o*GP).
    ((32, 4096, 1024, 64, 256), "bfloat16", 104.22),
    ((32, 4096, 1024, 48, 192), "bfloat16", 78.17),
    ((64, 4096, 1024, 48, 192), "float32", 416.90),
])
def test_issued_mma_floor_counts_the_column_chunks(shape, dtype_name, us):
    assert abs(1e3 * chip_smoke.issued_fwd_ms(shape, dtype_name) - us) < 0.01


def test_launch_widths_count_each_launch_and_restore():
    """`_launch_widths` counts the wrappers' calls by kernel, type and
    width (here their plain CPU path) and puts the wrappers back."""
    import torch
    from compare_gan_torch.ops import fused_attention as fa
    fwd, bwd = fa.attention_fwd, fa.attention_bwd
    seen = {}
    with chip_smoke._launch_widths(fa, seen):
        for c, cg in ((48, 192), (48, 192), (24, 96)):
            args = [torch.randn(1, n, w, requires_grad=True)
                    for n, w in ((8, c), (4, c), (4, cg))]
            fa.FusedAttention.apply(*args).sum().backward()
    assert seen == {"fwd float32 48x192": 2, "bwd float32 48x192": 2,
                    "fwd float32 24x96": 1, "bwd float32 24x96": 1}
    assert (fa.attention_fwd, fa.attention_bwd) == (fwd, bwd)


def test_feat8_shapes_are_the_blocks_of_biggan128_at_the_feat8_placement():
    """The feat8 phase's rows and parameter counts: BigGAN-128 at ch 96
    with the attention after G's B1 and D's B4 (built on the meta device
    from chip_smoke's bindings) has (channels / 8, channels / 2) =
    (192, 768) and (96, 384) on the 8x8 maps, and the parameter counts of
    the JAX package's model at the same bindings (jax.eval_shape: shapes
    only)."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from compare_gan_tpu import core as jcore
    from compare_gan_tpu.architectures import resnet_biggan
    from compare_gan_tpu.ops import arch_ops as jarch_ops
    from compare_gan_torch import config as tgin
    from compare_gan_torch import core
    from compare_gan_torch import gans  # noqa: F401 (gin)
    from compare_gan_torch.architectures import (DISCRIMINATORS,
                                                 GENERATORS)

    tgin.clear_config()
    tgin.parse_config_files_and_bindings(
        [os.path.join(REPO, "example_configs", "biggan_imagenet128.gin")],
        list(chip_smoke.FEAT8_BINDINGS))
    try:
        gen = GENERATORS["resnet_biggan_arch"](
            image_shape=(128, 128, 3), z_dim=120, num_classes=1000,
            device="meta")
        disc = DISCRIMINATORS["resnet_biggan_arch"](
            image_shape=(128, 128, 3), num_classes=1000, device="meta")
        counts = tuple(core.count_params(m) for m in (gen, disc))
        widths = [(m.non_local_block.attn_ch, m.non_local_block.g_ch)
                  for m in (gen, disc)]
    finally:
        tgin.clear_config()
    shapes = dict(chip_smoke.FEAT8_SHAPES)
    assert widths == [shapes["G_B1_feat8"][3:], shapes["D_B4_feat8"][3:]] \
        == [(192, 768), (96, 384)]
    assert shapes["G_B1_feat8"][:3] == shapes["D_B4_feat8"][:3] \
        == (32, 64, 16)
    assert shapes["G_B2_feat16"] == (32, 256, 64, 96, 384)

    jgen = resnet_biggan.Generator(
        image_shape=(128, 128, 3),
        batch_norm_fn=jarch_ops.conditional_batch_norm,
        blocks_with_attention="B1")
    jdisc = resnet_biggan.Discriminator(blocks_with_attention="B4")

    def net(z, y):
        return jdisc(jgen(z, y, is_training=True), y, is_training=True)

    params = jax.eval_shape(
        lambda z, y: jcore.init(net, jax.random.PRNGKey(0), z, y)[1],
        jnp.zeros((2, 120)), jnp.zeros((2, 1000)))
    jcounts = tuple(
        sum(int(np.prod(v.shape))
            for v in jcore.filter_prefix(params, prefix).values())
        for prefix in ("generator", "discriminator"))
    assert counts == jcounts == chip_smoke.FEAT8_PARAMS \
        == (73337028, 88708130)
    cases = [(name, dtype, bwd) for name, _, dtype, bwd, _
             in chip_smoke._cases()
             if name in dict(chip_smoke.FEAT8_SHAPES
                             + chip_smoke.CHECK_ONLY_SHAPES)]
    assert cases == [(name, dtype, True)
                     for name in ("G_B1_feat8", "D_B4_feat8", "G_B2_feat16",
                                  "ragged_c72", "c256")
                     for dtype in ("float32", "bfloat16")]


def test_ptxas_report_names_the_wgmma_backward():
    """The backward at C <= 64 takes its tensor maps first; its name is
    read as before."""
    log = (
        "ptxas info    : Function properties for _ZN49_GLOBAL__N__3a11b54b_"
        "12_attention_cu_be831865_16425attention_bwd_cols_kernelIfLi64ELi128"
        "EEEv14CUtensorMap_stS1_PKT_S4_S4_S4_PKfPfS7_iiiiiii\n"
        "    16 bytes stack frame, 16 bytes spill stores, 16 bytes spill "
        "loads\n"
        "ptxas info    : Used 168 registers, used 1 barriers, 16 bytes "
        "cumulative stack size\n")
    assert chip_smoke.ptxas_report(log) == [
        ("attention_bwd_cols_kernel<f32, 64, 128>", 168, 16, 16)]


def test_ptxas_report_names_the_kernels_past_c_64():
    log = (
        "ptxas info    : Function properties for _ZN12_GLOBAL__N_130"
        "attention_bwd_cols_wide_kernelIfLi128EEEvPKT_\n"
        "    0 bytes stack frame, 68 bytes spill stores, 144 bytes spill "
        "loads\n"
        "ptxas info    : Used 255 registers, used 1 barriers\n")
    assert chip_smoke.ptxas_report(log) == [
        ("attention_bwd_cols_wide_kernel<f32, 128>", 255, 68, 144)]


def test_attention_variants_substitutions_apply_to_the_source():
    """tools/attention_variants.py builds its variants by text
    substitutions in csrc/attention.cu with expected counts; each must
    still apply to the source as it stands (it raises on the card
    otherwise)."""
    sys.path.insert(0, os.path.join(REPO, "tools"))
    try:
        import attention_variants
    finally:
        sys.path.remove(os.path.join(REPO, "tools"))
    with open(os.path.join(REPO, "compare_gan_torch", "csrc",
                           "attention.cu")) as f:
        base = f.read()
    for name, subs in attention_variants.SUBSTITUTIONS.items():
        assert attention_variants._variant_source(base, subs) != base, name
