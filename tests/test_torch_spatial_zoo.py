"""The spatial layout for the whole zoo: every architecture, GAN class,
gradient penalty and normalization of the port in one train step on a
`2 x 2` data x model grid of the first four of eight gloo workers on the
CPU (image height in two bands), and the partial replication of maps
whose height does not split on `1 x 4` and `1 x 8` grids, against the
port's own one-process step in the full TrainState; SSGAN and WGAN-GP on
DCGAN also against the JAX package's data-parallel step on 4 devices.

Partial replication: a map whose height splits into the k bands is held
as bands where the next layer can run on them, any other map whole on
every model rank; a layer that cannot run on its bands (a stride or a 2x2
pool that an odd band would straddle, a transposed conv whose output does
not split) gathers them and runs on the whole map, and a whole map whose
height splits goes back to bands.

The cases, each at the smallest width its architecture takes:
BigGAN-32 at ch 16 on a `1 x 8` grid of all eight workers (G's 4-row map
whole on every rank, D's 2x2 pool of bands of one row gathered, its last
4-row map and sum whole: the card's eight-band case in small);
BigGAN-deep at 64 px with its non-local block (G's, at 64x64; ch 16);
ResNet-CIFAR; ResNet-STL at 48 px (its D halves a 6-row map to bands of
3 rows and pools them whole); ResNet30 at 128 px; ResNet5 at 128 px and
ch 4; SNDCGAN and InfoGAN at 32 px; SSGAN on DCGAN (the rotated rows lie
on data rank 1 only, turned whole and cut into bands again); S3GAN on
BigGAN-32 at ch 16 (rotation, soft predictor, projection, unlabeled rows);
WGAN-GP and DRAGAN on DCGAN (the slope's double backward through the
halos); BigGAN-32's D with layer norm; EvoNorm-S0 in DCGAN's G; batch norm
with num_batch_groups 2 in DCGAN; DCGAN-28 as dcgan_polygons28.gin
publishes it (batch 4) on a `1 x 4` grid: D's stride-2 convs from bands
of 7 rows and on whole maps of 14 and 7 rows, G's transposed convs from
bands of 1 row to a whole map of 7 rows and from whole maps of 7 and 14
rows, its batch norm on whole maps.

Every case starts from one port init (carried by interop.py to JAX where
JAX takes the step), takes one global batch from a numpy seed and the
same draws: the port's own streams where only the port runs, the JAX
package's where JAX runs (z, sampled labels, alpha). Adam's epsilon is
1e-3 (tests/test_torch_spatial_step.py says why). JAX's own spatial
DCGAN step departs from its data-parallel step (that file's record), so
the two JAX cases are held to its data-parallel step; the penalty case's
D has no batch norm: XLA's jitted f32 penalty through DCGAN's BN'd D is
wrong on the reference side (ROADMAP).

Five faulty controls (`chip_smoke.spatial_control`) must fail the
comparisons the layout passes: "k_times" and "no_halo" on ResNet5,
"local_rotation" (each band turned by itself) on SSGAN, "band_slope"
(the slope from a band's gradient alone) on WGAN-GP and "whole_as_band"
(a whole map's sums over the model group, k times) on BigGAN-32's `1 x 8`
grid.

The workers run every case in one spawn (torch and the port only;
`torch_helpers.run_spatial_cases`) while this process runs the JAX side.
"""

import json
import math
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

from tests import torch_helpers as th

from compare_gan_tpu import config as jgin
from compare_gan_tpu import datasets as jdatasets
from compare_gan_tpu.gans import modular_gan as jmodular
from compare_gan_tpu.gans import ssgan as jssgan
from compare_gan_tpu.ops import rng as jrng
from compare_gan_tpu.parallel import mesh_utils as jmesh
from compare_gan_torch import checkpoint, interop
from compare_gan_torch.parallel import mesh_utils

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 8
# The devices of JAX's data-parallel step: the `2 x 2` grid's workers.
JAX_DEVICES = 4
LINEAR_ADAM = """
ModularGAN.g_optimizer_fn = @AdamOptimizer
ModularGAN.d_optimizer_fn = @AdamOptimizer
AdamOptimizer.epsilon = 1e-3
"""
G_BN = "G.batch_norm_fn = @batch_norm\n"
BN = G_BN + "D.batch_norm_fn = @batch_norm\n"
SN = "G.spectral_norm = True\nD.spectral_norm = True\n"
BIGGAN32 = SN + """
G.batch_norm_fn = @conditional_batch_norm
resnet_biggan.Generator.hierarchical_z = True
resnet_biggan.Generator.embed_y = True
resnet_biggan.Discriminator.project_y = True
"""


def _params(architecture, z_dim=8, **more):
    return dict({"architecture": architecture, "z_dim": z_dim, "lambda": 1,
                 "disc_iters": 1}, **more)


CASES = {
    "biggan_deep64": dict(
        cls="ModularGAN", dataset="imagenet_64", batch=4, cfg=SN + """
G.batch_norm_fn = @conditional_batch_norm
resnet_biggan_deep.Generator.ch = 16
resnet_biggan_deep.Discriminator.ch = 16
""", parameters=_params("resnet_biggan_deep_arch", 128),
        kwargs={"conditional": True}),
    "resnet_cifar": dict(cls="ModularGAN", dataset="cifar10", batch=8,
                         cfg=G_BN + SN, parameters=_params(
                             "resnet_cifar_arch")),
    "resnet30": dict(cls="ModularGAN", dataset="celeb_a_hq_128", batch=2,
                     cfg="G.batch_norm_fn = @evonorm_s0\n"
                     "D.layer_norm = True\n",
                     parameters=_params("resnet30_arch"),
                     constants={"resnet30.CH": 8}, forward_only=True),
    "resnet5": dict(cls="ModularGAN", dataset="celeb_a_hq_128", batch=8,
                    cfg=G_BN, parameters=_params("resnet5_arch"),
                    arch_kwargs={"ch": 4}, controls=["k_times", "no_halo"]),
    "sndcgan": dict(cls="ModularGAN", dataset="cifar10", batch=8,
                    cfg="D.spectral_norm = True\n",
                    parameters=_params("sndcgan_arch")),
    "infogan": dict(cls="ModularGAN", dataset="cifar10", batch=4, cfg=BN,
                    parameters=_params("infogan_arch")),
    "ssgan_dcgan": dict(cls="SSGAN", dataset="cifar10", batch=8, cfg="",
                        parameters=_params("dcgan_arch"),
                        kwargs={"self_supervision": "rotation_gan",
                                "rotated_batch_size": 4},
                        controls=["local_rotation"]),
    "s3gan_biggan32": dict(
        cls="S3GAN", dataset="cifar10", batch=8, cfg=BIGGAN32 + """
resnet_biggan.Generator.ch = 16
resnet_biggan.Discriminator.ch = 16
resnet_biggan.Generator.blocks_with_attention = ""
""", parameters=_params("resnet_biggan_arch", 120),
        kwargs={"conditional": True, "self_supervision": "rotation",
                "rotated_batch_fraction": 2, "project_y": True,
                "use_predictor": True, "use_soft_pred": True}),
    "wgangp_dcgan": dict(cls="ModularGAN", dataset="cifar10", batch=8,
                         cfg="""
loss.fn = @wasserstein
penalty.fn = @wgangp_penalty
""", parameters=_params("dcgan_arch", 16, **{"lambda": 10}),
                         controls=["band_slope"]),
    "dragan_dcgan": dict(cls="ModularGAN", dataset="cifar10", batch=4,
                         cfg="penalty.fn = @dragan_penalty\n",
                         parameters=_params("dcgan_arch")),
    "biggan_layer_norm": dict(
        cls="ModularGAN", dataset="cifar10", batch=4, cfg=BIGGAN32 + """
D.layer_norm = True
resnet_biggan.Generator.ch = 8
resnet_biggan.Discriminator.ch = 8
resnet_biggan.Generator.blocks_with_attention = ""
resnet_biggan.Discriminator.blocks_with_attention = ""
""", parameters=_params("resnet_biggan_arch", 120),
        kwargs={"conditional": True}),
    "evonorm": dict(cls="ModularGAN", dataset="cifar10", batch=4,
                    cfg="G.batch_norm_fn = @evonorm_s0\n",
                    parameters=_params("dcgan_arch")),
    "batch_groups": dict(cls="ModularGAN", dataset="cifar10", batch=8,
                         cfg=G_BN + "standardize_batch.num_batch_groups = 2\n",
                         parameters=_params("dcgan_arch")),
    "resnet_stl": dict(cls="ModularGAN", dataset=48, batch=2, cfg=G_BN,
                       parameters=_params("resnet_stl_arch")),
    # Partial replication (the last two: each case's batch comes from its
    # place in this list).
    "biggan32_k8": dict(
        cls="ModularGAN", dataset="cifar10", batch=4, grid=[1, 8],
        cfg=BIGGAN32 + """
resnet_biggan.Generator.ch = 16
resnet_biggan.Discriminator.ch = 16
""", parameters=_params("resnet_biggan_arch", 120),
        kwargs={"conditional": True}, controls=["whole_as_band"]),
    "dcgan28": dict(cls="ModularGAN", dataset="convex_polygons", batch=4,
                    grid=[1, 4], cfg=G_BN + """
loss.fn = @non_saturating
standardize_batch.decay = 0.9
standardize_batch.epsilon = 1e-5
""", parameters=_params("dcgan_arch", 128)),
}
for _case in CASES.values():
    _case["cfg"] = LINEAR_ADAM + _case["cfg"]
    _case.setdefault("grid", [2, 2])
# The cases JAX's data-parallel step on JAX_DEVICES devices takes too.
JAX_CLASSES = {"ssgan_dcgan": jssgan.SSGAN,
               "wgangp_dcgan": jmodular.ModularGAN}
# The parameters' (rtol, atol): JAX's (tests/test_parallel.py:146-149),
# and its atol 5e-5 for BigGAN-class Gs (tests/test_parallel.py:432-441):
# a conv bias that feeds a batch norm has a true gradient of 0, so its
# one-step value is reduction-order roundoff that differs between two
# halo and collective schedules.
PARAM_TOL = {name: (1e-4, 5e-5) if name.startswith(
    ("biggan", "s3gan", "resnet")) else (1e-4, 1e-6) for name in CASES}
# The Adam moments' tolerance (mu, nu) as a share of each optimizer's
# largest moment. After one step they are 0.1 g and 0.001 g^2, and a
# gradient that sums the backward over every pixel cancels to 1e-2 to
# 1e-3 of its terms (a G's output bias, a bias before a batch norm, D's
# last bias at init, where D scores real and fake alike), so the order of
# f32 sums, which the bands change, moves it by up to ~1e-3 of the largest
# gradient: two workers without the layout (a `2 x 1` grid) leave gaps of
# that size to one process too (ResNet5's last bias: mu 3.4e-9 of 1.27e-5
# in both layouts; SNDCGAN's G output bias: 3e-7 of 3.9e-4). A gradient
# gap of 1e-3 of the largest gradient moves nu = 0.001 g^2 by up to 2e-3
# of the largest nu. The parameters' and the losses' tolerances stay
# JAX's.
MOMENT_ATOL = (1e-3, 2e-3)
CONTROLS = [(name, control) for name, case in CASES.items()
            for control in case.get("controls", ())]


def _grid_ranks(name):
    return math.prod(CASES[name]["grid"])


def _batch(name, seed):
    case = CASES[name]
    size, colors = (case["dataset"], 3) if isinstance(
        case["dataset"], int) else {
        "imagenet_64": (64, 3), "celeb_a_hq_128": (128, 3),
        "convex_polygons": (28, 1)}.get(case["dataset"], (32, 3))
    classes = 1000 if case["dataset"] == "imagenet_64" else 10
    rng = np.random.RandomState(seed)
    total = case["batch"] * (case["parameters"]["disc_iters"] + 1)
    labels = rng.randint(0, classes, total).astype(np.int32)
    if case["cls"] == "S3GAN":
        labels[::3] = -1  # Unlabeled rows: the class loss skips them.
    return {"images": rng.rand(total, size, size, colors).astype(
        np.float32), "labels": labels}


def _jax_gan(name):
    case = CASES[name]
    jgin.clear_config()
    jgin.parse_config(case["cfg"] + "attention.use_pallas = False\n")
    jdatasets.set_fake_dataset(True)
    return JAX_CLASSES[name](
        dataset=jdatasets.get_dataset(case["dataset"]),
        parameters=case["parameters"], model_dir="unused",
        **case.get("kwargs", {}))


def _jax_draws(jgan, ts, labels, batch):
    """th.jax_draws plus each sub-step's alpha, of the global batch."""
    draws = th.jax_draws(jgan, ts, labels, batch)
    for i, d in enumerate(draws):
        key = jrng.base_key_from_step(ts.rng, ts.step, sub_step=i)
        with jrng.rng_context(key):
            d["alpha"] = np.asarray(jrng.uniform((batch, 1, 1, 1),
                                                 name="alpha"))
    return draws


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(workdir, {case: (JAX new TrainState, JAX metrics)}) after the
    workers have written their states into `workdir`; drops the cached
    states when the module's tests are done."""
    workdir = str(tmp_path_factory.mktemp("spatial_zoo"))
    started = {}
    for i, (name, case) in enumerate(CASES.items()):
        batch = _batch(name, seed=i)
        weights, draws = {}, []  # The workers' own init and draws.
        if name in JAX_CLASSES:
            ts_t = th.port_gan(case).init_state(seed=0)
            jgan = _jax_gan(name)
            ts = th.jax_train_state(jgan, ts_t)
            draws = _jax_draws(jgan, ts, batch["labels"], case["batch"])
            started[name] = (ts, batch)
            weights = {k: interop.to_jax(v)
                       for k, v in interop.state_dict(ts_t).items()}
        th.write_case_inputs(os.path.join(workdir, f"{name}.npz"), weights,
                             batch, draws)
    with open(os.path.join(workdir, "cases.json"), "w") as f:
        json.dump(CASES, f)
    port = str(mesh_utils.free_port())
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    code = ("import sys; from tests import torch_helpers as th; "
            f"th.run_spatial_cases(int(sys.argv[1]), {WORLD}, "
            "int(sys.argv[2]), sys.argv[3])")
    logs = [open(os.path.join(workdir, f"worker{r}.log"), "w")
            for r in range(WORLD)]
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r), port,
                               workdir], cwd=REPO, env=env, stdout=logs[r],
                              stderr=subprocess.STDOUT)
             for r in range(WORLD)]
    try:
        results = {}
        for name, (ts, batch) in started.items():
            jgan = _jax_gan(name)
            mesh = jmesh.make_mesh(num_devices=JAX_DEVICES)
            step, shard_batch, ts = jmesh.compile_train_step(
                jgan, jax.tree_util.tree_map(np.array, ts), mesh,
                CASES[name]["batch"])
            results[name] = step(ts, shard_batch(batch))
        for p in procs:
            p.wait(timeout=300)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for f in logs:
            f.close()
        jgin.clear_config()
        jdatasets.set_fake_dataset(False)
    for r, p in enumerate(procs):
        with open(os.path.join(workdir, f"worker{r}.log")) as f:
            assert p.returncode == 0, f"worker {r}:\n{f.read()[-4000:]}"
    yield workdir, results
    th.step_arrays.cache_clear()


def _assert_matches_jax(workdir, name, tag, result):
    """A worker's state against JAX's data-parallel step: the full state
    as tests/test_torch_dp_step.py holds it, and every parameter within
    JAX's own tolerance."""
    ts_j, metrics_j = result
    gan = th.port_gan(CASES[name])
    ts_t = checkpoint.restore_checkpoint(
        os.path.join(workdir, name, tag, "model.ckpt-1.npz"),
        gan.init_state(seed=1))
    with np.load(os.path.join(workdir, name, tag, "metrics.npz")) as d:
        metrics_t = {k: d[k] for k in d.files}
    assert ts_t.step == int(ts_j.step) == 1
    th.assert_train_states_close(ts_j, ts_t, metrics_j, metrics_t,
                                 lambda _: 2e-4)
    rtol, atol = PARAM_TOL[name]
    params_t = interop.params_to_jax(interop.state_dict(ts_t))[0]
    for k, v in ts_j.params.items():
        th.assert_close(params_t[k], v, rtol=rtol, atol=atol, what=k)


@pytest.mark.parametrize("name", [n for n, c in CASES.items()
                                  if not c.get("forward_only")])
def test_grid_matches_one_process(runs, name):
    """Every rank's state equals rank 0's bitwise (asserted in the
    workers), rank 0's equals the one-process step within the tolerances,
    and every rank's losses equal the one-process step's."""
    workdir = runs[0]
    th.assert_matches_one_process(workdir, name, "rank0", PARAM_TOL[name],
                                  MOMENT_ATOL)
    for r in range(_grid_ranks(name)):
        th.assert_metrics_match_one_process(workdir, name, f"rank{r}")


@pytest.mark.parametrize("name", [n for n, c in CASES.items()
                                  if c.get("forward_only")])
def test_grid_matches_one_process_forward(runs, name):
    """ResNet30's one-step update is f32-chaotic in any layout: 30 blocks
    of 2 to 64 channels (CH 8) sum the backward of layer norm over every
    pixel, and its biases' gradients cancel to ~1e-4 of their terms, so
    the order of f32 sums moves them by a few percent and Adam's update
    by up to 2 lr; two workers without the layout leave gaps of that size
    too. So here the grid is held to one process in the forward before
    any update: the D sub-step's loss (G's fakes and D on real and fake
    through every band-aware layer), on every rank, within 1e-6."""
    workdir = runs[0]
    for r in range(_grid_ranks(name)):
        metrics = []
        for tag in (f"rank{r}", "single"):
            with np.load(os.path.join(workdir, name, tag,
                                      "metrics.npz")) as d:
                metrics.append(float(d["loss/d_0"]))
        np.testing.assert_allclose(*metrics, rtol=1e-6)


@pytest.mark.parametrize("name", list(JAX_CLASSES))
def test_grid_matches_the_jax_data_parallel_step(runs, name):
    workdir, results = runs
    _assert_matches_jax(workdir, name, "rank0", results[name])


@pytest.mark.parametrize("name,control", CONTROLS)
def test_a_faulty_layout_fails_the_tolerances(runs, name, control):
    """Each control's state fails the comparison the layout passes:
    against the port's one process, and against JAX where JAX runs."""
    workdir, results = runs
    with pytest.raises(AssertionError):
        th.assert_matches_one_process(workdir, name, control,
                                      PARAM_TOL[name], MOMENT_ATOL)
    if name in results:
        with pytest.raises(AssertionError):
            _assert_matches_jax(workdir, name, control, results[name])


def test_every_gan_class_penalty_and_norm_has_a_case():
    """The zoo's surface: every architecture of the registry, every GAN
    class and gradient penalty, and each per-image norm and grouped
    batch norm."""
    from compare_gan_torch import architectures
    archs = {c["parameters"]["architecture"] for c in CASES.values()}
    assert archs | {"dummy_arch", "dcgan_arch", "resnet_biggan_arch"} >= \
        set(architectures.GENERATORS)
    assert {c["cls"] for c in CASES.values()} == set(th.GAN_CLASSES)
    cfg = "".join(c["cfg"] for c in CASES.values())
    for binding in ("@wgangp_penalty", "@dragan_penalty", "D.layer_norm",
                    "@evonorm_s0", "num_batch_groups"):
        assert binding in cfg, binding


def test_workers_load_no_jax(runs):
    workdir = runs[0]
    for r in range(WORLD):
        with open(os.path.join(workdir, f"rank{r}.modules")) as f:
            loaded = set(f.read().split())
        assert "torch" in loaded
        assert not loaded & {"jax", "jaxlib", "optax", "compare_gan_tpu"}
