"""The port's train step in the spatial layout, four gloo workers on the
CPU as a `2 x 2` data x model grid (image height in two bands), against the
JAX package's `compile_train_step(spatial=True)` on
`make_mesh(num_devices=4, extra_axes=(("model", 2),))` and against the
port's own one-process step, in the full TrainState.

The cases are those of tests/test_parallel.py:123,152,384: `dummy` (a
linear G, D on the images' channel means); DCGAN at 32 px, here with batch
norm in G and D (moments over the grid; the deconvs' and the strided
convs' halos, down to bands of one row); and conditional BigGAN-32 at
ch 16 with the non-local block in G's B2 and D's B1 (the attention takes
its plain version on the CPU, on the band's queries against both bands'
keys). Both packages start from the port's init_state (carried by
interop.py), take the same global batch of 8 rows a sub-step (4 a data
rank) and the same draws of z and sampled labels, drawn by the JAX
package's own streams. Every case runs with Adam's epsilon at 1e-3, on
both sides: Adam is then linear in small gradients, so a gradient that is
rounding noise (a bias feeding a batch norm) moves its parameter by noise,
not by +-lr, and a gradient counted k times moves its parameter further
(tests/test_parallel.py:225-240 takes the same config for DP).

JAX's own spatial step of DCGAN departs from its one-device and
data-parallel steps (its G loss by 7e-4 of itself here, 3.8% without batch
norm, while D's update agrees to 1e-8; XLA's partitioning, on the
reference side): the port's DCGAN grid is held to JAX's data-parallel
step on the same 4 devices, which tests/test_parallel.py:123 holds the
spatial step equal to, and `test_jax_spatial_dcgan_step_departs_from_its_dp_step`
records the gap.

The workers also run two faulty controls (`chip_smoke.spatial_control`),
which must fail the tolerances: "k_times" (the gradients of what every
model rank computes whole, D's last layer, summed twice over the grid)
and "no_halo" (the convs pad bands with zeros). They run every case in
one spawn (torch and the port only; `torch_helpers.run_spatial_cases`)
while this process runs the JAX side.
"""

import json
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
from compare_gan_tpu.ops import pallas_attention
from compare_gan_tpu.parallel import mesh_utils as jmesh
from compare_gan_torch import checkpoint, interop
from compare_gan_torch.parallel import mesh_utils

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH, WORLD, MODEL = 8, 4, 2
LINEAR_ADAM = """
ModularGAN.g_optimizer_fn = @AdamOptimizer
ModularGAN.d_optimizer_fn = @AdamOptimizer
AdamOptimizer.epsilon = 1e-3
"""
CASES = {
    "dummy": dict(
        cls="ModularGAN", dataset="cifar10", cfg=LINEAR_ADAM,
        parameters={"architecture": "dummy_arch", "z_dim": 8, "lambda": 1,
                    "disc_iters": 1}, controls=["k_times"]),
    "dcgan": dict(
        cls="ModularGAN", dataset="cifar10", cfg=LINEAR_ADAM + """
G.batch_norm_fn = @batch_norm
D.batch_norm_fn = @batch_norm
""", parameters={"architecture": "dcgan_arch", "z_dim": 8, "lambda": 1,
                 "disc_iters": 1}, controls=["k_times", "no_halo"]),
    "biggan32": dict(
        cls="ModularGAN", dataset="cifar10", cfg=LINEAR_ADAM + """
G.batch_norm_fn = @conditional_batch_norm
G.spectral_norm = True
D.spectral_norm = True
resnet_biggan.Generator.hierarchical_z = True
resnet_biggan.Generator.embed_y = True
resnet_biggan.Generator.blocks_with_attention = "B2"
resnet_biggan.Generator.ch = 16
resnet_biggan.Discriminator.project_y = True
resnet_biggan.Discriminator.ch = 16
""", parameters={"architecture": "resnet_biggan_arch", "z_dim": 120,
                 "lambda": 1, "disc_iters": 1},
        kwargs={"conditional": True}),
}
for _case in CASES.values():
    _case["batch"] = BATCH
# The JAX step each case is held to: JAX's spatial step, or its
# data-parallel step on the same devices where the spatial one departs
# from it (DCGAN; BigGAN-32 against JAX is the slow test).
JAX_CASES = {"dummy": "spatial", "dcgan": "data_parallel"}
# JAX's tolerances for the parameters (tests/test_parallel.py:146-149); for
# BigGAN-32 its atol 5e-5 (:432-441): G's conv biases feed cBN, which
# subtracts the batch mean, so their true gradient is 0 and their one-step
# values are reduction-order roundoff that differs between two halo and
# collective schedules (here Adam's epsilon keeps them near 1e-10).
PARAM_TOL = {"dummy": (1e-4, 1e-6), "dcgan": (1e-4, 1e-6),
             "biggan32": (1e-4, 5e-5)}


def _batch(seed):
    rng = np.random.RandomState(seed)
    total = BATCH * 2
    return {"images": rng.rand(total, 32, 32, 3).astype(np.float32),
            "labels": rng.randint(0, 10, total).astype(np.int32)}


def _jax_gan(case, use_pallas=False):
    jgin.clear_config()
    jgin.parse_config(case["cfg"] + f"attention.use_pallas = {use_pallas}\n")
    jdatasets.set_fake_dataset(True)
    return jmodular.ModularGAN(
        dataset=jdatasets.get_dataset(case["dataset"]),
        parameters=case["parameters"], model_dir="unused",
        **case.get("kwargs", {}))


def _jax_step(name, ts, batch, mode="spatial", use_pallas=False):
    """JAX's step on WORLD devices: spatial on the `2 x 2` mesh, or
    data-parallel on the 4-device data mesh."""
    jgan = _jax_gan(CASES[name], use_pallas)
    spatial = mode == "spatial"
    mesh = jmesh.make_mesh(num_devices=WORLD, extra_axes=(
        (("model", MODEL),) if spatial else ()))
    step, shard_batch, ts = jmesh.compile_train_step(
        jgan, jax.tree_util.tree_map(np.array, ts), mesh, BATCH,
        spatial=spatial)
    return step(ts, shard_batch(batch))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(workdir, {case: (JAX TrainState before the step, batch)},
    {(case, mode): (JAX new TrainState, JAX metrics)} for JAX_CASES and
    DCGAN's spatial step) after the workers have written their states
    into `workdir`."""
    workdir = str(tmp_path_factory.mktemp("spatial_step"))
    started = {}
    for i, (name, case) in enumerate(CASES.items()):
        ts_t = th.port_gan(case).init_state(seed=0)
        jgan = _jax_gan(case)
        ts = th.jax_train_state(jgan, ts_t)
        batch = _batch(seed=i)
        weights = {k: interop.to_jax(v)
                   for k, v in interop.state_dict(ts_t).items()}
        th.write_case_inputs(os.path.join(workdir, f"{name}.npz"), weights,
                             batch, th.jax_draws(jgan, ts, batch["labels"],
                                                 BATCH))
        started[name] = (ts, batch)
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
        for name, mode in list(JAX_CASES.items()) + [("dcgan", "spatial")]:
            results[name, mode] = _jax_step(name, *started[name], mode)
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
    return workdir, started, results


def _port_state(workdir, name, tag):
    """(TrainState, metrics) a worker wrote for a case."""
    gan = th.port_gan(CASES[name])
    ts = checkpoint.restore_checkpoint(
        os.path.join(workdir, name, tag, "model.ckpt-1.npz"),
        gan.init_state(seed=1))
    with np.load(os.path.join(workdir, name, tag, "metrics.npz")) as d:
        metrics = {k: d[k] for k in d.files}
    return ts, metrics


def _assert_matches_jax(workdir, name, tag, result):
    """The port's state `tag` against JAX's spatial step: the full state as
    tests/test_torch_dp_step.py holds it, and every parameter within JAX's
    own tolerance."""
    ts_j, metrics_j = result
    ts_t, metrics_t = _port_state(workdir, name, tag)
    assert ts_t.step == int(ts_j.step) == 1
    th.assert_train_states_close(ts_j, ts_t, metrics_j, metrics_t,
                                 lambda _: 2e-4)
    rtol, atol = PARAM_TOL[name]
    params_t = interop.params_to_jax(interop.state_dict(ts_t))[0]
    for k, v in ts_j.params.items():
        th.assert_close(params_t[k], v, rtol=rtol, atol=atol, what=k)


@pytest.mark.parametrize("name", list(JAX_CASES))
def test_grid_matches_the_jax_step(runs, name):
    workdir, _, results = runs
    _assert_matches_jax(workdir, name, "rank0",
                        results[name, JAX_CASES[name]])


def test_jax_spatial_dcgan_step_departs_from_its_dp_step(runs):
    """On the reference side: from the same state, batch and draws, JAX's
    spatial DCGAN step updates D as its data-parallel step does (every D
    parameter within 1e-6) but reports another G loss, beyond the losses'
    1e-4, and moves G elsewhere."""
    _, _, results = runs
    (dp, m_dp), (sp, m_sp) = (results["dcgan", mode]
                              for mode in ("data_parallel", "spatial"))
    for k, v in dp.params.items():
        if k.startswith("discriminator/"):
            th.assert_close(sp.params[k], v, rtol=0, atol=1e-6, what=k)
    gap = abs(float(m_sp["loss/g"]) / float(m_dp["loss/g"]) - 1)
    print(f"JAX DCGAN loss/g: spatial {float(m_sp['loss/g'])!r}, data "
          f"parallel {float(m_dp['loss/g'])!r}, relative gap {gap:.3g}")
    assert gap > 1e-4


def _arrays(workdir, name, tag):
    with np.load(os.path.join(workdir, name, tag, "model.ckpt-1.npz")) as d:
        return {k: d[k] for k in d.files}


def _assert_matches_one_process(workdir, name, tag):
    """A state against the port's one-process step: parameters within
    PARAM_TOL, the rest as tests/test_torch_dp_step.py holds two workers
    to one process (Adam's moments 1e-3 plus 1e-4 (mu) or 1e-8 (nu) of
    their largest; the EMA 1e-6 plus 1e-7; SN u and BN state 1e-4 plus
    1e-5)."""
    got, want = _arrays(workdir, name, tag), _arrays(workdir, name,
                                                     "single")
    assert got.keys() == want.keys()
    for k, v in want.items():
        group = k.split("[")[0]
        if group.endswith(("_opt.mu", "_opt.nu")):
            largest = max(float(np.abs(w).max()) for key, w in want.items()
                          if key.startswith(group + "["))
            rtol, atol = 1e-3, (1e-8 if group.endswith("nu") else 1e-4) \
                * largest
        elif group == ".ema_params":
            rtol, atol = 1e-6, 1e-7
        elif group == ".params":
            rtol, atol = PARAM_TOL[name]
        else:
            rtol, atol = 1e-4, 1e-5
        np.testing.assert_allclose(got[k], v, rtol=rtol, atol=atol,
                                   err_msg=k)


@pytest.mark.parametrize("name", list(CASES))
def test_grid_matches_one_process(runs, name):
    """Every rank's state equals rank 0's bitwise (asserted in the
    workers), and rank 0's equals the one-process step within the
    tolerances; so do the losses."""
    workdir = runs[0]
    _assert_matches_one_process(workdir, name, "rank0")
    for r in range(WORLD):
        with np.load(os.path.join(workdir, name, f"rank{r}",
                                  "metrics.npz")) as d:
            got = {k: d[k] for k in d.files}
        with np.load(os.path.join(workdir, name, "single",
                                  "metrics.npz")) as d:
            want = {k: d[k] for k in d.files}
        assert got.keys() == want.keys()
        for k in want:
            th.assert_close(got[k], want[k], rtol=1e-4, atol=1e-5, what=k)


@pytest.mark.parametrize("name,control", [
    (name, control) for name, case in CASES.items()
    for control in case.get("controls", ())])
def test_a_faulty_layout_fails_the_tolerances(runs, name, control):
    """The controls' states must fail the comparison the layout passes:
    against JAX's step, and against the port's one process."""
    workdir, _, results = runs
    if name in JAX_CASES:
        with pytest.raises(AssertionError):
            _assert_matches_jax(workdir, name, control,
                                results[name, JAX_CASES[name]])
    with pytest.raises(AssertionError):
        _assert_matches_one_process(workdir, name, control)


def test_hosts_exchange_a_data_ranks_rows_to_its_model_group(runs):
    """Two hosts of one model group each: every worker ends with its data
    rank's rows of each of the 3 sub-steps of 8 (4 a data rank)."""
    workdir = runs[0]
    step_batch = np.arange(24 * 2, dtype=np.float32).reshape(24, 2)
    for r in range(WORLD):
        data_rank = r // MODEL
        want = np.concatenate([step_batch[s * 8 + 4 * data_rank:
                                          s * 8 + 4 * (data_rank + 1)]
                               for s in range(3)])
        with np.load(os.path.join(workdir, f"hosts{r}.npz")) as d:
            np.testing.assert_array_equal(d["blocks"], want)


def test_workers_load_no_jax(runs):
    workdir = runs[0]
    for r in range(WORLD):
        with open(os.path.join(workdir, f"rank{r}.modules")) as f:
            loaded = set(f.read().split())
        assert "torch" in loaded
        assert not loaded & {"jax", "jaxlib", "optax", "compare_gan_tpu"}


@pytest.mark.slow
def test_biggan32_grid_matches_the_jax_spatial_step_with_attention(runs):
    """The port's spatial BigGAN-32 step against JAX's
    (tests/test_parallel.py:384: the Pallas kernel in interpret mode
    inside the spatially sharded step, through its partitioning rule),
    from the same init, batch and draws. Parameters at JAX's rtol 1e-4 and
    atol 5e-5 (PARAM_TOL's reason)."""
    workdir, started, _ = runs
    old_interpret = pallas_attention._INTERPRET
    pallas_attention._INTERPRET = True  # Pallas on the CPU backend.
    try:
        result = _jax_step("biggan32", *started["biggan32"],
                           use_pallas=True)
    finally:
        pallas_attention._INTERPRET = old_interpret
        jgin.clear_config()
        jdatasets.set_fake_dataset(False)
    _assert_matches_jax(workdir, "biggan32", "rank0", result)
