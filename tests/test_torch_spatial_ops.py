"""The spatial layout's band-aware ops (image height split over a model
group of workers), each against the same op on the whole image in one
process: two spawned gloo workers on the CPU, a `1 x 2` grid, every op's
output, input gradient, parameter gradients and state.

The ops are the port's own: the SAME conv at stride 1 and stride 2 (TF's
asymmetric pads, 1 above and 2 below, so the halos differ), 1x1, the
transposed SAME conv (also on bands of one row, as DCGAN's first map at
32 px gives them), the fused and unfused scale convs of the ResNet blocks,
batch norm and conditional batch norm (moments over the grid), the
non-local block (the kernels' plain version on the band's queries against
the keys of both bands), a linear layer on a band's flattened features and
the sum pooling of BigGAN's D. The workers import torch and the port only
(`torch_helpers.run_spatial_ops`).

Tolerance: f32 on the CPU; both sides compute the same products, the
bands' with other row counts and the sums over the grid in another order,
so each tensor within rtol 1e-5 plus 1e-6 of its largest entry (a kernel
gradient sums some hundred products of O(1) inputs into entries up to
~40, whose rounding scales with the tensor, not with the entry).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tests import torch_helpers as th

from compare_gan_torch import config as gin
from compare_gan_torch import datasets
from compare_gan_torch.gans import modular_gan, ssgan
from compare_gan_torch.ops import arch_ops
from compare_gan_torch.parallel import mesh_utils

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """{"rank0": ..., "rank1": ...}: what each worker wrote."""
    workdir = str(tmp_path_factory.mktemp("spatial_ops"))
    inputs = {}
    for i, (name, (_, shape, _)) in enumerate(
            th._spatial_op_cases().items()):
        inputs[f"{name}/x"] = th.randn(shape, seed=10 + i)
        if name == "conditional_batch_norm":
            inputs[f"{name}/y"] = th.randn((shape[0], 3), seed=99)
    np.savez(os.path.join(workdir, "inputs.npz"), **inputs)
    port = str(mesh_utils.free_port())
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    code = ("import sys; from tests import torch_helpers as th; "
            "th.run_spatial_ops(int(sys.argv[1]), 2, int(sys.argv[2]), "
            "sys.argv[3])")
    logs = [open(os.path.join(workdir, f"worker{r}.log"), "w")
            for r in range(WORLD)]
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r), port,
                               workdir], cwd=REPO, env=env, stdout=logs[r],
                              stderr=subprocess.STDOUT)
             for r in range(WORLD)]
    try:
        for p in procs:
            p.wait(timeout=240)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for f in logs:
            f.close()
    out = {}
    for r, p in enumerate(procs):
        with open(os.path.join(workdir, f"worker{r}.log")) as f:
            assert p.returncode == 0, f"worker {r}:\n{f.read()[-4000:]}"
        with np.load(os.path.join(workdir, f"rank{r}.npz")) as d:
            out[f"rank{r}"] = {k: d[k] for k in d.files}
    return out


@pytest.mark.parametrize("name", list(th._spatial_op_cases()))
def test_banded_op_matches_the_whole_image(results, name):
    ranks = [results[f"rank{r}"] for r in range(WORLD)]
    single = {k[len(f"single/{name}/"):]: v
              for k, v in ranks[0].items()
              if k.startswith(f"single/{name}/")}
    bands = [{k[len(f"{name}/"):]: v for k, v in rank.items()
              if k.startswith(f"{name}/")} for rank in ranks]
    assert set(bands[0]) == set(bands[1]) == set(single)
    banded = bands[0]["out"].shape != single["out"].shape
    for key, want in single.items():
        if key == "dx" or (key == "out" and banded):
            got = np.concatenate([b[key] for b in bands], axis=1)
        elif key.startswith("d:"):  # Each band's part of the gradient.
            got = sum(b[key] for b in bands)
        else:  # Whole on every worker: outputs, state.
            np.testing.assert_array_equal(bands[1][key], bands[0][key],
                                          err_msg=key)
            got = bands[0][key]
        np.testing.assert_allclose(
            got, want, rtol=RTOL, atol=ATOL * max(1.0, np.abs(want).max()),
            err_msg=f"{name} {key}")
    if name == "non_local_block":  # The gate is open: theta is live.
        assert np.abs(single["d:conv2d_theta.kernel"]).max() > 1e-3


def _grid(rank=0, world=2, model_size=2):
    """A worker's place in a grid without a process group: what the checks
    that raise before any collective read."""
    return mesh_utils.Replicas(rank=rank, world=world, model_size=model_size)


def test_a_model_group_spanning_hosts_raises():
    with pytest.raises(ValueError, match="span hosts"):
        mesh_utils.init_process_group(0, 4, "127.0.0.1", 1, torch.device(
            "cpu"), num_hosts=4, model_size=2)


def test_grid_coordinates_and_bands():
    reps = _grid(rank=3, world=4)
    assert (reps.data_rank, reps.model_rank, reps.data_size) == (1, 1, 2)
    x = np.arange(8 * 6).reshape(8, 6)[:, :, None]  # [rows, H, W]
    np.testing.assert_array_equal(reps.band(reps.rows(x, 8)), x[4:, 3:])
    with pytest.raises(ValueError, match="does not split"):
        reps.band(np.zeros((2, 5, 1)))


@pytest.mark.parametrize("build,shape,match", [
    # A stride-2 conv on a band of 3 rows: band 1 would not start on a
    # stride boundary.
    (lambda: arch_ops.Conv2d(4, 5, 3, 3, 2, 2), (1, 3, 4, 4), "stride-2"),
    # A 5x5 conv's halo of 2 rows on a band of 1 row.
    (lambda: arch_ops.Conv2d(4, 5, 5, 5), (1, 1, 4, 4), "thinner"),
    (lambda: arch_ops.LayerNorm(4), (1, 2, 4, 4), "each image"),
])
def test_a_band_the_layer_cannot_take_raises(build, shape, match):
    layer = build()
    layer.scope = "discriminator/layer"
    with mesh_utils.replica_context(_grid()):
        with pytest.raises(ValueError, match=match) as err:
            layer(torch.zeros(shape))
    assert "discriminator/layer" in str(err.value)


@pytest.mark.parametrize("cls,architecture,kwargs", [
    (modular_gan.ModularGAN, "resnet_cifar_arch", {}),
    (ssgan.SSGAN, "dummy_arch", {"rotated_batch_size": 8}),
])
def test_a_gan_without_the_layout_raises(cls, architecture, kwargs):
    gin.clear_config()
    datasets.set_fake_dataset(True)
    gan = cls(dataset=datasets.get_dataset("cifar10"),
              parameters={"architecture": architecture, "z_dim": 8,
                          "lambda": 1, "disc_iters": 1},
              model_dir="unused", **kwargs)
    with pytest.raises(ValueError, match="no spatial layout"):
        gan.make_train_step(8, _grid())
