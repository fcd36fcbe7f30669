"""The spatial layout's band-aware ops (image height split over a model
group of workers), each against the same op on the whole image in one
process: four spawned gloo workers on the CPU, each op on a `1 x 2` grid
of the first two or a `1 x 4` grid of all four, every op's output, input
gradient, parameter gradients and state.

The ops are the port's own: the SAME conv at stride 1 and stride 2 (TF's
asymmetric pads, 1 above and 2 below, so the halos differ), 1x1, the
transposed SAME conv (also on bands of one row, as DCGAN's first map at
32 px gives them), the fused and unfused scale convs of the ResNet blocks,
batch norm and conditional batch norm (moments over the grid), the
non-local block (the kernels' plain version on the band's queries against
the keys of both bands), a linear layer on a band's flattened features and
the sum pooling of BigGAN's D and the mean pooling of the ResNets' Ds,
layer norm and EvoNorm-S0 (each image's moments over its bands), batch
norm with num_batch_groups, the quarter-turns of SSGAN and S3GAN
(`rotate_bands`), the per-image slope of the gradient penalties through a
conv with halos (its input and parameter gradients are second order), and
a mean over the global batch with a given count (`batch_mean`), whose
shares must sum to the mean over the grid.

Partial replication, each op on the smallest map that reaches it: a whole
map whose height does not split stays whole (a conv on 6 rows over four
ranks); a stride-2 conv and the fused down conv on bands of 3 rows; a
transposed conv from bands of 1 row to 7 rows, and from a whole map of 7
rows back to bands; the 2x2 average pool of bands of 3 rows and the sum of
its whole output; the non-local block on a 12-row map over four ranks
(bands of 3 rows: phi and g pooled whole); layer norm, grouped batch norm
and a flattening linear layer on a whole map; the quarter-turns and the
penalties' slope of whole images. A band meeting a whole map,
and a map of neither kind, raise. The workers import torch and the port
only (`torch_helpers.run_spatial_ops`).

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

from compare_gan_torch.architectures import resnet_ops
from compare_gan_torch.ops import arch_ops
from compare_gan_torch.parallel import mesh_utils, tpu_ops

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """{"rank0": ..., "rank1": ...}: what each worker wrote."""
    workdir = str(tmp_path_factory.mktemp("spatial_ops"))
    inputs = {}
    for i, (name, (_, shape, _, _)) in enumerate(
            th._spatial_op_cases().items()):
        inputs[f"{name}/x"] = th.randn(shape, seed=10 + i)
        if name == "conditional_batch_norm":
            inputs[f"{name}/y"] = th.randn((shape[0], 3), seed=99)
    np.savez(os.path.join(workdir, "inputs.npz"), **inputs)
    port = str(mesh_utils.free_port())
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    code = ("import sys; from tests import torch_helpers as th; "
            f"th.run_spatial_ops(int(sys.argv[1]), {WORLD}, "
            "int(sys.argv[2]), "
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
    grid = th._spatial_op_cases()[name][3].get("ranks", 2)
    ranks = [results[f"rank{r}"] for r in range(grid)]
    single = {k[len(f"single/{name}/"):]: v
              for k, v in ranks[0].items()
              if k.startswith(f"single/{name}/")}
    bands = [{k[len(f"{name}/"):]: v for k, v in rank.items()
              if k.startswith(f"{name}/")} for rank in ranks]
    assert all(set(b) == set(single) for b in bands)
    banded = bands[0]["out"].shape != single["out"].shape
    for key, want in single.items():
        if key == "dx" or (key == "out" and banded):
            got = np.concatenate([b[key] for b in bands], axis=1)
        elif key.startswith("d:"):  # Each band's part of the gradient.
            got = sum(b[key] for b in bands)
        else:  # Whole on every worker: outputs, state.
            for b in bands[1:]:
                np.testing.assert_array_equal(b[key], bands[0][key],
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
    # A stride-2 conv and a 5x5 conv given a rank-4 tensor of neither kind:
    # the layer cannot tell a band from a whole map by its shape.
    (lambda: arch_ops.Conv2d(4, 5, 3, 3, 2, 2), (1, 3, 4, 4),
     "neither a band nor a whole map"),
    (lambda: arch_ops.Conv2d(4, 5, 5, 5), (1, 1, 4, 4),
     "neither a band nor a whole map"),
])
def test_a_band_the_layer_cannot_take_raises(build, shape, match):
    layer = build()
    layer.scope = "discriminator/layer"
    with mesh_utils.replica_context(_grid()):
        with pytest.raises(ValueError, match=match) as err:
            layer(torch.zeros(shape))
    assert "discriminator/layer" in str(err.value)


def test_an_odd_band_does_not_pool_in_place(monkeypatch):
    """The ResNets' and BigGAN-deep's average pool on a band of 3 rows: a
    2x2 cell would straddle two bands, so the bands are gathered and the
    whole map pooled; its 3 rows do not split into 2 bands, so it stays
    whole."""
    gathered = []

    def gather(x, dim=1):  # Band m of every rank holds m + 1 everywhere.
        gathered.append(tuple(x.shape))
        return tpu_ops.Whole(torch.cat([torch.ones_like(tpu_ops.plain(x)),
                                        2 * torch.ones_like(
                                            tpu_ops.plain(x))], dim))

    monkeypatch.setattr(tpu_ops, "gather_bands", gather)
    with mesh_utils.replica_context(_grid()):
        out = resnet_ops.avg_pool_2x2(tpu_ops.as_band(torch.zeros(1, 3, 4,
                                                                  2)))
    assert gathered == [(1, 3, 4, 2)]
    assert isinstance(out, tpu_ops.Whole) and out.shape == (1, 3, 2, 2)
    # The middle row pools a cell of both bands.
    assert tpu_ops.plain(out)[0, :, 0, 0].tolist() == [1.0, 1.5, 2.0]


def test_a_band_meeting_a_whole_map_raises():
    """A map's kind is part of it: a band and a whole map of the same
    shape (8 rows: a band of 16, or a whole map of 8) do not mix, a map of
    neither kind does not mix with one, and the helpers refuse the wrong
    kind."""
    with mesh_utils.replica_context(_grid(model_size=2)):
        band = tpu_ops.as_band(torch.ones(1, 8, 4, 2))
        whole = tpu_ops.split_bands(torch.ones(1, 7, 4, 2)[:, :1].expand(
            1, 8, 4, 2).contiguous()[:, :7])
        assert isinstance(whole, tpu_ops.Whole)
        assert tpu_ops.image_rows(band) == 16 and tpu_ops.image_rows(
            whole) == 7
        whole8 = tpu_ops.Whole(torch.ones(1, 8, 4, 2))
        with pytest.raises(ValueError, match="a band meets a whole map"):
            band + whole8
        with pytest.raises(ValueError, match="a band meets a whole map"):
            torch.cat([band, whole8])
        with pytest.raises(ValueError, match="neither a band nor"):
            band * torch.ones(1, 8, 4, 2)
        with pytest.raises(ValueError, match="neither a band nor"):
            tpu_ops.is_band(torch.ones(1, 8, 4, 2), "a layer")
        with pytest.raises(ValueError, match="no halo rows"):
            tpu_ops.exchange_halos(whole8, 1, 1)
        with pytest.raises(ValueError, match="not split again"):
            tpu_ops.split_bands(band)
        with pytest.raises(ValueError, match="whole already"):
            tpu_ops.gather_bands(whole8)
        # Results keep their kind; broadcast statistics of one row mix.
        assert isinstance(torch.relu(band) * torch.ones(1, 1, 1, 2),
                          tpu_ops.Band)
        assert isinstance((whole8 - whole8.mean(dim=(1, 2), keepdim=True)),
                          tpu_ops.Whole)
        # A linear layer's flattened features must fit the map's kind.
        layer = arch_ops.Linear(8 * 4 * 2, 1)
        layer.scope = "discriminator/fc"
        with pytest.raises(ValueError, match="do not meet a kernel"):
            layer.of_bands(band)
