"""The port's serving path, f32 on the CPU: the attention forward as the
registered operator `compare_gan::attention_fwd`, and G exported by
`export.export_serving_program` and loaded by `serving.load_serving_program`
in a fresh process, against the JAX package's `gan.sample` on the same
weights and against its jax2tf SavedModel's `gen_bs8`.

The JAX side runs attention through its plain einsum reference (its CPU
default); the Pallas kernel is held against the port in
tests/test_torch_attention.py."""

import dataclasses
import json
import os
import subprocess
import sys
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_helpers as th

from compare_gan_tpu import config as jgin
from compare_gan_tpu import datasets as jdatasets
from compare_gan_tpu import export as jexport
from compare_gan_tpu.gans import modular_gan as jmodular
from compare_gan_torch import config as tgin
from compare_gan_torch import datasets, export, interop, serving
from compare_gan_torch.gans import modular_gan
from compare_gan_torch.ops import fused_attention as fa

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATTENTION_OP = torch.ops.compare_gan.attention_fwd.default
# BigGAN-32 with attention at B2 (tests/test_torch_biggan.py's bindings). At
# ch 64 G's weights (~17 MB) outweigh the program's graph (~2 MB, the same
# at any width), so the artifact's size says whether they are stored once.
CFG = """
loss.fn = @hinge
penalty.fn = @no_penalty
weights.initializer = "orthogonal"
spectral_norm.singular_value = "auto"
standardize_batch.decay = 0.9
standardize_batch.epsilon = 1e-5
standardize_batch.use_moving_averages = False
ModularGAN.conditional = True
ModularGAN.g_use_ema = True
G.batch_norm_fn = @conditional_batch_norm
G.spectral_norm = True
D.spectral_norm = True
resnet_biggan.Generator.ch = 64
resnet_biggan.Generator.blocks_with_attention = "B2"
resnet_biggan.Discriminator.ch = 4
"""
PARAMETERS = {"architecture": "resnet_biggan_arch", "z_dim": 16,
              "lambda": 1}
BATCH_SIZES = (8, 16)
# Labels of the served batch: -1 and num_classes (10) are all-zero rows, as
# jax.nn.one_hot makes them.
LABELS = np.array([-1, 3, 10, 0, 9, 5, 5, 1, 2, 7, 4, 6, 8, -1, 0, 3],
                  np.int32)
# f32 G forwards of ~15 conv/BN layers on two CPU backends (XLA, oneDNN),
# as in tests/test_torch_eval.py.
RTOL, ATOL = 1e-4, 1e-5

# Runs in a fresh interpreter: load the program on the CPU, run every
# signature and a wrong batch size, and report the port's modules loaded.
SERVE = """
import json, sys
import numpy as np
from compare_gan_torch import serving
d = sys.argv[1]
with np.load(d + "/inputs.npz") as f:
    z, labels = f["z"], f["labels"]
spec, signatures = serving.load_serving_program(d, device="cpu")
out = {name: signatures[name](z[:bs], labels[:bs]).numpy()
       for name, bs in spec["signatures"].items()}
try:
    signatures["gen_bs8"](z[:4], labels[:4])
    wrong = "ran"
except ValueError as e:
    wrong = str(e)
np.savez(d + "/outputs.npz", **out)
print(json.dumps({"wrong_batch": wrong, "signatures": sorted(signatures),
                  "modules": sorted(m for m in sys.modules
                                    if m.startswith("compare_gan_torch"))}))
"""


def _jax_and_port_gans(cfg, parameters, model_dir="unused"):
    jgin.parse_config(cfg + "attention.use_pallas = False\n")
    tgin.parse_config(cfg)
    jgan = jmodular.ModularGAN(
        dataset=jdatasets.get_dataset("cifar10"), parameters=parameters,
        model_dir=model_dir)
    tgan = modular_gan.ModularGAN(
        dataset=datasets.get_dataset("cifar10"), parameters=parameters,
        model_dir=model_dir, device="cpu")
    return jgan, tgan


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """JAX `gan.sample` on a TrainState with the attention gates opened,
    EMA shadows unlike the weights and filled accumulators; the port's
    TrainState holding the same values; the serving program exported from
    it, and what a fresh process served from it."""
    for module in (datasets, jdatasets):
        module.set_fake_dataset(True)
    tgin.clear_config()
    try:
        jgan, tgan = _jax_and_port_gans(CFG, PARAMETERS)
        ts_j = jax.jit(lambda key: jgan.init_state(key, 4))(
            jax.random.PRNGKey(0))
        def gated(tree, gate):
            return {k: (jnp.float32(gate) if k.endswith(
                "non_local_block/sigma") else v) for k, v in tree.items()}

        ts_j = dataclasses.replace(
            ts_j, params=gated(ts_j.params, 0.5),
            ema_params=gated({k: v * 0.9 for k, v in
                              ts_j.ema_params.items()}, 0.4),
            state=th.filled_accumulators(ts_j.state, 1))
        ts_t = tgan.init_state(seed=1)
        interop.load_state_dict(ts_t, interop.params_from_jax(
            ts_j.params, ts_j.state, ts_j.ema_params))
        z = th.randn((max(BATCH_SIZES), 16), 0)
        want, _ = jax.jit(lambda ts, zz, yy: jgan.sample(
            ts, zz, labels=yy))(ts_j, z, LABELS)
        d = str(tmp_path_factory.mktemp("serving"))
        export.export_serving_program(tgan, ts_t, d, BATCH_SIZES)
        np.savez(os.path.join(d, "inputs.npz"), z=z, labels=LABELS)
        proc = subprocess.run(
            [sys.executable, "-c", SERVE, d], cwd=REPO,
            env=dict(os.environ, PYTHONPATH=REPO), capture_output=True,
            text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr
        report = json.loads(proc.stdout.strip().splitlines()[-1])
        with np.load(os.path.join(d, "outputs.npz")) as f:
            outputs = dict(f)
        yield dict(jax_images=np.asarray(want), tgan=tgan, ts_t=ts_t, dir=d,
                   z=z, report=report, outputs=outputs)
    finally:
        for module in (datasets, jdatasets):
            module.set_fake_dataset(False)
        tgin.clear_config()


# -- the registered operator ------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_op_on_the_cpu_is_the_plain_forward(dtype):
    theta = torch.from_numpy(th.randn((2, 64, 8), 0)).to(dtype)
    phi = torch.from_numpy(th.randn((2, 16, 8), 1)).to(dtype)
    g = torch.from_numpy(th.randn((2, 16, 24), 2)).to(dtype)
    got = ATTENTION_OP(theta, phi, g)
    for a, b in zip(got, fa.attention_fwd_plain(theta, phi, g)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert got[0].dtype == dtype and got[1].dtype == torch.float32
    torch.library.opcheck(ATTENTION_OP, (theta, phi, g))
    # BigGAN-512's width (C 48, Cg 192) is taken, and so is one past a
    # chunk of the kernels' C: BigGAN-128's G block B1 with the attention
    # on the 8x8 map (C 192, Cg 768), the plain forward on the CPU.
    wide = [torch.zeros(1, n, w) for n, w in ((4, 48), (2, 48), (2, 192))]
    assert tuple(ATTENTION_OP(*wide)[0].shape) == (1, 4, 192)
    wide = [torch.from_numpy(th.randn(shape, seed)).to(dtype) for seed, shape
            in enumerate(((1, 64, 192), (1, 16, 192), (1, 16, 768)))]
    got = ATTENTION_OP(*wide)
    assert tuple(got[0].shape) == (1, 64, 768)
    for a, b in zip(got, fa.attention_fwd_plain(*wide)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_attention_op_fake_shapes_at_a_symbolic_batch():
    """`fused_attention` under torch.export is one node of the operator;
    its fake implementation gives out [B, N, Cg] in the input type and
    mx, den [B, N, 1] f32 for a symbolic B, and a forward launch count of
    0 (tracing runs no kernel and no plain version)."""

    class Attend(torch.nn.Module):
        def forward(self, theta, phi, g):
            return fa.fused_attention(theta, phi, g)

    batch = torch.export.Dim("batch", min=1, max=64)
    args = (torch.zeros(3, 64, 8), torch.zeros(3, 16, 8),
            torch.zeros(3, 16, 24))
    launches = fa.launches_fwd
    program = torch.export.export(
        Attend(), args, dynamic_shapes=({0: batch}, {0: batch}, {0: batch}))
    assert fa.launches_fwd == launches
    nodes = [n for n in program.graph.nodes if n.target == ATTENTION_OP]
    assert len(nodes) == 1
    out, mx, den = nodes[0].meta["val"]
    assert isinstance(out.shape[0], torch.SymInt)
    assert tuple(out.shape[1:]) == (64, 24) and out.dtype == torch.float32
    for t in (mx, den):
        assert tuple(t.shape[1:]) == (64, 1) and t.dtype == torch.float32
    theta, phi, g = (torch.from_numpy(th.randn(tuple(a.shape[1:]), i)
                                      ).expand(5, -1, -1).contiguous()
                     for i, a in enumerate(args))
    th.assert_close(program.module()(theta, phi, g),
                    fa.reference_attention(theta, phi, g),
                    rtol=1e-5, atol=1e-6)


# -- the serving program ----------------------------------------------------

def test_served_program_matches_the_jax_generator(served):
    """Every signature's images from the fresh process equal JAX
    `gan.sample` on the same weights (EMA shadows, filled accumulators),
    labels -1 and num_classes included."""
    z = served["z"]
    assert served["report"]["signatures"] == ["gen_bs16", "gen_bs8"]
    for bs in BATCH_SIZES:
        got = served["outputs"][f"gen_bs{bs}"]
        assert got.shape == (bs, 32, 32, 3) and got.dtype == np.float32
        th.assert_close(got, served["jax_images"][:bs], RTOL, ATOL,
                        what=f"gen_bs{bs}")
    # The zero rows differ from the rows of a real class.
    zero = served["tgan"].sample(served["ts_t"], z[:1], np.array([-1]))
    cls0 = served["tgan"].sample(served["ts_t"], z[:1], np.array([0]))
    th.assert_close(served["outputs"]["gen_bs8"][:1], zero, RTOL, ATOL)
    assert not np.allclose(th.np32(zero), th.np32(cls0), atol=1e-3)


def test_serving_process_loads_no_model_code(served):
    modules = served["report"]["modules"]
    assert "compare_gan_torch.serving" in modules
    assert "compare_gan_torch.ops.fused_attention" in modules
    for part in ("architectures", "gans", "config", "runner_lib",
                 "eval_gan_lib", "export", "ops.arch_ops"):
        assert not [m for m in modules
                    if m.startswith(f"compare_gan_torch.{part}")], part


def test_a_wrong_batch_size_raises(served):
    assert "gen_bs8 takes z [8, 16]" in served["report"]["wrong_batch"]
    _, signatures = serving.load_serving_program(served["dir"], "cpu")
    with pytest.raises(ValueError, match="labels \\[16\\]"):
        signatures["gen_bs16"](served["z"], LABELS[:8])
    with pytest.raises(TypeError, match="float32"):
        signatures["gen_bs8"](served["z"][:8].astype(np.float64),
                              LABELS[:8])


def test_program_holds_one_attention_node_per_non_local_block(served):
    program = torch.export.load(os.path.join(served["dir"],
                                             serving.SERVING_PROGRAM))
    blocks = [m for m in served["ts_t"].generator.modules()
              if type(m).__name__ == "NonLocalBlock"]
    nodes = [n for n in program.graph.nodes if n.target == ATTENTION_OP]
    assert len(blocks) == 1 and len(nodes) == len(blocks)


def test_artifact_stores_the_weights_once(served):
    """One program for every signature: the artifact is within 1.25x of
    one copy of G's inference params and state."""
    ts = served["ts_t"]
    weights = sum(v.numel() * v.element_size() for k, v in {
        **served["tgan"]._inference_params(ts), **ts.state()}.items()
        if k.startswith("generator/"))
    path = os.path.join(served["dir"], serving.SERVING_PROGRAM)
    assert zipfile.is_zipfile(path)
    size = os.path.getsize(path)
    assert weights < size <= 1.25 * weights, (size, weights)


def test_spec_and_cuda_without_a_card(served, monkeypatch):
    with open(os.path.join(served["dir"], serving.SERVING_SPEC)) as f:
        spec = json.load(f)
    assert spec == {"signatures": {"gen_bs8": 8, "gen_bs16": 16},
                    "z_dim": 16, "conditional": True, "num_classes": 10,
                    "image_shape": [32, 32, 3], "dtype": "float32",
                    "step": 0}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA was asked for"):
        serving.load_serving_program(served["dir"], device="cuda")


def test_a_state_of_another_gan_object_serves_its_own_weights(tmp_path):
    """The program serves the G of the state it is given, also when that
    state was built by a second GAN object of the same config (as the
    CLI's in-memory state is, or a checkpoint restored elsewhere): its
    images equal `gan.sample(ts, ...)`, not those of the exporting GAN's
    own modules."""
    datasets.set_fake_dataset(True)
    tgin.clear_config()
    try:
        tgin.parse_config("ModularGAN.conditional = True\n"
                          "ModularGAN.g_use_ema = True\n")
        parameters = {"architecture": "dummy_arch", "z_dim": 8, "lambda": 1}
        gans = [modular_gan.ModularGAN(
            dataset=datasets.get_dataset("cifar10"), parameters=parameters,
            model_dir="unused", device="cpu") for _ in range(2)]
        gans[0].init_state(seed=1)
        ts = gans[1].init_state(seed=2)
        ts.ema_params = {k: v * 0.5 for k, v in ts.ema_params.items()}
        export.export_serving_program(gans[0], ts, str(tmp_path), (8,))
        z = th.randn((8, 8), 3)
        labels = LABELS[:8]
        want = th.np32(gans[0].sample(ts, z, labels))
        own = th.np32(gans[0].sample(gans[0].init_state(seed=1), z, labels))
    finally:
        datasets.set_fake_dataset(False)
        tgin.clear_config()
    _, signatures = serving.load_serving_program(str(tmp_path), "cpu")
    got = th.np32(signatures["gen_bs8"](z, labels))
    assert not np.allclose(want, own, atol=1e-3)
    # One f32 linear layer and a sigmoid, traced and eager.
    th.assert_close(got, want, rtol=0, atol=1e-6)


# -- against the JAX package's jax2tf SavedModel ----------------------------

def test_program_matches_the_jax_saved_model_gen_bs8(tmp_path):
    """The JAX SavedModel test's own case (dummy_arch, conditional, z_dim
    8): the port's program on the same weights gives its gen_bs8 images."""
    tf = pytest.importorskip("tensorflow")
    for module in (datasets, jdatasets):
        module.set_fake_dataset(True)
    tgin.clear_config()
    try:
        parameters = {"architecture": "dummy_arch", "z_dim": 8, "lambda": 1}
        jgan, tgan = _jax_and_port_gans("ModularGAN.conditional = True\n",
                                        parameters)
        ts_j = jgan.init_state(jax.random.PRNGKey(0), 8)
        ts_t = tgan.init_state(seed=1)
        interop.load_state_dict(ts_t, interop.params_from_jax(
            ts_j.params, ts_j.state, ts_j.ema_params))
        jexport.export_saved_model(jgan, ts_j, str(tmp_path / "tf"),
                                   batch_sizes=(8,))
        export.export_serving_program(tgan, ts_t, str(tmp_path / "pt"),
                                      batch_sizes=(8,))
    finally:
        for module in (datasets, jdatasets):
            module.set_fake_dataset(False)
        tgin.clear_config()
    z = np.random.RandomState(0).uniform(-1, 1, (8, 8)).astype(np.float32)
    labels = (np.arange(8) % 10).astype(np.int32)
    loaded = tf.saved_model.load(str(tmp_path / "tf"))
    out = loaded.signatures["gen_bs8"](z=tf.constant(z),
                                       labels=tf.constant(labels))
    want = list(out.values())[0].numpy()
    _, signatures = serving.load_serving_program(str(tmp_path / "pt"),
                                                 "cpu")
    assert set(signatures) == {"gen_bs8"}
    # One f32 linear layer and a sigmoid: the JAX test's own 1e-5.
    th.assert_close(signatures["gen_bs8"](z, labels), want, rtol=0,
                    atol=1e-5)
