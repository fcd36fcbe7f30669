"""The port stands alone: no module of compare_gan_torch (its data-parallel
`parallel/` modules included), and not chip_smoke.py, imports the JAX
package or looks it up by name or path; a worker the CLI spawns loads
neither; and none imports scikit-learn or matplotlib when it is imported
(the card's machine has neither: PRD's plot and GILBO's histogram import
matplotlib inside the functions that draw)."""

import ast
import glob
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_FILES = sorted(
    os.path.relpath(p, REPO) for p in
    glob.glob(os.path.join(REPO, "compare_gan_torch", "**", "*.py"),
              recursive=True)
    if "_build" not in os.path.relpath(p, REPO).split(os.sep)
) + ["chip_smoke.py"]
JAX_PACKAGE = "compare_gan_tpu"


def _mentions_jax_package(node):
    """A string (or f-string part) naming the JAX package as a module or a
    path."""
    for sub in ast.walk(node):
        if isinstance(sub, ast.Constant) and isinstance(sub.value, str) \
                and JAX_PACKAGE in sub.value:
            return True
    return False


def _offences(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                if alias.name.split(".")[0] == JAX_PACKAGE:
                    yield node.lineno, f"import {alias.name}"
        elif isinstance(node, ast.ImportFrom):
            if (node.module or "").split(".")[0] == JAX_PACKAGE:
                yield node.lineno, f"from {node.module} import ..."
        elif isinstance(node, ast.Call):
            # find_spec("compare_gan_tpu"), import_module(...),
            # os.path.join(ROOT, "compare_gan_tpu"), open(f".../{name}")
            args = list(node.args) + [k.value for k in node.keywords]
            if any(_mentions_jax_package(a) for a in args):
                yield node.lineno, ast.unparse(node)[:80]


@pytest.mark.parametrize("path", PORT_FILES)
def test_port_module_does_not_reach_the_jax_package(path):
    with open(os.path.join(REPO, path)) as f:
        tree = ast.parse(f.read(), filename=path)
    assert list(_offences(tree)) == []


def test_the_scan_finds_what_it_looks_for():
    code = ("import compare_gan_tpu.datasets\n"
            "from compare_gan_tpu import hooks\n"
            "import importlib.util, os\n"
            "importlib.util.find_spec('compare_gan_tpu')\n"
            "os.path.join(ROOT, 'compare_gan_tpu')\n"
            "x = {'replaces': 'compare_gan_tpu/ops/pallas_attention.py:90'}\n")
    assert [line for line, _ in _offences(ast.parse(code))] == [1, 2, 4, 5]


# Packages the card's machine lacks: a port module may import them only
# inside a function that nothing on the eval path calls.
OPTIONAL = ("sklearn", "matplotlib")


def _top_level_imports(tree):
    """Modules imported by statements that run at import time (module
    level, including its if/try blocks; not inside functions or classes)."""
    stack = list(tree.body)
    while stack:
        node = stack.pop()
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom):
            yield node.lineno, (node.module or "").split(".")[0]
        elif isinstance(node, (ast.If, ast.Try, ast.With)):
            for field in ("body", "orelse", "finalbody", "handlers"):
                stack.extend(getattr(node, field, []))
        elif isinstance(node, ast.ExceptHandler):
            stack.extend(node.body)


@pytest.mark.parametrize("path", PORT_FILES)
def test_port_module_imports_no_optional_package_at_import_time(path):
    with open(os.path.join(REPO, path)) as f:
        tree = ast.parse(f.read(), filename=path)
    assert [(line, name) for line, name in _top_level_imports(tree)
            if name in OPTIONAL] == []


def test_importing_every_port_module_loads_neither_jax_nor_optionals():
    """Every module of the port imported in a fresh interpreter: no jax,
    no module of the JAX package, no scikit-learn, no matplotlib."""
    modules = sorted(
        p[:-3].replace(os.sep, ".") for p in PORT_FILES
        if p.startswith("compare_gan_torch") and not p.endswith(
            "__main__.py"))
    code = ("import importlib, sys\n"
            f"for name in {modules!r}:\n"
            "    importlib.import_module(name.replace('.__init__', ''))\n"
            "loaded = {m.split('.')[0] for m in sys.modules}\n"
            "print(sorted(loaded & {'jax', 'jaxlib', 'compare_gan_tpu', "
            "'sklearn', 'matplotlib'}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_the_optional_scan_finds_what_it_looks_for():
    code = ("import numpy\n"
            "try:\n"
            "    import matplotlib\n"
            "except ImportError:\n"
            "    from sklearn import cluster\n"
            "def plot():\n"
            "    import matplotlib.pyplot\n")
    found = sorted(_top_level_imports(ast.parse(code)))
    assert found == [(1, "numpy"), (3, "matplotlib"), (5, "sklearn")]


def test_parallel_modules_are_scanned():
    assert {"compare_gan_torch/parallel/__init__.py",
            "compare_gan_torch/parallel/mesh_utils.py",
            "compare_gan_torch/parallel/tpu_ops.py"} <= set(
                p.replace(os.sep, "/") for p in PORT_FILES)


def test_a_spawned_worker_loads_no_jax(tmp_path):
    """`--num_devices=2` spawns two workers with torch.multiprocessing;
    every process of the launch (the parent and both workers, each a
    fresh interpreter) lists the modules it imports
    (PYTHONPROFILEIMPORTTIME), and none is jax, optax or of the JAX
    package."""
    argv = [sys.executable, "-m", "compare_gan_torch.main",
            f"--model_dir={tmp_path}", "--device=cpu", "--num_devices=2",
            "--data_fake_dataset",
            "--gin_bindings=dataset.name = 'cifar10'",
            "--gin_bindings=options.architecture = 'dummy_arch'",
            "--gin_bindings=options.batch_size = 2",
            "--gin_bindings=options.gan_class = @ModularGAN",
            "--gin_bindings=options.training_steps = 1"]
    env = dict(os.environ, PYTHONPATH=REPO, PYTHONPROFILEIMPORTTIME="1",
               OMP_NUM_THREADS="1")
    out = subprocess.run(argv, cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-4000:]
    for rank in (0, 1):
        assert f"rank {rank} INFO Finished schedule train." in out.stderr
    imported = {line.rsplit("|", 1)[-1].strip().split(".")[0]
                for line in out.stderr.splitlines()
                if line.startswith("import time:")}
    assert "torch" in imported
    assert not imported & {"jax", "jaxlib", "optax", JAX_PACKAGE}
