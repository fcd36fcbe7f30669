"""The port stands alone: no module of compare_gan_torch, and not
chip_smoke.py, imports the JAX package or looks it up by name or path."""

import ast
import glob
import os

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
