"""The port's copy of the gin implementation (compare_gan_torch.config)
against the JAX package's: every example config parses to the same
bindings and macros, and consumed bindings give the same operative config."""

import glob
import os

import pytest

from compare_gan_tpu import config as jgin
from compare_gan_torch import config as tgin

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(REPO, "example_configs", "*.gin")))


@pytest.fixture(autouse=True)
def _clean():
    tgin.clear_config()
    jgin.clear_config()
    yield
    tgin.clear_config()
    jgin.clear_config()


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_example_config_parses_to_the_same_bindings(path):
    """All bindings and macros, printed as gin text (references as @name,
    macros as %name, values by repr)."""
    tgin.parse_config_files_and_bindings([path], ["options.z_dim = 7"])
    jgin.parse_config_files_and_bindings([path], ["options.z_dim = 7"])
    got = tgin.config_str()
    assert got == jgin.config_str()
    assert "options.z_dim = 7" in got


def test_configs_are_independent_and_inject_alike():
    """A binding in one package's config is invisible to the other's, and
    both inject and record it the same way."""
    def make(module):
        @module.configurable("cfg_probe")
        def probe(a=1, b=2, fn=None):
            return a, b, fn

        @module.configurable("cfg_target")
        def target():
            return "target"
        return probe

    t_probe, j_probe = make(tgin), make(jgin)
    text = "cfg_probe.a = 5\ncfg_probe.fn = @cfg_target\nk = 3\n" \
           "cfg_probe.b = %k\n"
    tgin.parse_config(text)
    assert j_probe() == (1, 2, None)
    jgin.parse_config(text)
    t, j = t_probe(), j_probe()
    assert t[:2] == j[:2] == (5, 3)
    assert t[2]() == j[2]() == "target"
    assert tgin.operative_config_str() == jgin.operative_config_str()
