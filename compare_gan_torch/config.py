"""The port's gin surface: a second, independent instance of the JAX
package's config implementation.

`compare_gan_tpu/config.py` keeps its registry, bindings and macros in module
globals, and registering a name twice silently replaces the first entry. The
port registers the same names (`resnet_biggan.Generator`,
`conditional_batch_norm`, `hinge`, ...) for its own classes, so it must not
share that registry with the JAX package in a process that imports both.
Loading the same source file a second time under another module name gives
the port its own globals without a copy of the code: the `.gin` files, the
parser and the operative-config snapshots behave exactly as in the JAX
package.
"""

from __future__ import annotations

import importlib.util
import os
import sys


def _load_second_instance():
    name = "compare_gan_torch._gin"
    if name in sys.modules:
        return sys.modules[name]
    spec_pkg = importlib.util.find_spec("compare_gan_tpu")
    if spec_pkg is None or not spec_pkg.submodule_search_locations:
        raise ImportError("compare_gan_tpu (the reference package holding "
                          "config.py) is not importable.")
    path = os.path.join(list(spec_pkg.submodule_search_locations)[0],
                        "config.py")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


_impl = _load_second_instance()

ConfigError = _impl.ConfigError
configurable = _impl.configurable
register = _impl.register
get_configurable = _impl.get_configurable
add_scope_alias = _impl.add_scope_alias
bind = _impl.bind
query = _impl.query
define_macro = _impl.define_macro
clear_config = _impl.clear_config
config_scope = _impl.config_scope
parse_config = _impl.parse_config
parse_config_files_and_bindings = _impl.parse_config_files_and_bindings
config_str = _impl.config_str
operative_config_str = _impl.operative_config_str
parse_operative_config = _impl.parse_operative_config
