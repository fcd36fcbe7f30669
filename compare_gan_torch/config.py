"""The port's gin-style configuration system: its own copy of the JAX
package's implementation (compare_gan_tpu/config.py), standard library only.

The port registers the same names as the JAX package
(`resnet_biggan.Generator`, `conditional_batch_norm`, `hinge`, ...) for its
own classes, so it keeps its own registry, bindings and macros; a process
that imports both packages holds two independent configs. The `.gin` syntax
is the reference's:

    options.architecture = "resnet_cifar_arch"
    loss.fn = @hinge
    penalty.fn = @no_penalty
    ModularGAN.g_lr = 0.0002
    G.batch_norm_fn = @conditional_batch_norm
    z = %z_dim

with a decorator-based registry, kwarg injection at call time, @references,
%macros and operative-config snapshots. tests/test_torch_config.py holds
every `example_configs/*.gin` to the same bindings as the JAX package.
"""

from __future__ import annotations

import ast
import contextlib
import os
import functools
import inspect
import re
import threading
from typing import Any, Callable, Dict, Optional

_REGISTRY: Dict[str, Callable] = {}
_BINDINGS: Dict[str, Dict[str, Any]] = {}
_MACROS: Dict[str, Any] = {}
_OPERATIVE: Dict[str, Dict[str, Any]] = {}
_lock = threading.RLock()


class ConfigError(Exception):
    pass


class _Reference:
    """`@name` — resolves lazily to the registered configurable."""

    def __init__(self, name: str, evaluated: bool = False):
        self.name = name
        self.evaluated = evaluated  # `@name()` form

    def resolve(self):
        try:
            fn = _REGISTRY[self.name]
        except KeyError:
            raise ConfigError(f"Reference @{self.name} is not a registered "
                              f"configurable.") from None
        return fn() if self.evaluated else fn

    def __repr__(self):
        return f"@{self.name}" + ("()" if self.evaluated else "")


class _Macro:
    def __init__(self, name: str):
        self.name = name

    def resolve(self):
        if self.name not in _MACROS:
            raise ConfigError(f"Macro %{self.name} is not defined.")
        return _resolve(_MACROS[self.name])

    def __repr__(self):
        return f"%{self.name}"


def _resolve(v):
    if isinstance(v, (_Reference, _Macro)):
        return v.resolve()
    if isinstance(v, list):
        return [_resolve(x) for x in v]
    if isinstance(v, tuple):
        return tuple(_resolve(x) for x in v)
    if isinstance(v, dict):
        return {k: _resolve(x) for k, x in v.items()}
    return v


def configurable(name_or_fn=None, *, name: Optional[str] = None,
                 denylist=()):
    """Register a function/class; bound kwargs are injected at call time."""

    def wrap(fn, reg_name):
        if inspect.isclass(fn):
            return _wrap_class(fn, reg_name, denylist)
        # Keep 'self' for plain functions: when the configurable is a
        # method, positional args include the instance and parameter
        # alignment must account for it.
        sig_params = _signature_params(fn, pop_self=False)
        has_var_kw = any(p.kind == inspect.Parameter.VAR_KEYWORD
                         for p in sig_params.values())

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            bound = _BINDINGS.get(reg_name, {})
            inject = {}
            for k, v in bound.items():
                if k in denylist:
                    continue
                if k in kwargs:
                    continue
                if not has_var_kw and k not in sig_params:
                    raise ConfigError(
                        f"Binding {reg_name}.{k} does not match a parameter "
                        f"of {fn.__qualname__} ({list(sig_params)}).")
                inject[k] = _resolve(v)
            # Positional args take precedence over injected kwargs —
            # but only parameters that CAN bind positionally count
            # (keyword-only params after *args keep their bindings).
            if args:
                positional = [
                    n for n, p in sig_params.items()
                    if p.kind in (inspect.Parameter.POSITIONAL_ONLY,
                                  inspect.Parameter.POSITIONAL_OR_KEYWORD)]
                for pn in positional[: len(args)]:
                    inject.pop(pn, None)
            if inject:
                with _lock:
                    _OPERATIVE.setdefault(reg_name, {}).update(
                        {k: bound[k] for k in inject})
            return fn(*args, **{**inject, **kwargs})

        wrapper.__gin_name__ = reg_name
        wrapper.__wrapped_fn__ = fn
        with _lock:
            _REGISTRY[reg_name] = wrapper
        return wrapper

    if callable(name_or_fn):
        return wrap(name_or_fn, name or name_or_fn.__name__)
    alias = name_or_fn if isinstance(name_or_fn, str) else name

    def deco(fn):
        w = wrap(fn, alias or fn.__name__)
        return w

    return deco


def _wrap_class(cls, reg_name, denylist):
    """Make a class configurable by wrapping its __init__ in place, so the
    class stays subclassable. Subclasses inherit injection for the params
    they pass through (bindings are looked up by the registered name)."""
    orig_init = cls.__init__
    sig_params = _signature_params(cls)
    has_var_kw = any(p.kind == inspect.Parameter.VAR_KEYWORD
                     for p in sig_params.values())

    @functools.wraps(orig_init)
    def new_init(self, *args, **kwargs):
        bound = _BINDINGS.get(reg_name, {})
        inject = {}
        for k, v in bound.items():
            if k in denylist or k in kwargs:
                continue
            if not has_var_kw and k not in sig_params:
                raise ConfigError(
                    f"Binding {reg_name}.{k} does not match a parameter of "
                    f"{cls.__name__}.__init__ ({list(sig_params)}).")
            inject[k] = _resolve(v)
        if args:
            positional = [
                n for n, p in sig_params.items()
                if p.kind in (inspect.Parameter.POSITIONAL_ONLY,
                              inspect.Parameter.POSITIONAL_OR_KEYWORD)]
            for pn in positional[: len(args)]:
                inject.pop(pn, None)
        if inject:
            with _lock:
                _OPERATIVE.setdefault(reg_name, {}).update(
                    {k: bound[k] for k in inject})
        orig_init(self, *args, **{**inject, **kwargs})

    new_init.__gin_wrapped__ = True
    cls.__init__ = new_init
    cls.__gin_name__ = reg_name
    with _lock:
        _REGISTRY[reg_name] = cls
    return cls


def _signature_params(fn, pop_self=True):
    target = fn.__init__ if inspect.isclass(fn) else fn
    try:
        sig = inspect.signature(target)
    except (TypeError, ValueError):
        return {}
    params = dict(sig.parameters)
    if pop_self:
        params.pop("self", None)
    return params


def register(name: str, obj: Any) -> None:
    """Register an external (non-wrapped) object for @name references."""
    with _lock:
        _REGISTRY[name] = obj


def get_configurable(name: str):
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ConfigError(f"No configurable named '{name}'.") from None


_SCOPE_ALIASES: Dict[str, str] = {}


def add_scope_alias(alias: str, canonical: str) -> None:
    """Make bindings under `alias.param` land on `canonical.param` (lets
    reference configs bind e.g. tf.train.AdamOptimizer.beta1)."""
    with _lock:
        _SCOPE_ALIASES[alias] = canonical


def _resolve_scope(scope_param: str):
    """(scope, param) with scope aliases applied — dotted scopes resolve
    by longest registered alias (e.g. 'tf.train.AdamOptimizer.beta1' has
    scope 'tf.train.AdamOptimizer')."""
    scope, param = scope_param.rsplit(".", 1)
    for alias in sorted(_SCOPE_ALIASES, key=len, reverse=True):
        if scope_param.startswith(alias + "."):
            return _SCOPE_ALIASES[alias], scope_param[len(alias) + 1:]
    return scope, param


def bind(scope_param: str, value: Any) -> None:
    """bind('ModularGAN.g_lr', 1e-4)"""
    scope, param = _resolve_scope(scope_param)
    with _lock:
        _BINDINGS.setdefault(scope, {})[param] = value


def query(scope_param: str, default=None):
    # Same alias resolution as bind(), else aliased reads silently miss.
    scope, param = _resolve_scope(scope_param)
    b = _BINDINGS.get(scope, {})
    if param in b:
        return _resolve(b[param])
    return default


def define_macro(name: str, value: Any) -> None:
    _MACROS[name] = value


def clear_config() -> None:
    with _lock:
        _BINDINGS.clear()
        _MACROS.clear()
        _OPERATIVE.clear()


@contextlib.contextmanager
def config_scope(text: Optional[str] = None, replace: bool = True):
    """Run a block under a temporary config, restoring the process's
    bindings/macros on exit.

    With `replace=True` (default) the scope starts from a CLEAN config
    and applies only `text` — used by export loading so a module built
    from its export_config.gin snapshot neither sees nor clobbers the
    live process bindings (with lazy architecture injection, the last of
    two loaded exports would otherwise win)."""
    with _lock:
        saved = ({k: dict(v) for k, v in _BINDINGS.items()},
                 dict(_MACROS),
                 {k: dict(v) for k, v in _OPERATIVE.items()})
    try:
        if replace:
            clear_config()
        if text:
            parse_config(text)
        yield
    finally:
        with _lock:
            _BINDINGS.clear(), _BINDINGS.update(saved[0])
            _MACROS.clear(), _MACROS.update(saved[1])
            _OPERATIVE.clear(), _OPERATIVE.update(saved[2])


# ---------------------------------------------------------------------------
# Parser
# ---------------------------------------------------------------------------

_TOKEN_REF = re.compile(r"@[A-Za-z_][\w./]*(\(\))?")
_TOKEN_MACRO = re.compile(r"%[A-Za-z_][\w.]*")
_STRING_LIT = re.compile(r"'(?:\\.|[^'\\])*'|\"(?:\\.|[^\"\\])*\"")


class _ConfigTransformer(ast.NodeTransformer):
    """Rewrites @ref / %macro placeholder Names back into objects."""

    def __init__(self, placeholders):
        self.placeholders = placeholders

    def visit_Name(self, node):
        if node.id in self.placeholders:
            return ast.copy_location(
                ast.Constant(value=self.placeholders[node.id]), node)
        raise ConfigError(f"Unknown identifier '{node.id}' in config value.")


def _parse_value(text: str):
    text = text.strip()
    placeholders: Dict[str, Any] = {}

    def sub_ref(m):
        tok = m.group(0)
        evaluated = tok.endswith("()")
        name = tok[1:-2] if evaluated else tok[1:]
        key = f"__ref_{len(placeholders)}__"
        placeholders[key] = _Reference(name, evaluated)
        return key

    def sub_macro(m):
        key = f"__macro_{len(placeholders)}__"
        placeholders[key] = _Macro(m.group(0)[1:])
        return key

    # Avoid rewriting inside string literals: values with no refs at all
    # short-circuit through literal_eval; otherwise string literals are
    # masked out before the @/% token substitution so a list like
    # ["a@b.com", @hinge] keeps its string element intact.
    try:
        return ast.literal_eval(text)
    except (ValueError, SyntaxError):
        pass
    strings: list = []

    def mask_str(m):
        strings.append(m.group(0))
        return f"__str_{len(strings) - 1}__"

    masked = _STRING_LIT.sub(mask_str, text)
    replaced = _TOKEN_MACRO.sub(sub_macro, _TOKEN_REF.sub(sub_ref, masked))
    # Single-pass unmask: replacement text is NOT rescanned, so a quoted
    # value whose content is itself placeholder-shaped (e.g. "__str_0__")
    # cannot be corrupted by later substitutions.
    # A placeholder-shaped token the masker never emitted (a literal
    # `__str_N__` outside quotes) is a config error, not a silent
    # substitution — and it can't be left for ast.parse to flag because
    # it parses as a plain identifier. The masker emits each index
    # exactly once, so ANY multiset mismatch (out-of-range index OR a
    # duplicate of an in-range one) means a stray user token.
    seen = [int(i) for i in re.findall(r"__str_(\d+)__", replaced)]
    if sorted(seen) != list(range(len(strings))):
        raise ConfigError(f"Bad value (stray placeholder-like token "
                          f"outside a string literal): {text!r}")
    replaced = re.sub(r"__str_(\d+)__",
                      lambda m: strings[int(m.group(1))], replaced)
    try:
        tree = ast.parse(replaced, mode="eval")
    except SyntaxError as e:
        raise ConfigError(f"Cannot parse config value: {text!r}") from e
    tree = _ConfigTransformer(placeholders).visit(tree)
    ast.fix_missing_locations(tree)
    try:
        return ast.literal_eval(tree)
    except (ValueError, SyntaxError):
        # Expressions like tuples of refs.
        code = compile(tree, "<config>", "eval")
        return eval(code, {"__builtins__": {}})  # noqa: S307 (literals only)


def _scan_line(line: str):
    """(text-before-any-comment, open-bracket balance), both computed with
    string-literal awareness so '#', '(' etc. inside quoted values don't
    truncate the line or derail continuation tracking."""
    balance = 0
    quote = None
    i = 0
    while i < len(line):
        ch = line[i]
        if quote:
            if ch == "\\":
                i += 2
                continue
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
        elif ch == "#":
            return line[:i], balance
        elif ch in "([{":
            balance += 1
        elif ch in ")]}":
            balance -= 1
        i += 1
    return line, balance


def parse_config(text: str, base_dir: Optional[str] = None,
                 _include_stack: Optional[set] = None) -> None:
    """Parse gin-format text: `scope.param = value`, `macro = value`,
    `import x` (ignored — module side effects only), `include 'f.gin'`
    (parsed recursively, relative to `base_dir`), comments.

    `_include_stack` is internal: the realpaths of includes currently
    being parsed, so a self- or mutual-include raises ConfigError instead
    of RecursionError. Diamond includes (the same file included twice on
    non-overlapping paths) remain legal, as in gin."""
    include_stack = _include_stack if _include_stack is not None else set()
    buf = ""
    balance = 0
    for raw in text.splitlines():
        line, line_balance = _scan_line(raw)
        if not line.strip():
            continue
        buf = (buf + " " + line.strip()) if buf else line.strip()
        balance += line_balance
        if balance > 0:  # Bracket continuation.
            continue
        stmt, buf, balance = buf, "", 0
        if stmt.startswith("import "):
            continue
        if stmt.startswith("include"):
            m = re.match(r"include\s+['\"](.+?)['\"]\s*$", stmt)
            if not m:
                raise ConfigError(f"Bad include line: {stmt!r}")
            path = m.group(1)
            if not os.path.isabs(path) and base_dir:
                path = os.path.join(base_dir, path)
            real = os.path.realpath(path)
            if real in include_stack:
                raise ConfigError(f"Include cycle detected: {path!r} is "
                                  "already being parsed.")
            include_stack.add(real)
            try:
                with open(path) as f:
                    parse_config(f.read(), base_dir=os.path.dirname(path),
                                 _include_stack=include_stack)
            finally:
                include_stack.discard(real)
            continue
        if "=" not in stmt:
            raise ConfigError(f"Bad config line: {stmt!r}")
        lhs, rhs = stmt.split("=", 1)
        lhs = lhs.strip()
        value = _parse_value(rhs)
        if "." in lhs:
            bind(lhs, value)
        else:
            define_macro(lhs, value)
    if buf:
        raise ConfigError(f"Unterminated config statement: {buf!r}")


def parse_config_files_and_bindings(files=None, bindings=None) -> None:
    for path in files or []:
        with open(path) as f:
            parse_config(f.read(),
                         base_dir=os.path.dirname(os.path.abspath(path)))
    for b in bindings or []:
        parse_config(b)


def config_str() -> str:
    """Full current config (all bindings + macros), gin-format."""
    lines = []
    for name in sorted(_MACROS):
        lines.append(f"{name} = {_format_value(_MACROS[name])}")
    for scope in sorted(_BINDINGS):
        for p in sorted(_BINDINGS[scope]):
            lines.append(f"{scope}.{p} = {_format_value(_BINDINGS[scope][p])}")
    return "\n".join(lines) + ("\n" if lines else "")


def operative_config_str() -> str:
    """Bindings actually consumed so far (reference:
    `operative_config-<step>.gin` snapshots, runner_lib.py:195-205)."""
    lines = []
    for scope in sorted(_OPERATIVE):
        for p in sorted(_OPERATIVE[scope]):
            lines.append(f"{scope}.{p} = {_format_value(_OPERATIVE[scope][p])}")
    return "\n".join(lines) + ("\n" if lines else "")


def _format_value(v) -> str:
    if isinstance(v, (_Reference, _Macro)):
        return repr(v)
    if isinstance(v, str):
        return repr(v)
    if callable(v) and hasattr(v, "__gin_name__"):
        return f"@{v.__gin_name__}"
    return repr(v)


def parse_operative_config(text: str) -> Dict[str, str]:
    """Parse an operative-config snapshot into {scope.param: raw_value}
    (used by the eval CSV writer, reference runner_lib.py:195-205)."""
    out = {}
    for raw in text.splitlines():
        line = raw.split("#", 1)[0].strip()
        if not line or "=" not in line:
            continue
        lhs, rhs = line.split("=", 1)
        out[lhs.strip()] = rhs.strip()
    return out
