"""The reference's own test scenarios, retargeted at the port.

:func:`retarget` loads one of the JAX package's test modules with every
``fedml_tpu.`` import rewritten to ``fedml_tpu_torch.``, so its test
classes and functions exercise the port's modules with the reference's
own inputs and asserts. A port test file binds the ones it runs into its
namespace, where pytest collects them; the reference's file keeps
running against the reference. :func:`retarget_defs` does the same for a
few top-level classes or functions of a module whose other imports the
port lacks."""

import ast
import os
import re
import types

HERE = os.path.dirname(os.path.abspath(__file__))
_IMPORT = re.compile(r"\bfedml_tpu\.")


def _module(filename, src, env):
    path = os.path.join(HERE, filename)
    mod = types.ModuleType("port_" + filename[:-3])
    mod.__file__ = path
    mod.__dict__.update(env or {})
    exec(compile(src, path, "exec"), mod.__dict__)
    return mod


def retarget(filename, drop=(), subs=(), env=None):
    """The reference test module ``tests/<filename>`` executed against the
    port, as a module object. ``drop`` names imported names the port
    does not have yet (each ``name, `` is cut from the source), for a
    module whose bound tests do not use them. ``subs`` are further
    ``(pattern, replacement)`` rewrites of the source, each required to
    match, and ``env`` names the module globals they refer to: the
    port's counterpart of a JAX API (``jax.profiler``'s
    ``start_trace``/``stop_trace`` are ``utils/profiling.py``'s)."""
    with open(os.path.join(HERE, filename)) as f:
        src = _IMPORT.sub("fedml_tpu_torch.", f.read())
    for name in drop:
        src, n = re.subn(rf"\b{name},\s*", "", src)
        assert n, (filename, name)
    for pattern, repl in subs:
        src, n = re.subn(pattern, repl, src)
        assert n, (filename, pattern)
    return _module(filename, src, env)


def retarget_defs(filename, names, subs=(), env=None):
    """Only the top-level classes and functions ``names`` of the
    reference test module ``tests/<filename>``, with the module's plain
    ``import x`` statements, retargeted as :func:`retarget` does (its
    ``subs`` and ``env`` too); for definitions that import what they use
    inside their bodies, or whose other names ``env`` binds."""
    with open(os.path.join(HERE, filename)) as f:
        full = f.read()
    tree = ast.parse(full)
    keep = [node for node in tree.body
            if isinstance(node, ast.Import)
            or (isinstance(node, (ast.ClassDef, ast.FunctionDef))
                and node.name in names)]
    found = {n.name for n in keep if not isinstance(n, ast.Import)}
    assert found == set(names), (filename, set(names) - found)
    lines = full.splitlines()
    parts = []
    for node in keep:
        start = min([node.lineno] + [d.lineno for d in
                                     getattr(node, "decorator_list", [])])
        # blank lines keep the reference's line numbers in tracebacks
        parts.append((start, "\n".join(lines[start - 1:node.end_lineno])))
    src, line = "", 1
    for start, text in parts:
        src += "\n" * (start - line) + text
        line = start + text.count("\n")
    src = _IMPORT.sub("fedml_tpu_torch.", src)
    for pattern, repl in subs:
        src, n = re.subn(pattern, repl, src)
        assert n, (filename, pattern)
    return _module(filename, src, env)
