"""The reference's own test scenarios, retargeted at the port.

:func:`retarget` loads one of the JAX package's test modules with every
``fedml_tpu.`` import rewritten to ``fedml_tpu_torch.``, so its test
classes and functions exercise the port's modules with the reference's
own inputs and asserts. A port test file binds the ones it runs into its
namespace, where pytest collects them; the reference's file keeps
running against the reference."""

import os
import re
import types

HERE = os.path.dirname(os.path.abspath(__file__))
_IMPORT = re.compile(r"\bfedml_tpu\.")


def retarget(filename, drop=()):
    """The reference test module ``tests/<filename>`` executed against the
    port, as a module object. ``drop`` names imported names the port
    does not have yet (each ``name, `` is cut from the source), for a
    module whose bound tests do not use them."""
    path = os.path.join(HERE, filename)
    with open(path) as f:
        src = _IMPORT.sub("fedml_tpu_torch.", f.read())
    for name in drop:
        src, n = re.subn(rf"\b{name},\s*", "", src)
        assert n, (filename, name)
    mod = types.ModuleType("port_" + filename[:-3])
    mod.__file__ = path
    exec(compile(src, path, "exec"), mod.__dict__)
    return mod
