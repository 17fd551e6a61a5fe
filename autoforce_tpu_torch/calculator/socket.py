"""Oracle scripts loaded in-process (the ``get_scope`` of
``autoforce_tpu/calculator/socket.py``).

The TCP socket calculator and its server (``inprocess=False`` on the
command line) are not ported yet.
"""

from __future__ import annotations

import importlib
import importlib.util
import os

_imported = {}


def _dotted_name(script):
    """Dotted module name when ``script`` lives inside this package (the
    file-location loader cannot resolve those modules' imports); None for
    arbitrary user scripts."""
    import autoforce_tpu_torch

    pkg_dir = os.path.dirname(os.path.abspath(autoforce_tpu_torch.__file__))
    path = os.path.abspath(script)
    if not path.startswith(pkg_dir + os.sep) or not path.endswith(".py"):
        return None
    rel = os.path.relpath(path, os.path.dirname(pkg_dir))
    return rel[: -len(".py")].replace(os.sep, ".")


def get_scope(script, device="cuda"):
    """Load {'calc', 'preprocess_atoms'?, 'postprocess_atoms'?} from a
    python script (module-import cache, calc_server.py:37-53).  A script
    that defines ``make_calc(device)`` (the package's oracle scripts) gets
    its oracle built on ``device``; any other must define ``calc``."""
    if script not in _imported:
        name = _dotted_name(script)
        if name is not None:
            mod = importlib.import_module(name)
        else:
            spec = importlib.util.spec_from_file_location(
                "_oracle_import", script
            )
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
        _imported[script] = mod
    mod = _imported[script]
    make = getattr(mod, "make_calc", None)
    scope = {"calc": make(device) if make is not None else mod.calc}
    for hook in ("preprocess_atoms", "postprocess_atoms"):
        if hasattr(mod, hook):
            scope[hook] = getattr(mod, hook)
    return scope
