"""Command-line layer (port of ``autoforce_tpu/cl/__init__.py``,
counterpart of theforce/cl/__init__.py).

Reads an ``ARGS`` file from the working directory — one ``key = value``
python expression per line, ``#`` comments — and exposes
:func:`gen_active_calc`, which merges ARGS over the ActiveCalculator's
signature defaults.  ``calculator=`` accepts 'EMT' | 'LJ' | 'ZERO' |
'VASP' | 'GAUSSIAN' | a path to a script.  The oracle runs in this
process, or with ``inprocess = False`` in a calculation server
(``python -m autoforce_tpu_torch.calculator.calc_server``) reached through
a :class:`~autoforce_tpu_torch.calculator.socket.SocketCalculator` at
``socket_ip`` / ``socket_port`` (default localhost:6666, the server's
default).

Two ARGS keys place the work: ``calc_device`` is the torch device of the
calculator and the in-process oracle (the card unless ``calc_device =
'cpu'``), and ``dtype = 'float64'`` names the working type.  ``device``
keeps the JAX package's meaning: ``device = True`` is cl.neb's switch to
the device NEB, and it places nothing.  ``mesh = make_mesh(...)`` shards
the calculator's predictions and the device drivers over a device mesh
(:mod:`..parallel.mesh`; its first device must be ``calc_device``, e.g.
``make_mesh(data=2, model=2, devices=['cuda:0'] * 4)`` on one card).

:func:`refresh` reads the file; the entry points (``python -m
autoforce_tpu_torch.cl.{md,relax,neb,train,test,offline,init_model,
singlepoint,build,shrink,lmp}``) call it first.
"""

from __future__ import annotations

import inspect
import os

from ..calculator.active import ActiveCalculator

# unit names available inside ARGS expressions (the reference imports
# kcal_mol into its cl namespace for exactly this, theforce/cl/__init__.py:16)
from ..units import GPa, bar, fs, kB, kcal_mol  # noqa: F401

# make_mesh so that `mesh = make_mesh(data=2, model=2)` works in ARGS
from ..parallel import make_mesh  # noqa: F401


def strip(line):
    if "#" in line:
        line = line[: line.index("#")]
    return line.strip()


def read_args(path="ARGS"):
    args = {}
    if os.path.isfile(path):
        with open(path) as f:
            lines = [strip(line) for line in f.readlines()]
        lines = ",".join(filter("".__ne__, lines))
        args.update(eval(f"dict({lines})"))  # noqa: S307 (reference format)
    return args


def _calc_script(name):
    if name.endswith(".py"):
        return name
    caps = name.upper()
    from ..calculator import scripts

    base = os.path.dirname(scripts.__file__)
    table = {"EMT": "emt.py", "LJ": "lj.py", "ZERO": "zero.py"}
    if caps in table:
        return os.path.join(base, table[caps])
    if caps == "VASP":
        from ..calculator import vasp

        return vasp.__file__
    if caps == "GAUSSIAN":
        from ..calculator import gaussian

        return gaussian.__file__
    raise RuntimeError(f"calculator {caps} is not implemented")


def resolve_calculator(value, inprocess=True, device="cuda", ip="localhost",
                       port=6666):
    if value is None or not isinstance(value, str):
        return value
    script = _calc_script(value)
    if inprocess:
        from ..calculator.socket import get_scope

        return get_scope(script, device=device)["calc"]
    from ..calculator.socket import SocketCalculator

    return SocketCalculator(ip=ip, port=port, script=script)


ARGS = {}


def refresh(path="ARGS"):
    """(Re)read the ARGS file from the current working directory."""
    ARGS.clear()
    ARGS.update(read_args(path))
    if isinstance(ARGS.get("dtype"), str):
        # the working type by name ('float32' | 'float64'): ARGS
        # expressions cannot name torch objects
        import torch

        ARGS["dtype"] = getattr(torch, ARGS["dtype"])
    inprocess = ARGS.pop("inprocess", True)
    if ARGS.get("calculator") is not None:
        ARGS["calculator"] = resolve_calculator(
            ARGS["calculator"], inprocess=inprocess, device=calc_device(),
            ip=ARGS.get("socket_ip", "localhost"),
            port=ARGS.get("socket_port", 6666),
        )
    return ARGS


def calc_device():
    """The torch device of the calculator and the oracle: ARGS'
    ``calc_device``, the card by default."""
    return ARGS.get("calc_device", "cuda")


def get_default_args(func):
    sig = inspect.signature(func)
    return {
        k: v.default
        for k, v in sig.parameters.items()
        if v.default is not inspect.Parameter.empty
    }


def update_args(kwargs, source=None):
    if source is None:
        source = ARGS
    for kw in kwargs:
        if kw in source:
            kwargs[kw] = source[kw]


def gen_active_calc(**over):
    kwargs = get_default_args(ActiveCalculator.__init__)
    update_args(kwargs)
    kwargs["device"] = calc_device()
    update_args(kwargs, source=over)
    return ActiveCalculator(**kwargs)
