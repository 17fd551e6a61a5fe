"""Load reference (theforce) torch-pickled model folders — binary interop
(a copy of ``autoforce_tpu/io/torch_interop.py``; numpy, pickle and ast
only, so the port keeps its own).

The reference persists trained models as folders
(theforce/regression/gppotential.py:1074-1119 ``to_folder``):

- ``model``  — ``torch.save`` of the whole ``PosteriorPotential`` object
  graph (gppotential.py:1060-1072 ``save``: the kernel cache is dropped
  and the training data is converted to ``ase.Atoms`` under
  ``self._raw_data`` before pickling),
- ``cutoff`` — one float, text,
- ``gp``     — the GP's one-liner state string
  (gppotential.py:418-437: ``GaussianProcessPotential(kernels=[...],
  noise=Positive(signal=tensor(...), requires_grad=...), parametric=...)``),
- ``info`` / ``stats`` — free text.

Loading such a folder back (``PosteriorPotentialFromFolder``,
gppotential.py:1342-1368) unpickles instances of theforce and ase
classes.  Neither package is needed here, and this package's SOAP
descriptors are numerically different by design — the pickled
``mu``/``Ke``/``Kf``/``M`` arrays are tied to the reference's kernel
values and cannot be reused verbatim.  What *does* migrate losslessly is
the model's content:

- the inducing LCEs — each ``Local`` carries the central species
  ``number``, neighbor species ``_b`` and displacements ``_r``
  (theforce/descriptor/atoms.py:36-56),
- the training structures and their first-principles targets —
  ``_raw_data`` is a list of ``ase.Atoms`` with a results-carrying
  calculator attached (``as_ase``, atoms.py:524-534),
- the hyperparameters (cutoff, noise, lmax/nmax/exponent) from the
  text files.

This module extracts exactly that with a class-intercepting unpickler
(no theforce/ase import required) and re-trains an ``SgprModel`` with
this package's engine — the binary-folder analog of rebuilding from a
``.sgpr`` tape (``ActiveCalculator.include_tape``).

Security note: reference folders are arbitrary pickles.  Interception
neutralizes ``theforce.*``/``ase.*`` class lookups, and anything else
that fails to import resolves to an inert stub rather than executing
module import side effects, but the usual ``torch.load`` caveat stands:
only load folders you trust.
"""

import ast
import io
import os
import pickle
import types
import warnings

import numpy as np

__all__ = [
    "load_reference_folder",
    "read_reference_folder",
    "parse_state_string",
]


# ----------------------------------------------------------------- stubs

class _Stub:
    """Inert stand-in for an unimportable pickled class.

    Captures constructor args / state without executing any foreign
    code.  Covers the pickle protocols the reference's objects use:
    REDUCE (``cls(*args)``), NEWOBJ (``cls.__new__(cls, *args)``) and
    ``__setstate__`` with dict / (dict, slots) states.
    """

    def __new__(cls, *args, **kw):
        return object.__new__(cls)

    def __init__(self, *args, **kw):
        self._newargs = args
        self.__dict__.update(kw)

    def __setstate__(self, state):
        if isinstance(state, dict):
            self.__dict__.update(state)
        elif (isinstance(state, tuple) and len(state) == 2
              and all(isinstance(s, (dict, type(None))) for s in state)):
            for part in state:
                if part:
                    self.__dict__.update(part)
        else:
            self._state = state

    def __repr__(self):
        cls = type(self)
        return f"<stub {cls.__module__}.{cls.__name__}>"


_STUB_CACHE = {}


def _stub_class(module, name):
    key = (module, name)
    if key not in _STUB_CACHE:
        _STUB_CACHE[key] = type(name, (_Stub,), {"__module__": module})
    return _STUB_CACHE[key]


class _InterceptUnpickler(pickle.Unpickler):
    """Unpickler that resolves globals through an ALLOWLIST and stubs
    everything else.

    Only the machinery a reference model folder legitimately needs can
    load real classes: torch's tensor rebuild path, numpy's array
    reconstructors, ``collections``, ``_codecs.encode``, and a safe
    ``builtins`` subset.  Every other global — ``theforce.*``/``ase.*``
    by design, but also ``os.system``/``subprocess``/arbitrary
    callables a malicious 'model' file could smuggle in — becomes an
    inert attribute-holding stub (a denylist of two roots would still
    allow arbitrary code execution under
    ``torch.load(weights_only=False)``).

    Trust caveat: stubs neutralize class-level code, but a crafted
    pickle can still exhaust memory; only load folders you would run
    the reference itself on.
    """

    _allow_roots = ("torch", "numpy", "collections", "_codecs")
    _allow_builtins = frozenset(
        ("dict", "list", "set", "tuple", "frozenset", "str", "bytes",
         "bytearray", "int", "float", "complex", "bool", "slice",
         "range", "NoneType", "object")
    )

    def find_class(self, module, name):
        root = module.split(".", 1)[0]
        allowed = root in self._allow_roots or (
            root == "builtins" and name in self._allow_builtins
        )
        if allowed:
            try:
                return super().find_class(module, name)
            except (ImportError, AttributeError):
                pass
        return _stub_class(module, name)


def _torch():
    try:
        import torch
    except ImportError as err:  # pragma: no cover - torch is baked in
        raise RuntimeError(
            "reference model folders are torch pickles; torch is not "
            "available in this environment"
        ) from err
    return torch


def _torch_load_intercepted(path):
    torch = _torch()
    shim = types.ModuleType("autoforce_tpu_torch._pickle_shim")
    shim.Unpickler = _InterceptUnpickler
    shim.load = lambda f, **kw: _InterceptUnpickler(f, **kw).load()
    shim.loads = lambda b, **kw: _InterceptUnpickler(
        io.BytesIO(b), **kw).load()
    try:
        return torch.load(path, map_location="cpu", pickle_module=shim,
                          weights_only=False)
    except TypeError:  # torch too old for weights_only
        return torch.load(path, map_location="cpu", pickle_module=shim)


# ------------------------------------------------------- state strings

def parse_state_string(text):
    """Parse a reference state string into plain data.

    The reference serializes hyperparameters as nested constructor
    expressions, e.g. ``GaussianProcessPotential(kernels=
    [UniversalSoapKernel(3, 3, 4, PolyCut(6.0), ...)], noise=
    Positive(signal=tensor(0.0100), requires_grad=True),
    parametric=None)`` (gppotential.py:418-430, universal.py:74-85,
    kernel.py:309-312).  Parsed with ``ast`` — never evaluated.

    Calls become ``{"name": ..., "args": [...], "kwargs": {...}}``;
    ``tensor(x)`` collapses to ``x``.
    """
    text = text.strip()
    node = ast.parse(text, mode="eval").body

    def conv(n):
        if isinstance(n, ast.Call):
            name = (n.func.id if isinstance(n.func, ast.Name)
                    else ast.unparse(n.func))
            args = [conv(a) for a in n.args]
            if name == "tensor" and len(args) == 1 and not n.keywords:
                return args[0]
            return {
                "name": name,
                "args": args,
                "kwargs": {k.arg: conv(k.value) for k in n.keywords},
            }
        if isinstance(n, ast.Constant):
            return n.value
        if isinstance(n, (ast.List, ast.Tuple)):
            return [conv(e) for e in n.elts]
        if isinstance(n, ast.UnaryOp) and isinstance(n.op, ast.USub):
            return -conv(n.operand)
        if isinstance(n, ast.Name):
            return n.id
        return ast.unparse(n)

    return conv(node)


def _first_float(tree):
    """Depth-first first numeric leaf (skips bools)."""
    if isinstance(tree, bool):
        return None
    if isinstance(tree, (int, float)):
        return float(tree)
    if isinstance(tree, dict):
        for sub in list(tree.get("args", [])) + list(
                tree.get("kwargs", {}).values()):
            v = _first_float(sub)
            if v is not None:
                return v
    if isinstance(tree, list):
        for sub in tree:
            v = _first_float(sub)
            if v is not None:
                return v
    return None


def _find_calls(tree, names):
    """All call nodes whose name contains any of ``names``."""
    out = []
    if isinstance(tree, dict) and "name" in tree:
        if any(s in tree["name"] for s in names):
            out.append(tree)
        for sub in list(tree.get("args", [])) + list(
                tree.get("kwargs", {}).values()):
            out.extend(_find_calls(sub, names))
    elif isinstance(tree, list):
        for sub in tree:
            out.extend(_find_calls(sub, names))
    return out


def _gp_meta(folder):
    """cutoff / noise / soap params from the folder's text files."""
    meta = {}
    cut = os.path.join(folder, "cutoff")
    if os.path.isfile(cut):
        with open(cut) as f:
            meta["cutoff"] = float(f.read().split()[0])
    gp = os.path.join(folder, "gp")
    if os.path.isfile(gp):
        with open(gp) as f:
            lines = [ln.strip() for ln in f
                     if ln.strip() and not ln.startswith("#")]
        if lines:
            meta["gp_state"] = lines[-1]
            try:
                tree = parse_state_string(lines[-1])
                meta["gp"] = tree
                noise = tree.get("kwargs", {}).get("noise")
                v = _first_float(noise)
                if v is not None:
                    meta["noise"] = v
                # SOAP kernels emit lmax, nmax, exponent positionally
                # (universal.py:74-85; sesoap kernels likewise)
                # SOAP kernels emit "lmax, nmax, exponent, cutoff|radial"
                # positionally (universal.py:74-85, sesoap.py:17/37)
                for k in _find_calls(tree, ("Soap",)):
                    a = k.get("args", [])
                    if len(a) >= 3 and all(
                            isinstance(x, (int, float)) for x in a[:3]):
                        meta.setdefault("lmax", int(a[0]))
                        meta.setdefault("nmax", int(a[1]))
                        meta.setdefault("exponent", int(a[2]))
                        if len(a) >= 4:
                            rc = _first_float(a[3])
                            if rc is not None:
                                meta.setdefault("cutoff", rc)
                        break
            except SyntaxError:
                warnings.warn(f"could not parse gp state string in {gp}")
    info = os.path.join(folder, "info")
    if os.path.isfile(info):
        with open(info) as f:
            meta["info"] = f.read()
    return meta


# ---------------------------------------------------------- extraction

def _as_numpy(x):
    if hasattr(x, "detach"):  # torch tensor
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _local_to_env(loc):
    """theforce Local (atoms.py:36-56) -> InducingEnv."""
    from ..regression.sgpr import InducingEnv

    d = loc.__dict__
    b = _as_numpy(d["_b"]).reshape(-1)
    r = _as_numpy(d["_r"]).reshape(-1, 3)
    if "number" in d:
        number = int(d["number"])
    else:  # very old pickles: recover from the _a broadcast
        a = _as_numpy(d["_a"]).reshape(-1)
        number = int(a[0]) if len(a) else 0
    # honor the alive mask if present (Local._m, atoms.py:52)
    if "_m" in d:
        m = _as_numpy(d["_m"]).reshape(-1).astype(bool)
        if m.shape == b.shape and not m.all():
            b, r = b[m], r[m]
    return InducingEnv.from_arrays(number, r, b)


def _cell_of(d):
    for key in ("cell", "_cellobj", "_cell"):
        if key in d:
            c = d[key]
            if hasattr(c, "__dict__") and "array" in c.__dict__:
                return _as_numpy(c.__dict__["array"])
            return _as_numpy(c)
    return np.zeros((3, 3))


def _atoms_to_system(at):
    """ase.Atoms stub -> System with a SinglePointCalculator attached.

    ase pickles Atoms via __dict__: ``arrays`` {'numbers','positions',
    'momenta'}, a Cell object, ``pbc`` and optionally ``calc`` holding
    a results dict (the reference attaches the FP results this way,
    atoms.py:524-534).
    """
    from ..system import SinglePointCalculator, System

    d = at.__dict__
    arrays = d.get("arrays", {})
    numbers = _as_numpy(arrays["numbers"]).astype(np.int64)
    positions = _as_numpy(arrays["positions"])
    pbc = d.get("pbc", d.get("_pbc", False))
    pbc = _as_numpy(pbc).astype(bool) if not isinstance(pbc, bool) else pbc
    s = System(numbers=numbers, positions=positions,
               cell=_cell_of(d), pbc=pbc)
    if "momenta" in arrays:
        mom = _as_numpy(arrays["momenta"])
        s.set_velocities(mom / s.get_masses()[:, None])
    calc = d.get("calc", d.get("_calc"))
    results = getattr(calc, "results", None) if calc is not None else None
    if isinstance(results, dict) and results:
        res = {k: (_as_numpy(v) if hasattr(v, "detach")
                   or isinstance(v, np.ndarray) else v)
               for k, v in results.items()}
        e = res.get("energy", res.get("free_energy"))
        s.calc = SinglePointCalculator(
            energy=e, forces=res.get("forces"), stress=res.get("stress"))
    return s


def read_reference_folder(folder):
    """Extract a reference model folder's content without theforce/ase.

    Returns ``(items, meta)`` where ``items`` is a list of
    ``("atoms", System)`` / ``("local", InducingEnv)`` pairs in the
    exact shape ``SgprTape.read`` yields — directly consumable by
    ``ActiveCalculator.include_tape``'s item loop — and ``meta`` holds
    cutoff / noise / lmax / nmax / exponent parsed from the folder's
    text files.
    """
    folder = os.path.expanduser(folder)
    model_file = os.path.join(folder, "model")
    if not os.path.isfile(model_file):
        raise FileNotFoundError(
            f"{folder} is not a reference model folder (no 'model' file)")
    meta = _gp_meta(folder)
    pp = _torch_load_intercepted(model_file)

    items = []
    raw = getattr(pp, "_raw_data", None)
    if raw is None:
        # data pickled separately (to_folder(pickle_data=True),
        # gppotential.py:1098-1103)
        data_file = os.path.join(folder, "data.pckl")
        if os.path.isfile(data_file):
            ad = _torch_load_intercepted(data_file)
            raw = [loc_at for loc_at in getattr(ad, "X", [])]
    for at in raw or []:
        try:
            items.append(("atoms", _atoms_to_system(at)))
        except Exception as err:
            warnings.warn(f"skipping unreadable training structure: {err}")
    X = getattr(pp, "X", None)
    for loc in getattr(X, "X", []) if X is not None else []:
        try:
            items.append(("local", _local_to_env(loc)))
        except Exception as err:
            warnings.warn(f"skipping unreadable inducing LCE: {err}")
    return items, meta


def load_reference_folder(folder, kernel_kw=None, noise_f=None,
                          max_data=np.inf, max_inducing=np.inf):
    """Re-train an SgprModel from a reference torch-pickle folder.

    The inducing LCEs and FP-labelled training structures are extracted
    verbatim; the regression is REFIT with this framework's engine
    (the reference's mu/choli are tied to its numerically-different
    kernel values).  ``kernel_kw`` overrides the hyperparameters parsed
    from the folder's text files (cutoff/lmax/nmax/exponent).

    Counterpart of ``PosteriorPotentialFromFolder``
    (gppotential.py:1342-1368) with retraining semantics — the binary
    analog of rebuilding from a tape (``cl.build``).
    """
    from ..descriptor.soap import SoapParams
    from ..engine import Engine
    from ..regression.sgpr import DataRecord, SgprModel

    items, meta = read_reference_folder(folder)
    kw = dict(kernel_kw or {})
    cutoff = kw.pop("cutoff", meta.get("cutoff", 6.0))
    lmax = kw.pop("lmax", meta.get("lmax", 3))
    nmax = kw.pop("nmax", meta.get("nmax", 3))
    exponent = kw.pop("exponent", meta.get("exponent", 4))
    if noise_f is None:
        noise_f = meta.get("noise", 0.01)

    species = set()
    for cls, obj in items:
        if cls == "atoms":
            species.update(int(z) for z in obj.numbers)
        else:
            species.add(int(obj.number))
            species.update(int(z) for z in obj.numbers)
    if not species:
        raise ValueError(f"no usable content found in {folder}")

    eng = Engine(params=SoapParams(lmax=lmax, nmax=nmax, rc=cutoff),
                 exponent=exponent, species=sorted(species), **kw)
    model = SgprModel(eng, max_data=max_data, max_inducing=max_inducing)
    envs = [obj for cls, obj in items if cls == "local"]
    if envs:
        model.stage_envs(envs)
        for env in envs:
            model.add_inducing(env, remake=False)
    for cls, obj in items:
        if cls != "atoms" or obj.calc is None:
            continue
        res = obj.calc.results
        if "energy" not in res or "forces" not in res:
            continue
        model.add_data(DataRecord.from_system(
            obj, energy=res["energy"], forces=res["forces"],
            stress=res.get("stress")), remake=False)
    if model.ndata == 0 and model.m == 0:
        raise ValueError(f"no trainable content found in {folder}")
    model.make_munu(optimize=True, noise_f=noise_f)
    return model
