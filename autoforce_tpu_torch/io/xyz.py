"""Minimal extended-XYZ (extxyz) reader/writer (ASE-free).

A copy of ``autoforce_tpu/io/xyz.py``, so files written by either package
read in the other.

Compatible with the subset the reference relies on for trajectories and
.sgpr tapes: Lattice, Properties=species:S:1:pos:R:3[:forces:R:3],
energy=..., stress=... (9-component row-major), pbc.

``write_xyz(..., exact=True)`` writes every float as its shortest exact
decimal (``repr``) instead of the fixed 8 decimals of the position and
force columns: the socket oracle's files, which must carry the oracle's
results without rounding.  Either form reads back in both packages.
"""

from __future__ import annotations

import re

import numpy as np

from ..data import atomic_numbers, chemical_symbols
from ..system import SinglePointCalculator, System


def _num(x, exact=False):
    return repr(float(x)) if exact else f"{float(x):.12g}"


def _fmt_val(v, exact=False):
    if isinstance(v, bool):
        return "T" if v else "F"
    if isinstance(v, (int, np.integer)):
        return str(int(v))
    if isinstance(v, (float, np.floating)):
        return _num(v, exact)
    if isinstance(v, np.ndarray):
        return " ".join(_num(x, exact) for x in v.reshape(-1))
    return str(v)


def write_xyz(path, systems, mode="w", forces=True, exact=False):
    if not isinstance(systems, (list, tuple)):
        systems = [systems]
    with open(path, mode) as f:
        for s in systems:
            _write_one(f, s, forces, exact)


def _write_one(f, s, with_forces, exact=False):
    n = len(s)
    comment = []
    if np.abs(s.cell).sum() > 0:
        lat = " ".join(_num(x, exact) for x in s.cell.reshape(-1))
        comment.append(f'Lattice="{lat}"')
    props = "species:S:1:pos:R:3"
    forces = None
    results = {}
    if s.calc is not None and hasattr(s.calc, "results"):
        results = s.calc.results
    if with_forces and "forces" in results:
        forces = np.asarray(results["forces"])
        props += ":forces:R:3"
    comment.append(f"Properties={props}")
    if "energy" in results:
        comment.append(f"energy={_fmt_val(results['energy'], exact)}")
    if "stress" in results:
        st = np.asarray(results["stress"])
        if st.shape == (6,):  # Voigt -> full 3x3
            v = st
            st = np.array(
                [[v[0], v[5], v[4]], [v[5], v[1], v[3]], [v[4], v[3], v[2]]]
            )
        comment.append(f'stress="{_fmt_val(st, exact)}"')
    pbc = "".join("T" if p else "F" for p in s.pbc)
    comment.append(f'pbc="{pbc[0]} {pbc[1]} {pbc[2]}"')
    f.write(f"{n}\n{' '.join(comment)}\n")
    col = (lambda x: f" {float(x)!r}") if exact else (lambda x: f" {x:16.8f}")
    for i in range(n):
        sym = chemical_symbols[s.numbers[i]]
        line = f"{sym:3s}" + "".join(col(x) for x in s.positions[i])
        if forces is not None:
            line += "".join(col(x) for x in forces[i])
        f.write(line + "\n")


_KV_RE = re.compile(r'(\w+)=(?:"([^"]*)"|(\S+))')


def _parse_comment(line):
    out = {}
    for m in _KV_RE.finditer(line):
        key = m.group(1)
        val = m.group(2) if m.group(2) is not None else m.group(3)
        out[key] = val
    return out


def read_xyz(path_or_lines, index=None):
    """Read all frames (or one by index) from an extxyz file."""
    if isinstance(path_or_lines, str):
        with open(path_or_lines) as f:
            lines = f.readlines()
    else:
        lines = list(path_or_lines)
    frames = []
    i = 0
    while i < len(lines):
        if not lines[i].strip():
            i += 1
            continue
        n = int(lines[i].strip())
        kv = _parse_comment(lines[i + 1])
        body = lines[i + 2 : i + 2 + n]
        i += 2 + n
        numbers = []
        pos = []
        extra = []
        for ln in body:
            parts = ln.split()
            sym = parts[0]
            numbers.append(
                atomic_numbers[sym] if not sym.isdigit() else int(sym)
            )
            pos.append([float(x) for x in parts[1:4]])
            extra.append([float(x) for x in parts[4:]])
        cell = np.zeros((3, 3))
        if "Lattice" in kv:
            cell = np.array([float(x) for x in kv["Lattice"].split()]).reshape(3, 3)
        pbc = [False] * 3
        if "pbc" in kv:
            pbc = [t in ("T", "True", "true") for t in kv["pbc"].split()]
        s = System(numbers=numbers, positions=pos, cell=cell, pbc=pbc)
        res = {}
        if "energy" in kv:
            res["energy"] = float(kv["energy"])
        props = kv.get("Properties", "species:S:1:pos:R:3")
        fields = props.split(":")
        # find forces column offset among extra columns
        col = 0
        for name, typ, width in zip(fields[0::3], fields[1::3], fields[2::3]):
            w = int(width)
            if name in ("species", "pos"):
                continue
            if name == "forces":
                arr = np.array(extra)[:, col : col + w]
                res["forces"] = arr
            col += w
        if "stress" in kv:
            st = np.array([float(x) for x in kv["stress"].split()])
            if st.size == 9:
                st = st.reshape(3, 3)
                res["stress"] = np.array(
                    [st[0, 0], st[1, 1], st[2, 2], st[1, 2], st[0, 2], st[0, 1]]
                )
            else:
                res["stress"] = st
        if res:
            s.calc = SinglePointCalculator(s, **res)
        frames.append(s)
    if index is None:
        return frames
    return frames[index]
