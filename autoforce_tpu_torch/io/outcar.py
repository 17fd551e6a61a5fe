"""OUTCAR trajectory reader for offline training.

A copy of ``autoforce_tpu/io/outcar.py`` (numpy only): the port keeps its
own host modules so that it never imports the JAX package.

The reference trains directly from VASP OUTCAR files
(``python -m theforce.cl.train -i OUTCAR [-r start:stop:step]``,
theforce/cl/train.py:21-45 via ase.io.read).  ASE is not a dependency
here, so this module parses the ionic-step trajectory (cell, positions,
forces, stress, TOTEN) out of the OUTCAR text directly and returns
:class:`~autoforce_tpu_torch.system.System` frames carrying their targets in a
``SinglePointCalculator`` — ready for ``ActiveCalculator.include_data``.

Layout facts used (stable across VASP 4/5/6 OUTCARs):
- species titles appear as ``POTCAR:  <XC> <symbol[_suffix]> <date>``
  lines, listed once per species and then repeated; the list restarts at
  the first duplicate.
- per-species atom counts: ``ions per type = n1 n2 ...``.
- each ionic step prints ``direct lattice vectors ...`` (3 rows, lattice
  in columns 0:3), the stress ``in kB`` line, a ``POSITION ...
  TOTAL-FORCE`` table (positions 0:3, forces 3:6), and
  ``free  energy   TOTEN`` after the table.
"""

from __future__ import annotations

import numpy as np

from ..data import atomic_numbers
from ..units import GPa


def _species_numbers(symbols, counts):
    numbers = []
    for sym, cnt in zip(symbols, counts):
        base = sym.split("_")[0]
        numbers.extend([atomic_numbers[base]] * cnt)
    return np.asarray(numbers, dtype=np.int32)


def _parse_potcar_symbols(lines):
    """All ``POTCAR:`` title symbols in file order (with duplicates).

    VASP prints the full POTCAR list twice (header + detail block), so
    the raw sequence is usually the species list repeated; resolution
    against ``ions per type`` happens in :func:`_resolve_species` —
    truncating at the first repeated symbol would mis-handle legal
    repeated-species setups like ``Fe O Fe``.
    """
    syms = []
    for line in lines:
        if "POTCAR:" in line:
            parts = line.split()
            # 'POTCAR:', functional, symbol[, date...]
            if len(parts) >= 3:
                syms.append(parts[2])
    return syms


def _parse_titel_symbols(lines):
    """``TITEL  = PAW_PBE Fe 06Sep2000`` symbols (once per species block)."""
    syms = []
    for line in lines:
        if "TITEL" in line and "=" in line:
            parts = line.split("=")[-1].split()
            if len(parts) >= 2:
                syms.append(parts[1])
    return syms


def _resolve_species(raw_syms, titel_syms, counts):
    """Species per POSCAR block, or None if it cannot be determined."""
    if not counts:
        return None
    n = len(counts)
    for cand in (raw_syms, titel_syms):
        if not cand:
            continue
        if len(cand) == n:
            return cand
        # the POTCAR: list printed twice back-to-back
        if len(cand) == 2 * n and cand[:n] == cand[n:]:
            return cand[:n]
    return None


def read_outcar_frames(path, index=None):
    """Parse every ionic step of an OUTCAR into System frames w/ targets.

    ``index``: optional slice applied to the frame list (the reference's
    ``-r start:stop:step``).
    """
    from ..system import SinglePointCalculator, System

    with open(path) as fh:
        lines = fh.readlines()

    counts = None
    for line in lines:
        if "ions per type" in line:
            counts = [int(x) for x in line.split("=")[-1].split()]
            break

    symbols = _resolve_species(
        _parse_potcar_symbols(lines), _parse_titel_symbols(lines), counts
    )
    numbers = _species_numbers(symbols, counts) if symbols else None

    frames = []
    cell = None
    stress = None
    i = 0
    n = len(lines)
    while i < n:
        line = lines[i]
        if "direct lattice vectors" in line:
            try:
                rows = [
                    [float(x) for x in lines[i + 1 + k].split()[:3]]
                    for k in range(3)
                ]
                cell = np.array(rows)
            except (ValueError, IndexError):
                pass
        elif "in kB" in line:
            try:
                v = [float(x) for x in line.split()[2:8]]
                # XX YY ZZ XY YZ ZX (kBar) -> Voigt xx yy zz yz zx xy, eV/A^3
                stress = (
                    -np.array([v[0], v[1], v[2], v[4], v[5], v[3]]) * 1e-1 * GPa
                )
            except ValueError:
                stress = None
        elif "TOTAL-FORCE (eV/Angst)" in line:
            pos, frc = [], []
            j = i + 2
            while j < n and not lines[j].strip().startswith("----"):
                parts = lines[j].split()
                if len(parts) >= 6:
                    try:
                        row = [float(x) for x in parts[:6]]
                    except ValueError:
                        break
                    pos.append(row[:3])
                    frc.append(row[3:6])
                j += 1
            # TOTEN follows the force table within the same ionic step
            energy = None
            k = j
            while k < n:
                if "free  energy   TOTEN" in lines[k]:
                    energy = float(lines[k].split()[-2])
                    break
                if "TOTAL-FORCE (eV/Angst)" in lines[k]:
                    break
                k += 1
            if pos and energy is None:
                # truncated/crashed OUTCAR tail: the force table was
                # flushed but TOTEN never printed — skip the incomplete
                # frame instead of emitting one that breaks training.
                import sys as _sys

                print(
                    f"outcar: skipping incomplete ionic step in {path} "
                    "(force table without TOTEN)",
                    file=_sys.stderr,
                )
            elif pos:
                znum = numbers
                if znum is None or len(znum) != len(pos):
                    raise ValueError(
                        f"{path}: cannot determine atomic species "
                        f"(POTCAR/TITEL symbols vs 'ions per type' "
                        f"mismatch for {len(pos)} atoms) — refusing to "
                        "train on unknown species"
                    )
                sys_ = System(
                    numbers=znum,
                    positions=np.array(pos),
                    cell=cell if cell is not None else np.zeros((3, 3)),
                    pbc=cell is not None,
                )
                sys_.calc = SinglePointCalculator(
                    sys_,
                    energy=energy,
                    forces=np.array(frc),
                    stress=stress,
                )
                frames.append(sys_)
            stress = None
            i = j
        i += 1

    if index is not None:
        if isinstance(index, int):
            return [frames[index]]
        frames = frames[index]
    return frames


def parse_slice(text):
    """The reference's ``-r`` convention (theforce/cl/train.py:34-39,
    ase.io.read index strings): a bare integer is a SINGLE frame index
    (``-r 0`` = first frame, ``-r -1`` = last), ``start:stop:step`` is a
    slice."""
    text = (text or "::").strip()
    if ":" not in text:
        return int(text)
    parts = text.split(":")
    vals = [int(p) if p.strip() else None for p in parts]
    while len(vals) < 3:
        vals.append(None)
    return slice(*vals[:3])
