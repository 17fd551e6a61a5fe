""".sgpr tape: append-only text log of training events (a copy of
``autoforce_tpu/io/tape.py`` on this package's model and system types).

Text-compatible with the reference's ``SgprIO`` format
(theforce/io/sgprio.py): blocks delimited by ``start:/end:`` of type
``atoms`` (extxyz frame), ``local`` (central species + neighbor
displacement list), or ``params``; recursive ``include:`` with dedup.
Tapes written by either implementation can be read by the other.
"""

from __future__ import annotations

import os
from collections import Counter

import numpy as np

from ..regression.sgpr import InducingEnv
from ..system import System
from .xyz import read_xyz, _write_one


class SgprTape:
    def __init__(self, path):
        self.path = os.path.abspath(path)

    # ------------------------------------------------------------- writing
    def write(self, obj):
        if isinstance(obj, InducingEnv):
            self.write_env(obj)
        elif isinstance(obj, System):
            self.write_system(obj)
        else:
            raise TypeError(f"no tape recipe for {type(obj)}")

    def write_env(self, env: InducingEnv):
        with open(self.path, "a") as f:
            f.write("\nstart: local\n")
            f.write(f"{env.number:4d}\n")
            for z, r in zip(env.numbers, env.rvec):
                f.write(
                    "{:4d} {:16.8f} {:16.8f} {:16.8f}\n".format(int(z), *r.tolist())
                )
            f.write("end: local\n")

    def write_system(self, system: System):
        with open(self.path, "a") as f:
            f.write("\nstart: atoms\n")
            _write_one(f, system, with_forces=True)
            f.write("end: atoms\n")

    def write_params(self, **kwargs):
        with open(self.path, "a") as f:
            f.write("\nstart: params\n")
            for a, b in kwargs.items():
                f.write(f"{a} {b}\n")
            f.write("end: params\n")

    # ------------------------------------------------------------- reading
    def read(self, exclude=None):
        """Returns [(type, obj), ...]; handles recursive include: lines."""
        if not os.path.isfile(self.path):
            return []
        if exclude is None:
            exclude = []
        elif isinstance(exclude, str):
            exclude = [os.path.abspath(exclude)]
        elif isinstance(exclude, SgprTape):
            exclude = [exclude.path]
        if self.path in exclude:
            return []
        exclude.append(self.path)

        with open(self.path) as f:
            lines = f.readlines()
        data = []
        counts = Counter()
        on = False
        typ = None
        blk = []
        for line in lines:
            if not on:
                if line.startswith("start:"):
                    on = True
                    typ = line.split()[-1]
                    blk = []
                elif line.startswith("include:"):
                    inc = line.split()[-1]
                    inc = os.path.expanduser(os.path.expandvars(inc))
                    if not os.path.isabs(inc):
                        inc = os.path.join(os.path.dirname(self.path), inc)
                    data.extend(SgprTape(inc).read(exclude=exclude))
            else:
                if line.startswith("end:"):
                    assert line.split()[-1] == typ
                    on = False
                    data.append((typ, _convert(typ, blk)))
                    counts[typ] += 1
                else:
                    blk.append(line)
        return data


def _convert(typ, blk):
    if typ == "atoms":
        return read_xyz(blk, index=0)
    if typ == "local":
        a = int(blk[0].strip())
        b = []
        r = []
        for line in blk[1:]:
            parts = line.split()
            b.append(int(parts[0]))
            r.append([float(x) for x in parts[1:4]])
        return InducingEnv.from_arrays(a, np.array(r).reshape(-1, 3), np.array(b, dtype=int))
    if typ == "params":
        out = {}
        for line in blk:
            a, b = line.split(maxsplit=1)
            out[a] = eval(b)  # noqa: S307 - reference-compatible params blocks
        return out
    raise ValueError(f"unknown tape block type {typ}")
