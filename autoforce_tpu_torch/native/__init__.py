"""Native (C++) runtime components, loaded via ctypes.

The shared library is built lazily on first use with the host's g++ into
the package's git-ignored build directory (never next to the source), and
everything degrades gracefully to the pure-python/scipy paths if no
compiler is available.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

from .. import BUILD_DIR

_HERE = os.path.dirname(os.path.abspath(__file__))
_LIB = None
_TRIED = False


def _build():
    src = os.path.join(_HERE, "cell_list.cpp")
    out = os.path.join(BUILD_DIR, "libcelllist.so")
    if os.path.isfile(out) and os.path.getmtime(out) >= os.path.getmtime(src):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    # build under a private name, then rename: concurrent processes (test
    # workers) never load a half-written library
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC", src, "-o", tmp]
    subprocess.run(cmd, check=True, capture_output=True)
    os.replace(tmp, out)
    return out


def get_lib():
    """ctypes handle to the native library, or None if unavailable."""
    global _LIB, _TRIED
    if _LIB is None and not _TRIED:
        _TRIED = True
        try:
            path = _build()
            lib = ctypes.CDLL(path)
        except (OSError, subprocess.CalledProcessError):
            return None
        lib.cell_list_neighbors.restype = ctypes.c_int
        lib.cell_list_neighbors.argtypes = [
            ctypes.POINTER(ctypes.c_double),  # positions
            ctypes.c_int,  # n
            ctypes.POINTER(ctypes.c_double),  # cell
            ctypes.POINTER(ctypes.c_int),  # pbc
            ctypes.POINTER(ctypes.c_int),  # reps
            ctypes.c_double,  # cutoff
            ctypes.c_int,  # kpad
            ctypes.POINTER(ctypes.c_int32),  # idx
            ctypes.POINTER(ctypes.c_int32),  # off
            ctypes.POINTER(ctypes.c_uint8),  # mask
        ]
        _LIB = lib
    return _LIB


def native_neighbor_list(positions, cell, pbc, reps, cutoff, kpad):
    """Run the C++ cell-list; returns (kmax, idx, off, mask) or None."""
    lib = get_lib()
    if lib is None:
        return None
    positions = np.ascontiguousarray(positions, dtype=np.float64)
    cell = np.ascontiguousarray(cell, dtype=np.float64)
    pbc_i = np.ascontiguousarray(np.asarray(pbc, dtype=np.int32))
    reps_i = np.ascontiguousarray(np.asarray(reps, dtype=np.int32))
    n = len(positions)
    idx = np.zeros((n, kpad), dtype=np.int32)
    off = np.zeros((n, kpad, 3), dtype=np.int32)
    mask = np.zeros((n, kpad), dtype=np.uint8)
    kmax = lib.cell_list_neighbors(
        positions.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        ctypes.c_int(n),
        cell.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        pbc_i.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        reps_i.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        ctypes.c_double(cutoff),
        ctypes.c_int(kpad),
        idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        off.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        mask.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    return kmax, idx, off, mask
