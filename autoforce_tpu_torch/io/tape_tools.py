"""Tape post-processing utilities (a copy of
``autoforce_tpu/io/tape_tools.py`` on this package's ``SgprTape``;
counterparts of theforce/io/{no_sgpr_duplicates,truncate_sgpr,slice_traj}.py).

CLI:
    python -m autoforce_tpu_torch.io.tape_tools dedup in.sgpr out.sgpr
    python -m autoforce_tpu_torch.io.tape_tools truncate in.sgpr out.sgpr -n 100
    python -m autoforce_tpu_torch.io.tape_tools slice traj.extxyz out.extxyz -s ::10
"""

from __future__ import annotations

import numpy as np

from .tape import SgprTape
from .xyz import read_xyz, write_xyz


def _env_key(env):
    order = np.lexsort((env.rvec[:, 2], env.rvec[:, 1], env.rvec[:, 0]))
    return (
        env.number,
        tuple(env.numbers[order].tolist()),
        tuple(np.round(env.rvec[order], 6).reshape(-1).tolist()),
    )


def _atoms_key(s):
    return (
        tuple(s.numbers.tolist()),
        tuple(np.round(s.positions, 6).reshape(-1).tolist()),
        tuple(np.round(s.cell, 6).reshape(-1).tolist()),
    )


def dedup(inp, out):
    """Remove duplicate entries (reference no_sgpr_duplicates)."""
    tape_in = SgprTape(inp)
    tape_out = SgprTape(out)
    seen = set()
    kept = 0
    for cls, obj in tape_in.read():
        key = (cls, _env_key(obj) if cls == "local" else _atoms_key(obj))
        if key in seen:
            continue
        seen.add(key)
        tape_out.write(obj)
        kept += 1
    return kept


def truncate(inp, out, n):
    """Keep the first n entries (reference truncate_sgpr)."""
    tape_in = SgprTape(inp)
    tape_out = SgprTape(out)
    for i, (cls, obj) in enumerate(tape_in.read()):
        if i >= n:
            break
        tape_out.write(obj)
    return min(n, i + 1)


def slice_traj(inp, out, sl="::"):
    """Slice an extxyz trajectory (reference slice_traj)."""
    frames = read_xyz(inp)
    parts = sl.split(":")
    parts += [""] * (3 - len(parts))
    s = slice(*(int(p) if p else None for p in parts))
    write_xyz(out, frames[s])
    return len(frames[s])


def main():
    import argparse

    p = argparse.ArgumentParser(description="sgpr tape / trajectory tools")
    p.add_argument("cmd", choices=["dedup", "truncate", "slice"])
    p.add_argument("input")
    p.add_argument("output")
    p.add_argument("-n", type=int, default=100)
    p.add_argument("-s", "--slice", default="::")
    args = p.parse_args()
    if args.cmd == "dedup":
        n = dedup(args.input, args.output)
    elif args.cmd == "truncate":
        n = truncate(args.input, args.output, args.n)
    else:
        n = slice_traj(args.input, args.output, args.slice)
    print(f"{args.cmd}: wrote {n} entries to {args.output}")


if __name__ == "__main__":
    main()
