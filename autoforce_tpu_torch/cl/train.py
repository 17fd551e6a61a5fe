"""Offline training: ``python -m autoforce_tpu_torch.cl.train -i
data.extxyz``, ``-i OUTCAR [OUTCAR-2 ...]``, or ``-i model.sgpr``; an
optional ``-r start:stop:step`` slices the frames read from each trajectory
file (port of ``autoforce_tpu/cl/train.py``, counterpart of
theforce/cl/train.py:21-45).  Reads the ARGS file of the working
directory; the model trains on ARGS' ``calc_device``, the card by
default."""

from __future__ import annotations

from .. import cl as cline


def read_frames(path, index=None):
    """Trajectory frames from an extxyz/xyz file or a VASP OUTCAR.

    ``index``: a slice, or a bare int selecting ONE frame (the
    reference's ``-r 0`` / ``-r -1`` forms)."""
    if "OUTCAR" in path.rsplit("/", 1)[-1]:
        from ..io.outcar import read_outcar_frames

        return read_outcar_frames(path, index=index)
    from ..io.xyz import read_xyz

    frames = read_xyz(path)
    if index is None:
        return frames
    return [frames[index]] if isinstance(index, int) else frames[index]


def train(inputs, index=None):
    calc = cline.gen_active_calc()
    for path in inputs:
        if path.endswith(".sgpr"):
            # reference train.py:11-21: for tapes an integer -r is the
            # number of data records to include (ndata)
            if index is not None and not isinstance(index, int):
                raise RuntimeError(
                    "for .sgpr inputs use -r with an integer (ndata), "
                    "e.g. -r 100"
                )
            calc.include_tape(path, ndata=index)
        else:
            calc.include_data(read_frames(path, index=index))
    calc.save_model()
    return calc


def main():
    import argparse

    from ..io.outcar import parse_slice

    parser = argparse.ArgumentParser(description="Offline SGPR training")
    parser.add_argument("-i", "--input", nargs="+", required=True)
    parser.add_argument(
        "-r", "--range", default=None,
        help="frame slice start:stop:step or single index; for .sgpr inputs an integer = ndata",
    )
    args = parser.parse_args()
    cline.refresh()
    train(args.input, index=parse_slice(args.range) if args.range else None)


if __name__ == "__main__":
    main()
