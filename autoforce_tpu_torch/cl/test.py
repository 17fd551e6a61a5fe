"""Model-only evaluation over a trajectory: writes ML predictions next to
stored targets (port of ``autoforce_tpu/cl/test.py``, counterpart of
theforce/cl/test.py): ``python -m autoforce_tpu_torch.cl.test -i
data.extxyz`` writes ``test_ML.extxyz`` and ``test_FP.extxyz``."""

from __future__ import annotations

from .. import cl as cline
from ..io.xyz import write_xyz
from ..system import SinglePointCalculator


def test(path, out_ml="test_ML.extxyz", out_fp="test_FP.extxyz", index=None):
    from .train import read_frames

    calc = cline.gen_active_calc()
    calc._calc = None  # inference only
    frames = read_frames(path, index=index)
    mode = "w"
    for s in frames:
        res = calc.calculate(s)
        ml = s.copy()
        ml.calc = SinglePointCalculator(ml, **res)
        write_xyz(out_ml, ml, mode=mode)
        if s.calc is not None:
            write_xyz(out_fp, s, mode=mode)
        mode = "a"
    return frames


def main():
    import argparse

    from ..io.outcar import parse_slice

    parser = argparse.ArgumentParser(description="Evaluate a model on a traj")
    parser.add_argument("-i", "--input", required=True)
    parser.add_argument("-r", "--range", default=None,
                        help="frame slice start:stop:step, or a single index (e.g. 0, -1)")
    args = parser.parse_args()
    cline.refresh()
    test(args.input, index=parse_slice(args.range) if args.range else None)


if __name__ == "__main__":
    main()
