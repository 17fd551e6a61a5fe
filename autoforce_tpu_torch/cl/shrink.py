"""Greedy inducing-set compression by force R2 (port of
``autoforce_tpu/cl/shrink.py``, counterpart of theforce/cl/shrink.py):
``python -m autoforce_tpu_torch.cl.shrink -m TARGET [-c CANDIDATES]``
shrinks the ARGS' model and saves it to its ``pckl``."""

from __future__ import annotations

from .. import cl as cline
from ..regression.compress import shrink


def main(argv=None):
    import argparse

    parser = argparse.ArgumentParser(description="Shrink the inducing set")
    parser.add_argument("-m", "--target", type=int, required=True)
    parser.add_argument("-c", "--candidates", type=int, default=None)
    args = parser.parse_args(argv)
    cline.refresh()
    calc = cline.gen_active_calc()
    shrink(calc.model, args.target, candidates=args.candidates, verbose=True)
    calc.save_model()
    return calc


if __name__ == "__main__":
    main()
