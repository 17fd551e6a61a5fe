"""Rebuild the ARGS' ``pckl`` model folder from its ``.sgpr`` tape,
including ALL entries (port of ``autoforce_tpu/cl/build.py``, counterpart
of theforce/cl/build.py): ``python -m autoforce_tpu_torch.cl.build``."""

from .. import cl as cline


def main():
    cline.refresh()
    calc = cline.gen_active_calc()
    calc.build()
    return calc


if __name__ == "__main__":
    main()
