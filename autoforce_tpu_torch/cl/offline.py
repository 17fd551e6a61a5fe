"""Offline evaluation with sampling (port of ``autoforce_tpu/cl/offline.py``,
counterpart of theforce/cl/offline.py): run the active calculator over
stored structures using their stored targets as the 'oracle'.
``python -m autoforce_tpu_torch.cl.offline -i data.extxyz``."""

from __future__ import annotations

from .. import cl as cline
from ..io.xyz import read_xyz


def offline(path):
    calc = cline.gen_active_calc()
    calc.include_data(read_xyz(path))
    calc.save_model()
    return calc


def main():
    import argparse

    parser = argparse.ArgumentParser(description="Offline sampling/training")
    parser.add_argument("-i", "--input", required=True)
    args = parser.parse_args()
    cline.refresh()
    offline(args.input)


if __name__ == "__main__":
    main()
