"""Error scores between two trajectories (ML vs FP).

A copy of ``autoforce_tpu/regression/scores.py`` (numpy only); counterpart
of theforce/regression/scores.py:
``python -m autoforce_tpu_torch.regression.scores ml.extxyz fp.extxyz``
"""

from __future__ import annotations

import numpy as np


def coeff_of_determination(pred, target):
    pred = np.asarray(pred, dtype=np.float64).reshape(-1)
    target = np.asarray(target, dtype=np.float64).reshape(-1)
    ss_res = ((pred - target) ** 2).sum()
    ss_tot = ((target - target.mean()) ** 2).sum()
    return 1.0 - ss_res / ss_tot if ss_tot > 0 else 0.0


def scores(pred, target):
    pred = np.asarray(pred, dtype=np.float64).reshape(-1)
    target = np.asarray(target, dtype=np.float64).reshape(-1)
    d = pred - target
    return dict(
        maxe=float(np.abs(d).max()) if d.size else 0.0,
        mae=float(np.abs(d).mean()) if d.size else 0.0,
        rmse=float(np.sqrt((d * d).mean())) if d.size else 0.0,
        r2=coeff_of_determination(pred, target),
    )


def compare_trajectories(ml_path, fp_path):
    from ..io.xyz import read_xyz

    ml = read_xyz(ml_path)
    fp = read_xyz(fp_path)
    e_ml = [s.calc.results["energy"] for s in ml]
    e_fp = [s.calc.results["energy"] for s in fp]
    f_ml = np.concatenate([s.calc.results["forces"].reshape(-1) for s in ml])
    f_fp = np.concatenate([s.calc.results["forces"].reshape(-1) for s in fp])
    return {"energy": scores(e_ml, e_fp), "forces": scores(f_ml, f_fp)}


def main():
    import argparse
    import json

    parser = argparse.ArgumentParser(description="ML-vs-FP error scores")
    parser.add_argument("ml")
    parser.add_argument("fp")
    args = parser.parse_args()
    print(json.dumps(compare_trajectories(args.ml, args.fp), indent=1))


if __name__ == "__main__":
    main()
