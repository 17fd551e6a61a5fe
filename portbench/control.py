"""The control of a cell's check: the reference put in the port's place,
one precision lower than the configuration states (descriptors in
bfloat16, the Gram and the energy in float32), at the cell's own size.

    python3 -m portbench.control --workload md.lgps4_m1024.100k --seeds 1 2 3

prints one JSON line per seed with the numbers the check compares and
whether the cell's limits pass them (they must not).  The benchmark's own
runs never run it; ``portbench/tests/test_portbench_control.py`` runs it
at a small size.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from . import harness
from .reference import judge, lattice
from .reference import model as ref_model


def readings(cell, seed, device, workload_dirs=(harness.WORKLOADS,),
             config_dirs=(harness.CONFIGS,)):
    """(numbers, correct) of the control for ``cell`` at ``seed``: at the
    cell's start state (the crystal rattled from the seed)."""
    work = harness.load(cell, workload_dirs)
    config = harness.load(work["config"], config_dirs)
    model = ref_model.build(config, int(config["model_seed"]), device)
    pos, numbers, box = lattice.crystal(config, work["reps"], device)
    gen = ref_model.generator(device, seed, 1)
    pos = pos + float(work["rattle"]) * torch.randn(
        pos.shape, generator=gen, dtype=pos.dtype, device=device)
    nums = judge.control_numbers(model, pos, box, numbers)
    limits = {k: v for k, v in work["limits"].items() if k in nums}
    correct, _ = judge.decide(nums, limits)
    return nums, correct


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    for seed in args.seeds:
        nums, correct = readings(args.workload, seed, device)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "correct": correct, "numbers": nums}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
