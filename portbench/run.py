"""Run one cell of the port's benchmark once and print its result line.

    python3 -m portbench.run --workload md.lgps4_m1024.100k --seed 7 \
        --seconds 10 --trace 0

The last line on standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared with its limit);
the last lines on standard error repeat the checks.  Exits non-zero, with
no result, without a CUDA card, when a cell asks for more cards than there
are, or when JAX or the JAX package is loaded once the window has closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
CACHE = os.path.join(os.path.dirname(HERE), ".portbench_cache")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # build and kernel caches at fixed paths inside the checkout
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")

    import torch

    from portbench import harness

    work = harness.load(args.workload, (harness.WORKLOADS,))
    chips = int(work.get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: needs {chips} CUDA device(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    name, limit = harness.card()
    print(f"portbench: card {name}, power limit {limit}", file=sys.stderr)
    result, rows = harness.run_cell(args.workload, args.seed, args.seconds,
                                    bool(args.trace), t_start=T_START)
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"portbench: loaded {', '.join(loaded)} in the measuring process",
              file=sys.stderr)
        return 3
    result["card"] = {"name": name, "power_limit": limit}
    checks = result.pop("checks")
    result["checks"] = checks
    for cname, value, lim, kind in rows:
        sign = "<=" if kind == "max" else ">="
        print(f"check {cname} {value!r} {sign} {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
