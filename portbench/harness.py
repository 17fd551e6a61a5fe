"""One run of one cell: set-up, window, optional traced slice, check.

Everything that belongs to one cell, configuration or metric is a file
the harness finds by name: ``workloads/<cell>.json`` (its driver, sizes,
temperature, chunk, chips, why and the check's limits),
``configs/<config>.json`` (the model's widths and seed recipe),
``drivers/<driver>.py`` and ``metrics/<metric>.py``.  ``BENCHMARK.json``
says which metrics a listed cell reports; a cell it does not list reports
every metric whose reader finds something.
"""

from __future__ import annotations

import importlib
import json
import os
import subprocess
import sys
import time

import torch

from . import trace
from .reference import judge

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
WORKLOADS = os.path.join(HERE, "workloads")
CONFIGS = os.path.join(HERE, "configs")
GIB = float(1 << 30)
FORBIDDEN = ("jax", "jaxlib", "flax", "autoforce_tpu")


def load(name, dirs):
    for d in dirs:
        path = os.path.join(d, name + ".json")
        if os.path.isfile(path):
            with open(path) as f:
                return json.load(f)
    raise FileNotFoundError(f"no {name}.json in {list(dirs)}")


def manifest():
    path = os.path.join(ROOT, "BENCHMARK.json")
    if not os.path.isfile(path):
        return None
    with open(path) as f:
        return json.load(f)


def metric_names(cell, kind, available):
    """The ``kind`` ("end_to_end" | "per_layer") metrics of ``cell``: those
    of BENCHMARK.json that apply to it, or, for a cell it does not list,
    every name in ``available``."""
    man = manifest()
    if man is None or cell not in {w["name"] for w in man["workloads"]}:
        return list(available)
    return [m["name"] for m in man[kind]
            if "workloads" not in m or cell in m["workloads"]]


def readers():
    names = sorted(f[:-3] for f in os.listdir(os.path.join(HERE, "metrics"))
                   if f.endswith(".py") and not f.startswith("_"))
    return {n: importlib.import_module(f"portbench.metrics.{n}")
            for n in names}


def forbidden_modules():
    return sorted({k.split(".")[0] for k in sys.modules}
                  & set(FORBIDDEN))


def card():
    """(name, power limit) of the card, from torch and nvidia-smi."""
    name = torch.cuda.get_device_name(0)
    try:
        limit = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader",
             "-i", "0"], capture_output=True, text=True, timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        limit = "unknown"
    return name, limit


def run_cell(cell, seed, seconds, trace_on, device="cuda", t_start=None,
             workload_dirs=(WORKLOADS,), config_dirs=(CONFIGS,), fault=None):
    """Run ``cell`` once and return (result dict, check rows).  The
    driver's ``Cell`` sets up, warms, runs the window, reports its own
    end-to-end metrics and the numbers its check compares; ``fault``: a
    callable given that object after set-up, which breaks the timed path
    underneath (the harness's own tests)."""
    t_start = time.perf_counter() if t_start is None else t_start
    device = torch.device(device)
    work = load(cell, workload_dirs)
    config = load(work["config"], config_dirs)
    driver = importlib.import_module(f"portbench.drivers.{work['driver']}")
    run = driver.Cell(config, work, seed, device)
    if fault is not None:
        fault(run)
    steps = run.warm(seconds)
    setup_s = time.perf_counter() - t_start
    tracer = None
    if trace_on:
        tracer = trace.Slice()
        steps = run.traced_chunks()
    print(f"portbench: set-up {setup_s:.3f} s ({run.phases}), window "
          f"{steps} steps, {getattr(run, 'notes', {})}", file=sys.stderr,
          flush=True)
    rec = run.window(tracer)
    peak = (torch.cuda.max_memory_allocated(device) if device.type == "cuda"
            else None)
    state = run.final_state()
    if trace_on:
        rec["events"] = tracer.events
        run.trace_record(rec, state)
    e2e = dict(run.end_to_end(rec), setup_s=(setup_s, "s"))
    if peak is not None:
        e2e["peak_mem_gib"] = (peak / GIB, "GiB")
    run.close()
    numbers, finite = run.check(state)
    correct, rows = judge.decide(numbers, work["limits"])
    correct = correct and finite

    metrics = {}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda"
           else "cpu",
           "count": 1, "memory_peak_bytes": peak}
    # the window's work all counts as failed when its end state is not finite
    result = {"correct": correct, "attempted": steps,
              "failed": 0 if finite else steps}
    if not trace_on:
        for name in metric_names(cell, "end_to_end", e2e):
            if name in e2e:
                metrics[name] = {"value": e2e[name][0], "unit": e2e[name][1]}
    else:
        found = {}
        for name, mod in readers().items():
            value = mod.read(rec)
            if value is not None:
                found[name] = {"value": value, "unit": mod.UNIT}
        for name in metric_names(cell, "per_layer", found):
            if name in found:
                metrics[name] = found[name]
        dev["busy_s"] = trace.busy_us(tracer.events) * 1e-6
        dev["window_s"] = rec["slice_wall_s"]
        result["breakdown"] = trace.breakdown(tracer.events)
    result["metrics"] = metrics
    result["device"] = dev
    result["checks"] = {name: {"value": v, "limit": lim, "kind": kind}
                        for name, v, lim, kind in rows}
    return result, rows

