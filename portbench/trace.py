"""A ``torch.profiler`` trace of a slice of the window, reduced to the
events the per-layer readers and the breakdown use.

The trace holds CPU and CUDA activities.  Its chrome-trace export is
read back as lists of (name, start us, duration us): device ``kernels``,
device memory operations ``memops``, CUDA ``runtime`` calls and host
``host`` operations.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile

import torch


class Slice:
    """Start and stop of the profiled slice, at chunk boundaries."""

    def __init__(self):
        self.prof = None
        self.events = None

    def start(self):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.__enter__()

    def stop(self):
        self.prof.__exit__(None, None, None)
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                raw = json.load(f)
        finally:
            os.remove(path)
        self.prof = None
        self.events = reduce_events(raw)


def reduce_events(raw):
    out = {"kernels": [], "memops": [], "runtime": [], "host": []}
    where = {"kernel": "kernels", "gpu_memcpy": "memops",
             "gpu_memset": "memops", "cuda_runtime": "runtime",
             "cuda_driver": "runtime", "cpu_op": "host",
             "user_annotation": "host"}
    for ev in raw.get("traceEvents", []):
        if ev.get("ph") != "X":
            continue
        key = where.get(ev.get("cat"))
        if key is not None:
            out[key].append((ev.get("name", ""), float(ev["ts"]),
                             float(ev.get("dur", 0.0))))
    for v in out.values():
        v.sort(key=lambda e: e[1])
    return out


def busy_us(events):
    """Length of the union of the device intervals (us)."""
    iv = sorted((s, s + d) for _, s, d in events["kernels"] + events["memops"])
    total, end = 0.0, None
    for s, e in iv:
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def breakdown(events, top=10):
    """The device operations that took most time, summed by name, and the
    idle gaps between device operations summed by what the host was doing
    at each gap's middle (the innermost host op or runtime call covering
    it), both in seconds, at most ``top`` each."""
    by_name = {}
    for name, _, d in events["kernels"] + events["memops"]:
        by_name[name] = by_name.get(name, 0.0) + d * 1e-6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    dev = sorted((s, s + d) for _, s, d in events["kernels"] + events["memops"])
    host = sorted(events["host"] + events["runtime"], key=lambda e: e[1])
    starts = [e[1] for e in host]
    gaps = {}
    end = None
    for s, e in dev:
        if end is not None and s > end:
            mid = 0.5 * (s + end)
            label = "host outside any traced op"
            k = bisect.bisect_right(starts, mid)
            best = None
            for name, hs, hd in reversed(host[max(0, k - 200):k]):
                if hs + hd >= mid and (best is None or hs > best[1]):
                    best = (name, hs)
            if best is not None:
                label = best[0]
            gaps[label] = gaps.get(label, 0.0) + (s - end) * 1e-6
        end = e if end is None else max(end, e)
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n, v] for n, v in ops],
            "idle_gaps": [[n, v] for n, v in idle]}
