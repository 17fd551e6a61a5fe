"""Profiling / tracing helpers (port of ``autoforce_tpu/profiling.py``).

The reference stamps wall-clock nodes per calculate() (active.py:426-533;
ActiveCalculator mirrors that with report_timings=True).  For device-level
analysis this module adds a ``torch.profiler`` trace of a block, written
as a Chrome trace, and a tiny phase stopwatch.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import torch


@contextlib.contextmanager
def trace(logdir="torch_trace", cuda=None):
    """Trace the enclosed block with ``torch.profiler`` and write a Chrome
    trace (``chrome://tracing``, Perfetto) to ``logdir/trace.json``.
    ``cuda``: trace the card's kernels too (default: when a card is
    present).  Yields the profiler, whose ``key_averages()`` the caller
    may read after the block."""
    from torch.profiler import ProfilerActivity, profile

    if cuda is None:
        cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=acts)
    prof.start()
    try:
        yield prof
    finally:
        if cuda:
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


class Stopwatch:
    """Accumulating phase timer (reference per-rank stopwatch idiom,
    cl/__init__.py:73-89)."""

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def __call__(self, phase):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[phase] += time.perf_counter() - t0
            self.counts[phase] += 1

    def report(self):
        return {
            k: {"total_s": v, "calls": self.counts[k],
                "mean_ms": 1e3 * v / max(self.counts[k], 1)}
            for k, v in sorted(self.totals.items())
        }
