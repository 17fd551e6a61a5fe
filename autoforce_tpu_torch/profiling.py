"""Profiling / tracing helpers (port of ``autoforce_tpu/profiling.py``).

The reference stamps wall-clock nodes per calculate() (active.py:426-533;
ActiveCalculator mirrors that with report_timings=True).  For device-level
analysis this module adds a ``torch.profiler`` trace of a block, written
as a Chrome trace, and :func:`span`, the named ranges the device loops
put at their boundaries (``af.chunk``, ``af.chunk_start``, ``af.step``,
``af.forces``, ``af.rebuild``, ``af.host_read``), which land in such a
trace on the profiler's clock beside the kernels they launch.
"""

from __future__ import annotations

import contextlib
import os

import torch
from torch.autograd.profiler import record_function

_OFF = contextlib.nullcontext()


def span(name):
    """A ``record_function`` range named ``name`` while a torch profiler is
    recording, else one shared no-op context: with no profiler a span
    costs one predicate call, under a microsecond, where an unguarded
    ``record_function`` costs over ten."""
    if torch._C._autograd._profiler_enabled():
        return record_function(name)
    return _OFF


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
