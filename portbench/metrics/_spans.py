"""The program's spans in the reduced trace, and the device operations
launched inside them.

The port names the boundaries of its device loop with
``autoforce_tpu_torch.profiling.span`` (``af.chunk``, ``af.chunk_start``,
``af.step``, ``af.forces``, ``af.rebuild``, ``af.host_read``), which the
profiler records as host ranges (``events["host"]``) on the clock of the
kernels.  A device operation belongs to a span when the runtime call that
launched it started inside one of that name's ranges, wherever and
whenever it ran on the card.

The reduced trace keeps no correlation ids, so a device operation is tied
to its launching call by order: the loop issues everything on one stream,
which runs its operations in the order they were issued, so within each
kind (kernels, copies, fills) the k-th last launching call of the slice
is the k-th last operation on the device.  The pairing counts from the
end: the slice ends on a host read, with the card idle, while the
profiler can miss the device side of the first launches after it starts
(four of 90,959 kernel launches in a 62,500-atom slice on an H100).  An
operation with no launching call, or a call with no operation, is left
out of every span.  On that slice the pairing gave every span the device
time that the profiler's correlation ids give it.
"""

import bisect

# the runtime and driver calls that put one operation of a kind on a stream
CALLS = (("kernel", "LaunchKernel"), ("memset", "Memset"), ("memcpy", "Memcpy"))


def _kind(call):
    for kind, mark in CALLS:
        if mark in call:
            return kind
    return None


def launched(events):
    """(name, device start us, duration us, host start us of the call that
    launched it) of each device operation of the slice, by device start."""
    calls = {kind: [] for kind, _ in CALLS}
    for name, start, _ in events["runtime"]:
        kind = _kind(name)
        if kind is not None:
            calls[kind].append(start)
    ops = {kind: [] for kind, _ in CALLS}
    ops["kernel"] = list(events["kernels"])
    for op in events["memops"]:
        ops["memset" if op[0].startswith("Memset") else "memcpy"].append(op)
    out = []
    for kind, _ in CALLS:
        pairs = zip(reversed(ops[kind]), reversed(sorted(calls[kind])))
        out.extend((name, start, dur, host)
                   for (name, start, dur), host in pairs)
    out.sort(key=lambda e: e[1])
    return out


def ranges(events, name):
    """The host ranges (start, duration) of the spans called ``name``."""
    return [(s, d) for n, s, d in events["host"] if n == name]


def count(events, name):
    """The spans called ``name``, one inside another of the name counted
    once."""
    return len(union((s, s + d) for s, d in ranges(events, name)))


def union(intervals):
    """Sorted, disjoint [start, end] pairs covering ``intervals``."""
    out = []
    for s, e in sorted(intervals):
        if out and s < out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def device_us(events, name):
    """Summed device time (us) of the operations launched inside a span
    called ``name``; nested spans of one name count once."""
    cover = union((s, s + d) for s, d in ranges(events, name))
    starts = [s for s, _ in cover]
    total = 0.0
    for _, _, dur, host in launched(events):
        k = bisect.bisect_right(starts, host) - 1
        if k >= 0 and host <= cover[k][1]:
            total += dur
    return total


def ms_per_step(rec, name):
    """Device time (ms) launched inside ``name`` per committed step of the
    slice; None without a device kernel or such a span."""
    steps = rec.get("slice_steps") or 0
    events = rec["events"]
    if not steps or not events["kernels"] or not count(events, name):
        return None
    return device_us(events, name) / steps / 1e3


def self_us(events, name):
    """Per span called ``name``: its duration less the time inside CUDA
    runtime calls that start within it (the union, clipped to the span).
    The calls of the autograd engine's device thread count too: the span's
    thread waits on them."""
    runtime = sorted((s, s + d) for _, s, d in events["runtime"])
    starts = [s for s, _ in runtime]
    out = []
    for s, d in ranges(events, name):
        e = s + d
        lo = bisect.bisect_left(starts, s)
        hi = bisect.bisect_right(starts, e)
        inside = union((a, min(b, e)) for a, b in runtime[lo:hi])
        out.append(d - sum(b - a for a, b in inside))
    return out
