"""The readers of the port's spans on a small hand-made Chrome trace,
reduced by ``trace.reduce_events`` as a traced run reduces its slice:
the pairing of each device operation with the runtime call that launched
it (held against the trace's correlation ids), device time put down to
the span whose range holds the launch and not the execution, nested spans
of one name counted once, and the ``None`` cases."""

import pytest

from portbench import trace
from portbench.metrics import (_spans, forces_ms_per_step,
                               host_issue_ms_per_step, rebuild_ms_per_step,
                               rebuilds_per_kstep, wasted_step_pct)

READERS = (rebuild_ms_per_step, rebuilds_per_kstep, forces_ms_per_step,
           wasted_step_pct, host_issue_ms_per_step)


def X(cat, name, ts, dur, corr=None):
    ev = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        ev["args"] = {"correlation": corr}
    return ev


# host: a chunk of two issued steps, a breach read and a rebuild that holds
# a nested rebuild span; the first kernel on the card was launched before
# the first step, the second step's kernel runs after its step ended
RAW = {"traceEvents": [
    X("user_annotation", "af.chunk", 0, 1000),
    X("user_annotation", "af.step", 10, 100),
    X("user_annotation", "af.forces", 20, 80),
    X("user_annotation", "af.step", 120, 100),
    X("user_annotation", "af.forces", 130, 80),
    X("user_annotation", "af.host_read", 250, 40),
    X("user_annotation", "af.rebuild", 300, 100),
    X("user_annotation", "af.rebuild", 310, 80),
    X("cpu_op", "aten::add", 24, 8),
    X("cuda_runtime", "cudaLaunchKernel", 5, 4, 1),
    X("cuda_runtime", "cudaLaunchKernel", 25, 5, 2),
    X("cuda_driver", "cuLaunchKernel", 30, 5, 3),
    X("cuda_runtime", "cudaMemcpyAsync", 102, 3, 4),
    X("cuda_runtime", "cudaLaunchKernelExC", 140, 5, 5),
    X("cuda_runtime", "cudaMemsetAsync", 145, 2, 6),
    X("cuda_runtime", "cudaEventQuery", 215, 1, 7),
    X("cuda_runtime", "cudaStreamSynchronize", 260, 20, 8),
    X("cuda_runtime", "cudaLaunchKernel", 320, 5, 9),
    X("cuda_runtime", "cudaLaunchKernel", 1100, 5, 10),
    X("kernel", "k_before_steps", 40, 30, 1),
    X("kernel", "k_forces_1", 70, 10, 2),
    X("kernel", "k_forces_2", 150, 10, 3),
    X("gpu_memcpy", "Memcpy DtoH (Device -> Pinned)", 160, 1, 4),
    X("kernel", "sm90_xmma_gemm_f32", 200, 20, 5),
    X("gpu_memset", "Memset (Device)", 220, 2, 6),
    X("kernel", "k_rebuild", 500, 100, 9),
    X("kernel", "k_outside", 1200, 5, 10),
    X("gpu_user_annotation", "af.forces", 70, 90),
]}


def record(raw=RAW, steps=1):
    return {"slice_steps": steps, "events": trace.reduce_events(raw)}


def test_launches_pair_as_the_correlation_ids_do():
    """Each device operation is paired with the call whose correlation id
    it carries, though the reduced trace keeps no ids; the profiler's
    device ranges of the spans (gpu_user_annotation) are not read."""
    host = {ev["args"]["correlation"]: ev["ts"] for ev in RAW["traceEvents"]
            if ev["cat"] in ("cuda_runtime", "cuda_driver")}
    want = sorted((ev["name"], float(ev["ts"]), float(ev["dur"]),
                   float(host[ev["args"]["correlation"]]))
                  for ev in RAW["traceEvents"]
                  if ev["cat"] in ("kernel", "gpu_memcpy", "gpu_memset"))
    ev = trace.reduce_events(RAW)
    assert sorted(_spans.launched(ev)) == want
    # a launch whose device side the profiler missed at the slice's start
    # shifts no other pair
    ev["kernels"] = ev["kernels"][1:]
    assert sorted(_spans.launched(ev)) == [w for w in want
                                           if w[0] != "k_before_steps"]


def test_device_time_goes_to_the_span_that_launched_it():
    """The spans share the profiler's clock with the kernels: an operation
    counts for a span when its launching call lies inside the span's
    range (k_forces_2 runs after its af.forces ended and counts), not when
    it runs inside it (k_before_steps runs inside the first af.forces and
    does not count)."""
    ev = trace.reduce_events(RAW)
    for name, _, _, host in _spans.launched(ev):
        if name.startswith("k_forces"):
            assert any(s <= host <= s + d
                       for s, d in _spans.ranges(ev, "af.forces"))
    assert _spans.device_us(ev, "af.forces") == pytest.approx(42)
    assert _spans.device_us(ev, "af.step") == pytest.approx(42 + 1)
    assert _spans.device_us(ev, "af.chunk") == pytest.approx(30 + 43 + 100)
    # the nested af.rebuild counts its kernel once
    assert _spans.device_us(ev, "af.rebuild") == pytest.approx(100)
    assert _spans.count(ev, "af.rebuild") == 1
    assert len(_spans.ranges(ev, "af.rebuild")) == 2


def test_readers_on_synthetic_events():
    rec = record(steps=1)
    assert rebuild_ms_per_step.read(rec) == pytest.approx(0.1)
    assert forces_ms_per_step.read(rec) == pytest.approx(0.042)
    assert rebuilds_per_kstep.read(rec) == pytest.approx(1000.0)
    assert wasted_step_pct.read(rec) == pytest.approx(50.0)
    # step 1: 100 us less 5 + 5 + 3 in runtime calls; step 2: 100 less
    # 5 + 2 + 1 (the calls of any thread that start inside the span)
    assert host_issue_ms_per_step.read(rec) == pytest.approx(
        (87 + 92) / 2 / 1e3)
    rec = record(steps=2)
    assert rebuild_ms_per_step.read(rec) == pytest.approx(0.05)
    assert rebuilds_per_kstep.read(rec) == pytest.approx(500.0)
    assert wasted_step_pct.read(rec) == 0.0


def test_runtime_calls_inside_a_step_count_once():
    """A driver call nested in a runtime call, and a call running past the
    span's end, take the span's own time only once."""
    raw = {"traceEvents": [
        X("user_annotation", "af.step", 0, 100),
        X("cuda_runtime", "cudaLaunchKernel", 10, 20, 1),
        X("cuda_driver", "cuLaunchKernel", 15, 5, 1),
        X("cuda_runtime", "cudaStreamSynchronize", 90, 50, 2),
        X("kernel", "k", 40, 5, 1),
    ]}
    assert _spans.self_us(trace.reduce_events(raw), "af.step") == [70.0]


@pytest.mark.parametrize("reader", READERS,
                         ids=[r.__name__.split(".")[-1] for r in READERS])
def test_readers_find_nothing_to_read(reader):
    """None without a device kernel (a traced run on the CPU), without a
    span of the reader's name (a program without spans), or without a
    committed step."""
    no_kernels = {"traceEvents": [e for e in RAW["traceEvents"]
                                  if e["cat"] != "kernel"]}
    assert reader.read(record(no_kernels)) is None
    no_spans = {"traceEvents": [e for e in RAW["traceEvents"]
                                if e["cat"] != "user_annotation"]}
    assert reader.read(record(no_spans)) is None
    if reader is not host_issue_ms_per_step:
        assert reader.read(record(steps=0)) is None
    assert reader.read(record()) is not None
