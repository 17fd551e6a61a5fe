"""The port's profiler spans (``profiling.span``) on the CPU: the tree
that a ``torch.profiler`` trace of the device loop holds (``af.chunk`` >
``af.step`` > ``af.forces``; the chunk-start rebuild under
``af.chunk_start``; a breach served by ``af.host_read`` then
``af.rebuild`` directly under ``af.chunk``), one ``af.step`` per issued
iteration, no ``RecordFunction`` entered while no profiler records, and
the same trajectory with the spans on and off.

The model and systems are those of tests/test_torch_mesh_drivers.py: the
JAX package's mesh-test model on rattled 32-atom Cu boxes, hot enough to
breach the 0.3 A skin within a chunk."""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from autoforce_tpu_torch.md import device_md as dmd
from autoforce_tpu_torch.md.device_md import DeviceMD
from autoforce_tpu_torch.md.device_npt import DeviceNPT

from test_torch_mesh_drivers import FS, _write, calc_of, cu_box

NAMES = ("af.chunk", "af.chunk_start", "af.step", "af.forces", "af.rebuild",
         "af.host_read")


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    return _write(str(tmp_path_factory.mktemp("spans") / "model.pckl"))


def md_run(folder, shape=None, steps=24):
    calc = calc_of(folder, shape)
    s = cu_box(temperature=900)
    s.calc = calc
    dyn = DeviceMD(s, calc, dt=3 * FS, temperature_K=600, chunk=steps,
                   seed=1, check_beta=False)
    assert dyn.in_loop_rebuild
    dyn.run(steps)
    assert dyn.nsteps == steps
    return s


def npt_run(folder, shape=None, steps=20):
    calc = calc_of(folder, shape)
    s = cu_box(rattle=0.04, temperature=800)
    s.calc = calc
    dyn = DeviceNPT(s, calc, 2.5 * FS, temperature_K=500, pressure_GPa=0.5,
                    tdamp=50 * FS, pdamp=150 * FS, chunk=steps,
                    check_beta=False, isotropic=False)
    dyn.run(steps)
    assert dyn.nsteps == steps
    return s


def spans(path):
    """The af.* spans of an exported trace: [name, start, end, parent
    index] in start order, the parent the innermost enclosing af.* span."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    out = sorted(([e["name"], float(e["ts"]), float(e["ts"]) + e["dur"], None]
                  for e in events if e.get("ph") == "X"
                  and e.get("cat") == "user_annotation"
                  and e["name"] in NAMES), key=lambda e: (e[1], -e[2]))
    stack = []
    for i, sp in enumerate(out):
        while stack and out[stack[-1]][2] < sp[1]:
            stack.pop()
        if stack:
            sp[3] = stack[-1]
            assert sp[2] <= out[stack[-1]][2] + 0.01  # nested, not crossing
        stack.append(i)
    return out


def traced(run, tmp_path):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run()
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    return spans(path)


@pytest.mark.parametrize("driver", ["md", "npt", "md_mesh"])
def test_span_tree_of_the_device_loop(folder, driver, tmp_path, monkeypatch):
    """The first chunk of a run that serves skin breaches in the loop:
    the chunk-start rebuild and forces under af.chunk_start; under
    af.chunk, af.step spans holding one af.forces each, and each breach
    an af.host_read then an af.rebuild and its af.forces; one af.step per
    iteration the loop issued.  (The NPT box shrinks until its in-loop
    rebuild fails after a few breaches and the host path takes over: its
    later chunks are left out.)"""
    issued = []
    inner = dmd.drive

    def counted(state, step, go, nsteps, rebuild=None):
        its = []
        issued.append(its)

        def stepped(st, it):
            its.append(it)
            return step(st, it)

        return inner(state, stepped, go, nsteps, rebuild)

    run = {"md": lambda: md_run(folder), "npt": lambda: npt_run(folder),
           "md_mesh": lambda: md_run(folder, (2, 2))}[driver]
    if driver == "npt":
        from autoforce_tpu_torch.md import device_npt

        monkeypatch.setattr(device_npt, "drive", counted)
    else:
        monkeypatch.setattr(dmd, "drive", counted)
    tree = traced(run, tmp_path)
    names = [sp[0] for sp in tree]
    assert names.count("af.chunk") == len(issued)
    start, chunk = names.index("af.chunk_start"), names.index("af.chunk")
    assert start < chunk and tree[start][3] is None and tree[chunk][3] is None
    assert [c[0] for c in tree if c[3] == start] == ["af.rebuild",
                                                      "af.forces"]
    kids = [(i, c[0]) for i, c in enumerate(tree) if c[3] == chunk]
    steps = [i for i, n in kids if n == "af.step"]
    assert len(steps) == len(issued[0]) > 0
    for i in steps:
        assert [c[0] for c in tree if c[3] == i] == ["af.forces"]
    under = [n for _, n in kids if n != "af.step"]
    breaches = under.count("af.rebuild")
    assert breaches > 0  # the 0.3 A skin was breached inside the chunk
    # each served breach: the read, the rebuild, the forces with its
    # table; then the read that ends the chunk, unless the last breach
    # fell on its last step
    assert under[:3 * breaches] == ["af.host_read", "af.rebuild",
                                    "af.forces"] * breaches
    assert under[3 * breaches:] in ([], ["af.host_read"])
    if driver != "npt":
        assert len(issued) == 1 and issued[0] == list(range(24))
        assert names.count("af.rebuild") == breaches + 1


def test_spans_off_enter_no_record_function(folder, monkeypatch):
    """With no profiler recording, a span is the shared no-op context: a
    whole MD run enters no RecordFunction, and its trajectory is bit for
    bit that of the same run under the profiler (spans on)."""
    from autoforce_tpu_torch import profiling

    entered = []
    enter = torch.ops.profiler._record_function_enter_new

    def counted(*a, **k):
        entered.append(a[0])
        return enter(*a, **k)

    monkeypatch.setattr(torch.ops.profiler, "_record_function_enter_new",
                        counted)
    assert profiling.span("af.chunk") is profiling.span("af.step")
    off = md_run(folder)
    assert entered == []
    with profile(activities=[ProfilerActivity.CPU]):
        on = md_run(folder)
    assert "af.step" in entered and "af.rebuild" in entered
    np.testing.assert_array_equal(on.positions, off.positions)
    np.testing.assert_array_equal(on.get_velocities(), off.get_velocities())
