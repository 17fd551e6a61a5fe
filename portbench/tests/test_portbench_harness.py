"""The harness driven on the CPU through a tiny cell that BENCHMARK.json
does not list (a cell is a file), and with the timed path broken
underneath: each fault a device MD cell can have turns ``correct`` false.
(The exchange between cards is a fault only a multi-card cell can have.)"""

import pytest
import torch

from portbench import harness

from ._fixtures import DATA


def _run(fault=None, cell="md.cu_tiny", trace=False):
    torch.set_num_threads(2)
    return harness.run_cell(cell, 123456789012, 0.1, trace, device="cpu",
                            workload_dirs=(DATA,), config_dirs=(DATA,),
                            fault=fault)[0]


def test_unlisted_cell_runs_and_is_correct():
    res = _run()
    assert res["correct"] is True and res["failed"] == 0
    assert set(res["metrics"]) == {"md_steps_per_s", "setup_s"}
    assert list(res)[-1] == "checks"
    assert set(res["checks"]) == set(harness.load("md.cu_tiny", (DATA,))["limits"])


def test_traced_run_on_the_cpu_reports_no_device_metric():
    res = _run(trace=True)
    assert res["correct"] is True
    assert res["metrics"] == {}
    assert res["device"]["busy_s"] == 0.0


def _unchanged(run):
    """Every chunk returns the state it was given (forces consistent with
    it) and reports its steps done."""
    orig = run.tap.orig

    def chunk(*args, **kw):
        args = list(args)
        n = args[12]
        args[12] = 0
        out = orig(*args, **kw)
        return out[:5] + (torch.tensor(n),) + out[6:]

    run.tap.orig = chunk


def _half_batch(run):
    """The Gram of every other atom left out and the rest doubled: the
    mean over half of the rows."""
    from autoforce_tpu_torch import engine

    rows_cov = engine.rows_cov

    def half(rows, *a, **k):
        cov = rows_cov(rows, *a, **k)
        keep = torch.zeros(cov.shape[0], 1, dtype=cov.dtype)
        keep[1::2] = 2.0
        return cov * keep

    engine.rows_cov = half
    run.restore = lambda: setattr(engine, "rows_cov", rows_cov)


def _altered_force(run):
    """One force component altered where the step produces it."""
    from autoforce_tpu_torch.md import device_md

    forces = device_md._sgpr_forces

    def altered(*a, **k):
        e, f, b = forces(*a, **k)
        f = f.clone()
        f[0, 0] += 0.05
        return e, f, b

    device_md._sgpr_forces = altered
    run.restore = lambda: setattr(device_md, "_sgpr_forces", forces)


@pytest.mark.parametrize("fault", [_unchanged, _half_batch, _altered_force],
                         ids=["state_unchanged", "half_batch", "altered_force"])
def test_fault_turns_correct_false(fault):
    holder = {}

    def apply(run):
        fault(run)
        holder["run"] = run

    try:
        res = _run(apply)
    finally:
        restore = getattr(holder.get("run"), "restore", None)
        if restore is not None:
            restore()
    assert res["correct"] is False


def test_gemm_reader_reads_only_float64_gemms():
    """gemm_ms_per_step is the Gram's float64 products: the in-loop
    rebuild's float32 GEMM, under the names cuBLAS gave it on an H100, is
    left out."""
    from portbench.metrics import gemm_ms_per_step

    f64 = ("sm90_xmma_gemm_f64f64_f64f64_f64_nn_n_tilesize64x128x16_stage3_"
           "warpsize2x2x1_tensor16x8x8_execute_kernel__5x_cublas")
    f32 = ("sm80_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize64x32x8_stage3_"
           "warpsize1x2x1_ffma_aligna4_alignc4_execute_kernel__5x_cublas")
    small32 = "void gemmSN_TN_kernel<float, 128, 16, 2, 4, 4, 4, true>"
    kernels = [(f64, 0.0, 300.0), (f32, 400.0, 5000.0), (small32, 9e3, 70.0),
               ("soap_fwd_kernel", 1e4, 50.0), (f64, 2e4, 100.0)]
    rec = {"slice_steps": 2, "events": {"kernels": kernels}}
    assert gemm_ms_per_step.read(rec) == pytest.approx(0.2)
    rec["events"]["kernels"] = kernels[1:4]
    assert gemm_ms_per_step.read(rec) is None
