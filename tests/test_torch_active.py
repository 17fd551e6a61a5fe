"""On-the-fly learning end to end: the same short run through the JAX
package and the port (CPU, float64, single-thread BLAS), and the port's
ActiveCalculator, tape, model folders and EMT oracle.

The run: the 32-atom Cu/Ag Lennard-Jones mixture of
tests/test_device_active.py, learned from seed by ``DeviceMD`` with the
uncertainty trip armed and no thermostat (no random numbers differ
between the packages), lmax = nmax = 2, rc = 4.5 Å.  The per-update
optimization of the noise level is switched off in this run (``ioptim``):
scipy's minimizer of the force-MAE objective converges only to its own
tolerance, so two states that differ by rounding (~1e-15) come out of it
~1e-6 apart and the runs drift apart after it.  The optimizer itself is
held against JAX on one carried state (``test_optimizing_refit_matches``).
"""

import os
import re

import numpy as np
import pytest
import torch

from autoforce_tpu import units
from autoforce_tpu.calculator.active import ActiveCalculator as JaxCalc
from autoforce_tpu.calculator.emt import EMT as JaxEMT
from autoforce_tpu.md.device_md import DeviceMD as JaxDeviceMD
from autoforce_tpu.system import bulk_fcc as jax_bulk_fcc
from autoforce_tpu.system import maxwell_boltzmann_velocities
from autoforce_tpu_torch.calculator.active import ActiveCalculator, FilterDeltas, Switch
from autoforce_tpu_torch.calculator.emt import EMT
from autoforce_tpu_torch.calculator.oracles import MixtureLennardJones
from autoforce_tpu_torch.io.convert import sgpr_model_from_jax
from autoforce_tpu_torch.io.model_io import load_model, save_model
from autoforce_tpu_torch.md.device_md import DeviceMD
from autoforce_tpu_torch.system import System
from test_multispecies import EPS, SIG, BinaryLJ, mixture

F64 = dict(device="cpu", dtype=torch.float64)
KW = dict(kernel_kw=dict(cutoff=4.5, lmax=2, nmax=2), ediff=0.02,
          ediff_tot=0.05, fdiff=0.08, noise_f=0.01, ioptim=10**6)
STEPS = 40
# the lines of active.log that record a sampling decision or a size
EVENTS = ("seed size", "added indu", "accept", "added data", "downsized")


def port_system(s):
    return System(numbers=s.numbers, positions=s.positions, cell=s.cell,
                  pbc=s.pbc, velocities=s.get_velocities())


def events(path):
    out = []
    for line in open(path):
        msg = re.sub(r"^\S+ \S+ ", "", line).strip()
        if any(e in msg for e in EVENTS):
            # DF values are floats; the decision is the accept flag
            out.append(re.sub(r"DF: \S+", "DF:", msg))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # sum order: the decisions are threshold tests
    s0 = mixture(7)
    maxwell_boltzmann_velocities(s0, 250, seed=8)
    out = {}
    for name in ("jax", "torch"):
        tmp = str(tmp_path_factory.mktemp(name))
        cwd = os.getcwd()
        os.chdir(tmp)
        try:
            if name == "jax":
                calc = JaxCalc(covariance=None, calculator=BinaryLJ(EPS, SIG),
                               logfile="active.log", pckl="model.pckl",
                               tape="model.sgpr", **KW)
                s, D = s0.copy(), JaxDeviceMD
            else:
                calc = ActiveCalculator(
                    covariance=None, calculator=MixtureLennardJones(EPS, SIG),
                    logfile="active.log", pckl="model.pckl", tape="model.sgpr",
                    **KW, **F64)
                s, D = port_system(s0), DeviceMD
            s.calc = calc
            dyn = D(s, calc, dt=2 * units.fs, chunk=10, thermostat="none")
            assert dyn.check_beta
            dyn.run(STEPS)
        finally:
            os.chdir(cwd)
        out[name] = (tmp, calc, s, dyn)
    yield out
    torch.set_num_threads(threads)


def test_same_sampling_decisions_and_sizes(runs):
    (jt, jc, js, jd), (tt, tc, ts, td) = runs["jax"], runs["torch"]
    je = events(os.path.join(jt, "active.log"))
    te = events(os.path.join(tt, "active.log"))
    assert te == je
    assert any("seed size" in e for e in te)
    assert sum("added indu" in e for e in te) >= 2
    assert tc.size == jc.size and tc.size[0] >= 1 and tc.size[1] >= 10
    assert td.nsteps == jd.nsteps == STEPS


def test_same_model_and_final_snapshot(runs):
    (_, jc, js, _), (_, tc, ts, _) = runs["jax"], runs["torch"]
    jm, tm = jc.model, tc.model
    assert np.abs(tm.mu - jm.mu).max() <= 1e-8 * np.abs(jm.mu).max()
    np.testing.assert_allclose(ts.positions, js.positions, rtol=0, atol=1e-8)
    # the served models on the final snapshot, oracle detached
    jserve = JaxCalc(covariance=jm, calculator=None, logfile=None, pckl=None,
                     tape=None)
    tserve = ActiveCalculator(covariance=tm, calculator=None, logfile=None,
                              pckl=None, tape=None)
    jr = jserve.calculate(js.copy())
    tr = tserve.calculate(port_system(js))
    assert abs(tr["energy"] - jr["energy"]) <= 1e-8
    np.testing.assert_allclose(tr["forces"], jr["forces"], rtol=0, atol=1e-8)
    np.testing.assert_allclose(tr["stress"], jr["stress"], rtol=0, atol=1e-8)


def test_optimizing_refit_matches(runs):
    """The noise optimization (scipy) on one state: the JAX model's, and
    the same state carried into the port."""
    jm = runs["jax"][1].model
    tm = sgpr_model_from_jax(jm, **F64)
    for mdl in (jm, tm):
        mdl._fvqr = mdl._sqr = None
        mdl.make_munu(optimize=True, noise_f=0.01)
    np.testing.assert_allclose(tm.mu, jm.mu, rtol=1e-8, atol=1e-12)
    assert tm.scaled_noise["all"] == pytest.approx(jm.scaled_noise["all"], rel=1e-10)


def test_switch():
    s = Switch([0.01, 1.0, 0.05, 3.0, 0.1])
    assert (s(0.5), s(2.0), s(5.0)) == (0.01, 0.05, 0.1)
    with pytest.raises(RuntimeError):
        Switch([0.1, 3.0, 0.2, 1.0, 0.3])


def test_veto(runs):
    _, calc, s, _ = runs["torch"]
    saved = calc._veto, calc.results
    try:
        calc._veto = {"forces": 1e-9}
        calc.results = {"forces": np.ones((len(s), 3))}
        if calc.size[0] < 2:
            assert calc.veto() is False  # never vetoed below two records
        else:
            assert calc.veto() is True
        calc._veto = {}
        assert calc.veto() is False
    finally:
        calc._veto, calc.results = saved


def test_filter_deltas_smooths_updates(runs):
    tm = runs["torch"][1].model
    calc = ActiveCalculator(covariance=tm, calculator=None, logfile=None,
                            pckl=None, tape=None)
    s = port_system(runs["torch"][2])
    filt = FilterDeltas(calc, shrink=0.9)
    res = filt.calculate(s)
    assert np.isfinite(res["forces"]).all()
    calc.deltas = {"forces": np.ones_like(res["forces"]), "stress": np.zeros(6)}
    filt.calculate(s)  # the calculator clears the deltas it did not make
    filt.f = np.ones_like(res["forces"])
    prev = np.abs(filt.f).max()
    for _ in range(5):
        filt.calculate(s)
        cur = np.abs(filt.f).max()
        assert cur < prev
        prev = cur


def test_tape_rebuild_from_either_package(runs, tmp_path):
    """cl.build analog: reconstruct a model from a .sgpr tape, the port's
    own and the JAX package's."""
    s = runs["torch"][2]
    ref = s.copy()
    ref.calc = MixtureLennardJones(EPS, SIG)
    f_ref = ref.get_forces()
    sizes = []
    for name in ("torch", "jax"):
        calc = ActiveCalculator(
            covariance=None, calculator=None, logfile=None,
            pckl=str(tmp_path / f"{name}.pckl"),
            tape=os.path.join(runs[name][0], "model.sgpr"),
            kernel_kw=dict(cutoff=4.5, lmax=2, nmax=2), **F64)
        calc.build()
        sizes.append(calc.size)
        res = calc.calculate(s.copy())
        assert np.abs(res["forces"] - f_ref).mean() < 0.3
    assert sizes[0] == sizes[1] and sizes[0][1] > 0


def test_include_tape_replays_the_jax_run(runs):
    """A port calculator trains from the JAX package's tape through the
    sampling policy (include_tape)."""
    calc = ActiveCalculator(covariance=None, calculator=None, logfile=None,
                            pckl=None, tape=None, **KW, **F64)
    calc.include_tape(os.path.join(runs["jax"][0], "model.sgpr"))
    ndata, m = calc.size
    assert ndata >= 1 and m > 0


def test_persistence_roundtrip(runs, tmp_path):
    _, calc, s, _ = runs["torch"]
    folder = str(tmp_path / "model2.pckl")
    save_model(calc.model, folder)
    model2 = load_model(folder, **F64)
    assert model2.size == calc.model.size
    np.testing.assert_allclose(model2.M, calc.model.M, atol=1e-8)
    np.testing.assert_allclose(model2.mu, calc.model.mu, atol=1e-8)
    r = []
    for model in (model2, calc.model):
        c = ActiveCalculator(covariance=model, calculator=None, logfile=None,
                             pckl=None, tape=None)
        r.append(c.calculate(s.copy()))
    np.testing.assert_allclose(r[0]["energy"], r[1]["energy"], rtol=1e-6)
    np.testing.assert_allclose(r[0]["forces"], r[1]["forces"], atol=1e-6)
    # the learning run saved its folder on every update
    assert os.path.isdir(os.path.join(runs["torch"][0], "model.pckl"))


def test_incremental_covloss_matches_full(runs):
    """update_inducing's rank-1 covloss update after a bordered commit
    equals the full O(N m^2) recompute."""
    tm = runs["torch"][1].model
    calc = ActiveCalculator(covariance=sgpr_model_from_jax(runs["jax"][1].model, **F64),
                            calculator=MixtureLennardJones(EPS, SIG),
                            logfile=None, pckl=None, tape=None, **KW, **F64)
    assert calc.model.size == tm.size
    s = port_system(runs["torch"][2])
    calc.system = s
    calc._make_cfg(s)
    calc._predict()
    model = calc.model
    c0 = calc._host_c()
    k = int(np.argmax(calc._beta_from_c(c0)))
    env = calc.extract_env(k)
    m0 = model.m
    model.fast_trial_min_m = 2
    added, _ = model.add_1inducing(env, np.finfo(np.float64).eps)
    assert added == 1 and model.m == m0 + 1
    assert model._bordered_sv == model.state_version
    calc._extend_cov(model.X[-1])
    bn = calc._cov @ model.choli[-1]
    np.testing.assert_allclose(c0 + bn * bn, calc._host_c(), rtol=1e-9, atol=1e-12)


def test_oracle_is_checked():
    with pytest.raises(TypeError):
        ActiveCalculator(covariance=None, calculator=object(), logfile=None,
                         pckl=None, tape=None, **F64)
    # the mesh is ported: a mesh object is checked like the oracle
    with pytest.raises(TypeError):
        ActiveCalculator(covariance=None, calculator=None, logfile=None,
                         pckl=None, tape=None, mesh=object(), **F64)


@pytest.mark.parametrize("case", ["cu_rattled", "cu_au_strained"])
def test_emt_matches_jax(case):
    s = jax_bulk_fcc("Cu", 3.6).repeat((2, 1, 1))
    if case == "cu_au_strained":
        s.numbers[::3] = 79
        s.cell = s.cell @ (np.eye(3) + 0.01 * np.arange(9).reshape(3, 3) / 9)
    s.rattle(0.05, seed=0)
    ref = JaxEMT().calculate(s)
    got = EMT(device="cpu").calculate(port_system(s))
    assert abs(got["energy"] - ref["energy"]) <= 1e-10
    np.testing.assert_allclose(got["forces"], ref["forces"], rtol=0, atol=1e-10)
    np.testing.assert_allclose(got["stress"], ref["stress"], rtol=0, atol=1e-10)


def test_log_parse_matches_jax(runs):
    """``analysis.logs.parse_logfile`` of the port's active.log against the
    JAX package's parse of its own log from the same run: the same
    inducing, data and fit rows, energies within the run's tolerance."""
    from autoforce_tpu.analysis.logs import parse_logfile as jax_parse
    from autoforce_tpu_torch.analysis.logs import log_to_figure, parse_logfile

    jd = jax_parse(os.path.join(runs["jax"][0], "active.log"))
    td = parse_logfile(os.path.join(runs["torch"][0], "active.log"))
    assert set(td) == set(jd)
    for key in ("inducing", "data", "fit"):
        np.testing.assert_array_equal(td[key], jd[key], err_msg=key)
    assert len(td["inducing"]) >= 2 and len(td["fit"]) >= 1
    assert tuple(td["data"][-1, 1:]) + tuple(td["inducing"][-1, 1:]) == tuple(
        runs["torch"][1].size)
    for key in ("energy", "covloss", "exact", "test_errors"):
        assert td[key].shape == jd[key].shape, key
        if len(td[key]):
            np.testing.assert_array_equal(td[key][:, 0], jd[key][:, 0])
            np.testing.assert_allclose(td[key][:, 1:], jd[key][:, 1:],
                                       rtol=0, atol=1e-8, err_msg=key)
    assert len(td["energy"]) >= 1
    fig = log_to_figure(os.path.join(runs["torch"][0], "active.log"),
                        save=os.path.join(runs["torch"][0], "dash.png"))
    assert fig is not None and os.path.isfile(
        os.path.join(runs["torch"][0], "dash.png"))


def test_logs_cli_writes_the_dashboard(runs, tmp_path, monkeypatch, capsys):
    """``python -m autoforce_tpu_torch.analysis.logs active.log -o ...``."""
    from autoforce_tpu_torch.analysis import logs

    out = str(tmp_path / "dash.png")
    monkeypatch.setattr("sys.argv", ["logs", os.path.join(runs["torch"][0],
                                                          "active.log"),
                                     "-o", out])
    logs.main()
    assert os.path.getsize(out) > 0
    assert capsys.readouterr().out.strip() == f"saved {out}"
