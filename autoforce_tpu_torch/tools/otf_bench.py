"""The on-the-fly learning workload of the repo's OTF flagship, on the port.

A copy of ``bench.py``'s ``make_lgps_system`` and ``measure_otf`` (the JAX
bench imports the JAX package, so the port keeps its own): a 1024-atom
ordered 4-species LGPS-like crystal learns its potential energy surface
from a per-pair Lennard-Jones mixture oracle during device-resident
Langevin MD with the uncertainty trip armed, the model growing from seed.

Three stages, all with the trip armed:
  growth      — until m >= m_target, or the sampler goes quiet (a check
                window with no oracle call), or the step / wall caps;
  production  — ``prod_steps`` more with learning still on (wall-capped):
                steps/s including learning;
  frozen      — as many steps with the oracle detached, and at least ten
                chunks: the denominator of the learning overhead.

``measure_otf`` returns the numbers as a dict, with the calculator and the
last system so a caller can time the kernel columns on the learned model.
"""

from __future__ import annotations

import os
import shutil
import tempfile
import time

import numpy as np

from .. import units

RC = 6.0
LMAX = NMAX = 3
SKIN = 1.2
# the learned model's force error against the oracle must be
# threshold-consistent: fdiff = 1.5 ediff = 0.13 eV/A at the reference's
# 2 kcal/mol band (bench.py OTF_F_MAE_BOUND)
OTF_F_MAE_BOUND = 0.15  # eV/A
# LGPS-like bonding hierarchy: a strongly bound S/P/Ge frame (kT/eps ~ 0.08
# at 400 K, crystalline) with moderately bound, mobile Li (kT/eps ~ 0.23)
EPS = {(3, 3): 0.15, (32, 32): 0.45, (15, 15): 0.45, (16, 16): 0.40}
SIG = {(3, 3): 2.0, (32, 32): 2.5, (15, 15): 2.2, (16, 16): 2.3}


def make_lgps_system(reps=(4, 4, 2), rattle=0.02):
    """Ordered 4-species crystal (``bench.make_lgps_system``): a fixed
    32-site motif (Li13 Ge1 P3 S15, about the 10:1:2:12 stoichiometry of
    Li10GeP2S12) on a 2x2x2 fcc block, tiled ``reps`` times (1024 atoms at
    the default, the flagship's size)."""
    from ..system import bulk_fcc

    base = bulk_fcc("Cu", 3.7).repeat((2, 2, 2))
    base.numbers[:] = np.array([3, 16] * 13 + [15, 16, 15, 32, 16, 15])
    s = base.repeat(reps)
    s.rattle(rattle, seed=1)
    return s


def measure_otf(device="cuda", dtype=None, grow_cap=400, prod_steps=400,
                chunk=50, temperature_K=400, ediff=None, m_target=512,
                max_inducing=1024, grow_wall_cap=900.0, prod_wall_cap=480.0,
                on_stage=None, keep_log=None):
    """Run the three stages at the flagship's width (rc = RC, lmax = LMAX,
    nmax = NMAX, 1024 atoms); ``on_stage(name)`` is called just before
    each (the caller resets its counters there).  The run's side files go
    with its scratch directory; ``keep_log``: a path to copy its
    ``active.log`` to first.  Returns the numbers and the calculator."""
    from ..calculator.active import ActiveCalculator
    from ..calculator.oracles import MixtureLennardJones
    from ..md.device_md import DeviceMD
    from ..system import maxwell_boltzmann_velocities

    def stage(name):
        if on_stage is not None:
            on_stage(name)

    oracle = MixtureLennardJones(EPS, SIG, rc=RC)
    # the reference's own sampling thresholds (active.py:118-122)
    ediff = ediff if ediff is not None else 2 * units.kcal_mol
    tmp = tempfile.mkdtemp(prefix="otf_")
    cwd = os.getcwd()
    keep_log = os.path.abspath(keep_log) if keep_log else None
    os.chdir(tmp)  # active_uncertain / FP side files land here
    try:
        calc = ActiveCalculator(
            covariance=None, calculator=oracle, logfile="active.log",
            pckl=None, tape=None,
            kernel_kw=dict(cutoff=RC, lmax=LMAX, nmax=NMAX),
            ediff=ediff, ediff_tot=2 * ediff, fdiff=1.5 * ediff,
            noise_f=0.01, max_inducing=max_inducing, skin=SKIN,
            device=device, dtype=dtype,
        )
        s = make_lgps_system()
        s.calc = calc
        maxwell_boltzmann_velocities(s, temperature_K, seed=13)
        # friction 0.05/fs: each model update is a small force
        # discontinuity; the thermostat drains it
        dyn = DeviceMD(s, calc, dt=2 * units.fs, temperature_K=temperature_K,
                       friction=0.05, chunk=chunk, seed=14)
        if not dyn.check_beta:
            raise AssertionError("the uncertainty trip is not armed")

        # -------- growth: to m_target / sampler quiet / caps
        stage("grow")
        t0 = time.time()
        grow_steps = 0
        exit_reason = "m_target"
        quiet = 0
        while calc.size[1] < m_target:
            fp0 = calc.event_counts["fp_calls"]
            dyn.run(20)  # fine-grained, so a cap overshoots little
            grow_steps += 20
            quiet = quiet + 1 if calc.event_counts["fp_calls"] == fp0 else 0
            if quiet >= max(1, chunk // 20):
                exit_reason = "sampler_quiet"
                break
            if grow_steps >= grow_cap:
                exit_reason = "step_cap"
                break
            if time.time() - t0 > grow_wall_cap:
                exit_reason = "wall_cap"
                break
        t_grow = time.time() - t0
        m_grow = calc.size[1]
        pw_g = dict(calc.phase_wall)
        ev_g = dict(calc.event_counts)

        # -------- production: learning stays armed, wall-capped
        stage("prod")
        t0 = time.time()
        prod_done = 0
        prod_exit = "steps"
        while prod_done < prod_steps:
            # two steps at a time: near max_inducing a run of twenty
            # steps takes a minute or more of sampling, so the wall cap
            # would overshoot by that much
            sub = min(2, prod_steps - prod_done)
            dyn.run(sub)
            prod_done += sub
            if time.time() - t0 > prod_wall_cap:
                prod_exit = "wall_cap"
                break
        t_prod = time.time() - t0
        ndata, m = calc.size
        pw = {k: v - pw_g.get(k, 0.0) for k, v in calc.phase_wall.items()}
        ev = {k: v - ev_g.get(k, 0) for k, v in calc.event_counts.items()}

        # learned-model accuracy against the oracle on the final snapshot
        ref = s.copy()
        ref.calc = oracle
        res = calc.calculate(s)
        f_mae = float(np.abs(res["forces"] - ref.get_forces()).mean())
        e_err = float(abs(res["energy"] - ref.get_potential_energy()) / len(s))
        final_pos = s.get_positions().copy()
        served = calc.size

        # -------- frozen: the same steps and at least ten chunks, oracle
        # detached
        stage("frozen")
        calc._calc = None
        s2 = s.copy()
        s2.calc = calc
        maxwell_boltzmann_velocities(s2, temperature_K, seed=15)
        dyn2 = DeviceMD(s2, calc, dt=2 * units.fs, temperature_K=temperature_K,
                        friction=0.05, chunk=chunk, check_beta=False)
        dyn2.run(chunk)  # warm-up
        frozen_steps = max(prod_done, 10 * chunk)
        t0 = time.time()
        dyn2.run(frozen_steps)
        t_frozen = time.time() - t0

        host = sum(pw.get(k, 0.0) for k in
                   ("staging", "predict", "active", "post"))
        out = {
            "natoms": len(s),
            "nspecies": len(set(int(z) for z in s.numbers)),
            "grow": {
                "steps": grow_steps, "wall_s": t_grow, "exit": exit_reason,
                "m_at_exit": m_grow,
                "added_inducing": ev_g.get("added_inducing", 0),
                "fp_calls": ev_g.get("fp_calls", 0),
                "updates": ev_g.get("updates", 0),
            },
            "prod_steps": prod_done, "prod_exit": prod_exit,
            "prod_wall_s": t_prod,
            "steps_per_sec_incl_learning": prod_done / t_prod,
            "frozen_steps": frozen_steps,
            "frozen_steps_per_sec": frozen_steps / t_frozen,
            "learning_overhead_x": (t_prod / prod_done) / (t_frozen / frozen_steps),
            "final_m": m, "final_ndata": ndata,
            # the model as it leaves this function (the accuracy check's
            # calculate, oracle still attached, may sample once more): the
            # one the frozen stage and its callers serve
            "served_ndata": served[0], "served_m": served[1],
            "fp_calls": ev_g.get("fp_calls", 0) + ev.get("fp_calls", 0),
            "updates": ev_g.get("updates", 0) + ev.get("updates", 0),
            "prod_fp_calls": ev.get("fp_calls", 0),
            "prod_added_inducing": ev.get("added_inducing", 0),
            "prod_updates": ev.get("updates", 0),
            "mcap_growth": calc.model.mcap_growth,
            "kpad_growth": calc.event_counts["kpad_growth"],
            # the production wall by ActiveCalculator.phase_wall
            "prod_wall_fracs": {
                "device_md": max(0.0, t_prod - host) / t_prod,
                "sampling": (pw.get("upd_inducing", 0.0)
                             + pw.get("upd_data", 0.0)
                             - pw.get("oracle", 0.0)) / t_prod,
                "refit": pw.get("upd_refit", 0.0) / t_prod,
                "oracle": pw.get("oracle", 0.0) / t_prod,
                "predict": pw.get("predict", 0.0) / t_prod,
            },
            "f_mae_vs_oracle": f_mae,
            "e_err_per_atom_vs_oracle": e_err,
            "positions_finite": bool(np.isfinite(final_pos).all()
                                     and np.isfinite(s2.positions).all()),
        }
        return out, calc
    finally:
        if keep_log and os.path.isfile(os.path.join(tmp, "active.log")):
            shutil.copyfile(os.path.join(tmp, "active.log"), keep_log)
        os.chdir(cwd)
        shutil.rmtree(tmp, ignore_errors=True)
