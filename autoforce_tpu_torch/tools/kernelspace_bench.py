"""Workloads of the kernel space on the card (``chip_smoke.py`` phase 8).

* ``learn`` — the OTF flagship's growth stage (``otf_bench``: the
  1024-atom 4-species LGPS-like crystal learning from the Lennard-Jones
  mixture oracle under ``DeviceMD``, 400 K, 2 fs, the trip armed) with an
  engine of any kernel space: a trainable kernel expression with
  ``kernel_hpo``, or the alchemical mixing with a pair term.  Stops at a
  wall, step or training-record cap.
* ``lml_record_cap`` — the record count whose energy-LML tensors still
  fit a byte budget on the card.
* ``ef_lml_records`` / ``ef_lml_value`` — the force-aware LML's value and
  gradient on four 32-atom rattled Cu records (388 target rows).
* ``predict_rel_err`` — float32 predict through the kernels against
  float64 through the plain versions.
* ``frozen_rate`` — frozen ``DeviceMD`` steps/s on a learned model, its
  chunks probed (launches, the first under CUDA's sync debug mode).
"""

from __future__ import annotations

import math
import os
import shutil
import tempfile
import time

import numpy as np
import torch

from .. import units
from .otf_bench import EPS, LMAX, NMAX, RC, SIG, SKIN, make_lgps_system

# the trainable kernel of the learning check: exp(-g ||p - q||^2), g = 0.5
GAMMA_EXPR = "Exp(Mul(Const(-1.0), Mul(SqD(), Positive(0.5))))"
# bytes the energy LML's (S, S, n, n) float64 tensors may take on the card:
# a fifth of the H100's 80 GB
LML_BYTES_CAP = 16e9
# the flagship's MD: 400 K, 2 fs, friction 0.05/fs, chunks of 50 steps
TEMPERATURE_K = 400
CHUNK = 50


def flagship_engine(device="cuda", dtype=None, **kw):
    """An Engine at the flagship's width (rc = 6 A, lmax = nmax = 3, the
    default radii) with the kernel-space options ``kw``."""
    from ..descriptor.radial import DefaultRadii
    from ..descriptor.soap import SoapParams
    from ..engine import Engine

    return Engine(params=SoapParams(lmax=LMAX, nmax=NMAX, rc=RC), exponent=4,
                  radii=DefaultRadii(), device=device, dtype=dtype, **kw)


def lml_record_cap(natoms, budget=LML_BYTES_CAP):
    """The largest record count S whose energy-LML tensors
    (``hpo.energy_lml_bytes``) fit ``budget`` bytes."""
    from ..regression.hpo import energy_lml_bytes

    S = int(math.sqrt(budget / energy_lml_bytes(1, natoms)))
    while energy_lml_bytes(S + 1, natoms) <= budget:
        S += 1
    while S > 1 and energy_lml_bytes(S, natoms) > budget:
        S -= 1
    return S


def learn(engine, wall_cap=60.0, step_cap=400, record_cap=None,
          kernel_hpo=None, on_start=None):
    """The flagship's growth stage with ``engine``'s kernel space; stops at
    the wall, step or record cap.  ``on_start()`` is called just before
    the MD (the caller resets its counters there).  Returns (numbers,
    calculator, system)."""
    from ..calculator.active import ActiveCalculator
    from ..calculator.oracles import MixtureLennardJones
    from ..md.device_md import DeviceMD
    from ..regression.sgpr import SgprModel
    from ..system import maxwell_boltzmann_velocities

    oracle = MixtureLennardJones(EPS, SIG, rc=RC)
    ediff = 2 * units.kcal_mol
    tmp = tempfile.mkdtemp(prefix="ks_")
    cwd = os.getcwd()
    os.chdir(tmp)
    try:
        calc = ActiveCalculator(
            covariance=SgprModel(engine), calculator=oracle,
            logfile="active.log", pckl=None, tape=None, ediff=ediff,
            ediff_tot=2 * ediff, fdiff=1.5 * ediff, noise_f=0.01,
            max_inducing=1024, skin=SKIN, kernel_hpo=kernel_hpo,
        )
        s = make_lgps_system()
        s.calc = calc
        maxwell_boltzmann_velocities(s, TEMPERATURE_K, seed=13)
        dyn = DeviceMD(s, calc, dt=2 * units.fs, temperature_K=TEMPERATURE_K,
                       friction=0.05, chunk=CHUNK, seed=14)
        if on_start is not None:
            on_start()
        t0 = time.time()
        update = calc.update
        last = dict(update_s=0.0, refused=0)

        def capped_update(*a, **k):
            # no update starts that the last one's duration says would end
            # past the wall cap: the chemical + pair growth's updates grow
            # to tens of seconds each as its M nears singular (ROADMAP
            # 3.1), and one in flight at the cap once ran it 43 s over.
            # The cap overshoots by at most one update's growth over the
            # one before it, and the steps in flight
            if time.time() - t0 + last["update_s"] > wall_cap:
                last["refused"] += 1
                return 0, 0
            t1 = time.time()
            out = update(*a, **k)
            last["update_s"] = time.time() - t1
            return out

        calc.update = capped_update
        steps, exit_reason = 0, "step_cap"
        while steps < step_cap:
            dyn.run(10)
            steps += 10
            if record_cap is not None and calc.size[0] >= record_cap:
                exit_reason = "record_cap"
                break
            if time.time() - t0 > wall_cap:
                exit_reason = "wall_cap"
                break
        wall = time.time() - t0
        calc.update = update
        ref = s.copy()
        ref.calc = oracle
        res = calc.calculate(s)
        f_mae = float(np.abs(res["forces"] - ref.get_forces()).mean())
        out = dict(
            steps=steps, wall_s=wall, exit=exit_reason,
            ndata=calc.size[0], m=calc.size[1],
            fp_calls=calc.event_counts["fp_calls"],
            updates=calc.event_counts["updates"],
            updates_refused=last["refused"], last_update_s=last["update_s"],
            kernel_hpo_runs=calc.event_counts["kernel_hpo"],
            kernel_hpo_moved=calc.event_counts["kernel_hpo_moved"],
            f_mae_vs_oracle=f_mae,
            forces_finite=bool(np.isfinite(res["forces"]).all()),
            positions_finite=bool(np.isfinite(s.positions).all()),
        )
        calc.logfile = None
        return out, calc, s
    finally:
        os.chdir(cwd)
        shutil.rmtree(tmp, ignore_errors=True)


def ef_lml_records(device="cuda"):
    """Four 32-atom rattled Cu records with Lennard-Jones targets, and an
    engine in float64 with the trainable kernel at g = 0.5."""
    from ..calculator.oracles import LennardJones
    from ..kernelalgebra import from_state
    from ..regression.sgpr import DataRecord
    from ..system import bulk_fcc

    eng = flagship_engine(device=device, dtype=torch.float64,
                          species=[29], kernel=from_state(GAMMA_EXPR))
    lj = LennardJones(epsilon=0.15, sigma=2.3, rc=RC)
    recs = []
    for k in range(4):
        s = bulk_fcc("Cu", 3.6).repeat((2, 2, 2))
        s.rattle(0.1, seed=40 + k)
        s.calc = lj
        recs.append(DataRecord.from_system(s))
    return eng, recs


def ef_lml_value(eng, recs):
    """(value, gradient, rows) of ``make_ef_lml`` at the expression's own
    parameters, with zero means."""
    from ..regression.hpo import make_ef_lml

    expr = eng.kernel_kind
    vg = make_ef_lml(expr, eng, recs, np.zeros(len(recs)), noise_e=1e-3,
                     noise_f=0.05)
    v, g = vg(np.asarray(expr.params(), dtype=np.float64))
    return v, g, sum(1 + 3 * r.natoms for r in recs)


def predict_rel_err(calc, system):
    """(energy error, |E|, largest force error, largest |f|, force MAE) of
    float32 predict through the kernels against float64 through the plain
    versions, on ``system`` with ``calc``'s model (staged as the calculator
    stages it)."""
    from .driver_bench import plain_kernels

    eng = calc.engine
    ma = calc.model.full_model_arrays()
    dtype = eng.dtype
    cfg32 = eng.make_config(system)
    vs = np.ones(cfg32.npad)
    e32, f32, *_ = eng.predict(cfg32, ma, vs)
    eng.dtype = torch.float64
    try:
        cfg64 = eng.make_config(system)
        with plain_kernels():
            e64, f64, *_ = eng.predict(cfg64, ma, vs)
    finally:
        eng.dtype = dtype
    n = len(system)
    f32, f64 = f32[:n].double(), f64[:n]
    return (abs(float(e32) - float(e64)), abs(float(e64)),
            (f32 - f64).abs().max().item(), f64.abs().max().item(),
            (f32 - f64).abs().mean().item())


def frozen_rate(calc, system, steps, warmup=CHUNK):
    """Frozen DeviceMD steps/s over ``steps`` steps on ``calc``'s model
    (oracle detached, trip off) after one warm-up chunk of ``warmup``
    steps; returns (steps/s, the chunk probe's record of all its
    chunks)."""
    from ..md import device_md as dmd
    from ..system import maxwell_boltzmann_velocities
    from .driver_bench import chunk_probe

    calc._calc = None
    s = system.copy()
    s.calc = calc
    maxwell_boltzmann_velocities(s, TEMPERATURE_K, seed=15)
    dyn = dmd.DeviceMD(s, calc, dt=2 * units.fs, temperature_K=TEMPERATURE_K,
                       friction=0.05, chunk=CHUNK, check_beta=False)
    with chunk_probe(dmd, "md_chunk", 5) as rec:
        dyn.run(warmup)  # warm-up, its first chunk sync-checked
        torch.cuda.synchronize()
        t0 = time.time()
        dyn.run(steps)
        torch.cuda.synchronize()
        rate = steps / (time.time() - t0)
    if not np.isfinite(s.positions).all():
        raise AssertionError("frozen MD produced non-finite positions")
    return rate, rec


def hpo_to_cap(wall_cap=900.0, step_cap=4000):
    """Kernel HPO learning (``learn`` with the trainable kernel at g = 0.5
    and ``kernel_hpo=1``, as ``chip_smoke.py`` phase 8b runs it) stopped by
    its record cap, ``lml_record_cap(1024)``, with wall and step caps
    large enough that the record cap binds first; phase 8b's own 30 s cap
    ends it after a few records.  Prints and returns the records reached,
    m, the HPO runs, g, the force MAE against the oracle, the wall time
    and the card's name and power limit.  On the card:
    ``python -m autoforce_tpu_torch.tools.kernelspace_bench``."""
    import json

    from ..kernelalgebra import from_state, softplus
    from .soap_bench import card_line

    card = card_line()
    cap = lml_record_cap(1024)
    eng = flagship_engine(dtype=torch.float32, kernel=from_state(GAMMA_EXPR))
    out, calc, _ = learn(eng, wall_cap=wall_cap, step_cap=step_cap,
                         record_cap=cap, kernel_hpo=1)
    g = float(softplus(np.asarray(eng.kernel_kind.params())[0], np))
    out = dict(out, record_cap=cap, g=g, card=card)
    print(f"kernel HPO to its record cap [{card}]: {out['ndata']} of {cap} "
          f"records, m = {out['m']}, ended by {out['exit']} after "
          f"{out['steps']} steps in {out['wall_s']:.1f} s; HPO runs "
          f"{out['kernel_hpo_runs']} (moved {out['kernel_hpo_moved']}), g "
          f"0.5 -> {g:.6g}; force MAE vs the oracle "
          f"{out['f_mae_vs_oracle']:.5f} eV/A", flush=True)
    print(json.dumps({"hpo_to_cap": out}), flush=True)
    return out


if __name__ == "__main__":
    hpo_to_cap()
