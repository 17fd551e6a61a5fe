#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``autoforce_tpu_torch``) on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (any fault ends the run with a non-zero exit and no ``ok`` line):

1. Environment: the card's name and power limit; the SOAP-coefficient
   kernels are built from ``autoforce_tpu_torch/csrc`` with ``nvcc`` and
   its register / shared-memory / spill report is printed.
2. Each kernel against its plain PyTorch version on the card, on the
   inputs of the main path (the 1008-atom bench snapshot at the MD neighbor
   bucket and at rc, and the 4-species snapshot) in float64 and float32,
   and on the 10,192-atom snapshot at the MD bucket rule in float32; the
   backward also against torch autograd through the plain forward.
3. Accuracy of ``Engine.predict`` (float32 on the card) on the 1008-atom
   Cu snapshot against the float64 reference ``baselines/_acc_ref.npz``,
   and the energy error of each float32 stage taken alone.
4. Serving MD: ``DeviceMD`` around ``ActiveCalculator(covariance=<model
   folder>, calculator=None, skin=1.2)``: Langevin 300 K, 2 fs, friction
   0.02, chunk 100 (the main path, with every launch counter read around
   it), then 1000 NVE steps for the energy drift.
5. Timings: steps/s of phase 4; each kernel's device time beside its
   plain version's and its bound at three shapes (the MD bucket of phase
   4, the 10,192-atom snapshot, the 4-species snapshot); a profiler
   breakdown of the MD step.

The line before the last is one JSON object with every kernel's numbers;
the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import sys
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))
MODEL = os.path.join(HERE, "baselines", "bench_model.pckl")
MODEL_MS = os.path.join(HERE, "baselines", "bench_model_ms.pckl")
ACC_REF = os.path.join(HERE, "baselines", "_acc_ref.npz")
SKIN = 1.2
# float32 kernel vs plain: both sum up to K float32 terms in different
# orders; K * eps ~ 2e-5 is the worst case at K = 176, sqrt(K) * eps the
# typical one.  Relative to the largest magnitude of the result.
F32_REL_TOL = 1e-5
F64_ABS_TOL = 1e-10


def log(*a):
    print(*a, flush=True)


# ----------------------------------------------------------------- phases


def phase_build():
    from autoforce_tpu_torch.descriptor import soap_kernels as sk
    from autoforce_tpu_torch.tools import soap_bench as sb

    t0 = time.time()
    sk.build_library(force=True)
    log(f"built {sk.LIB_PATH} in {time.time() - t0:.1f} s")
    sb.print_build_report(sk.build_log)


def phase_kernels(cases):
    """Every kernel against its plain version on the card, in the dtypes
    each case names; returns the float32 errors by case."""
    import torch

    from autoforce_tpu_torch.descriptor import soap_kernels as sk

    worst = {}
    for name, (params, args, dtypes) in cases.items():
        for dt in dtypes:
            rvec, sidx, mask, radii = args
            rvec = rvec.to(dt)
            radii = radii.to(dt)
            N, K, _ = rvec.shape
            CH = sk.channels(radii.shape[0], params)
            g = torch.Generator(device="cuda").manual_seed(7)
            crb = torch.randn((N, CH), generator=g, device="cuda", dtype=dt)
            cib = torch.randn((N, CH), generator=g, device="cuda", dtype=dt)
            cr, ci = sk.soap_coeff_fwd(rvec, sidx, mask, radii, params)
            pr, pi = sk.soap_coeff_fwd_plain(rvec, sidx, mask, radii, params)
            rb = sk.soap_coeff_bwd(rvec, sidx, mask, radii, crb, cib, params)
            pb = sk.soap_coeff_bwd_plain(rvec, sidx, mask, radii, crb, cib, params)
            torch.cuda.synchronize()
            e_f = max((cr - pr).abs().max().item(), (ci - pi).abs().max().item())
            e_b = (rb - pb).abs().max().item()
            s_f = max(pr.abs().max().item(), pi.abs().max().item())
            s_b = pb.abs().max().item()
            if dt == torch.float64:
                tol_f = tol_b = F64_ABS_TOL
                rv = rvec.detach().requires_grad_(True)
                a, b = sk.soap_coeff_fwd_plain(rv, sidx, mask, radii, params)
                (ga,) = torch.autograd.grad((a * crb).sum() + (b * cib).sum(), rv)
                e_a = (rb - ga).abs().max().item()
                log(f"{name} float64 N={N} K={K} S={radii.shape[0]}: "
                    f"fwd {e_f:.3e} bwd {e_b:.3e} bwd-vs-autograd {e_a:.3e} "
                    f"(tol {F64_ABS_TOL:g} abs)")
                if not e_a <= 1e-9 * max(1.0, s_b):
                    raise AssertionError(f"{name}: backward vs autograd {e_a}")
            else:
                tol_f = F32_REL_TOL * s_f
                tol_b = F32_REL_TOL * s_b
                log(f"{name} float32 N={N} K={K} S={radii.shape[0]}: "
                    f"fwd {e_f:.3e} (tol {tol_f:.3e}) bwd {e_b:.3e} "
                    f"(tol {tol_b:.3e})")
                worst[name] = (e_f, e_b)
            if not (e_f <= tol_f and e_b <= tol_b):
                raise AssertionError(f"{name} {dt}: kernel disagrees with plain")
            # the m > l channels are written as zero
            L = params.lmax + 1
            zero = torch.ones(L, L, dtype=torch.bool).triu(1).reshape(-1)
            zmask = zero.repeat(CH // (L * L)).to("cuda")
            if cr[:, zmask].abs().max().item() != 0 or ci[:, zmask].abs().max().item() != 0:
                raise AssertionError(f"{name}: m > l channels not zero")
    return worst


def phase_accuracy(model):
    import numpy as np
    import torch

    from autoforce_tpu_torch.tools import soap_bench as sb

    eng = model.engine
    system = sb.bench_system()
    n = len(system)
    cfg = eng.make_config(system)
    ma = model.full_model_arrays()
    e, f, *_ = eng.predict(cfg, ma, np.ones(cfg.npad))
    torch.cuda.synchronize()
    ref = np.load(ACC_REF)
    e_err = abs(float(e) - float(ref["e"])) / n
    f_mae = float(np.abs(f.cpu().numpy()[:n] - ref["f"]).mean())
    log(f"accuracy (float32 predict vs float64 reference, {n} atoms, "
        f"K={cfg.nbr_idx.shape[1]}): energy error {e_err:.3e} eV/atom "
        f"(bar 2e-4), force MAE {f_mae:.3e} eV/A (bar 1e-2)")
    if not (e_err < 2e-4 and f_mae < 1e-2):
        raise AssertionError("predict misses the accuracy bars")
    precision_breakdown(system, float(ref["e"]))
    return e_err, f_mae


def precision_breakdown(system, e_ref, device="cuda"):
    """Energy error of the float32 stages one at a time (informational).

    Inducing descriptors X and per-atom descriptors p are made several
    ways; each (p, X) pair is contracted in float64 against the float64
    weights, so the printed error is that of the descriptors alone, and
    two pairs are also contracted in float32 (the Gram block and energy in
    the working type)."""
    import numpy as np
    import torch

    from autoforce_tpu_torch.descriptor import soap_kernels as sk
    from autoforce_tpu_torch.descriptor.soap import power_spectrum
    from autoforce_tpu_torch.io.model_io import load_model
    from autoforce_tpu_torch.kernels import gram

    f32, f64 = torch.float32, torch.float64
    m = load_model(MODEL, device=device, dtype=f64)
    eng, params = m.engine, m.engine.params
    L, nf = params.lmax + 1, params.nmax + 1
    ma = m.full_model_arrays()
    mm = ma.m_mask
    n = len(system)
    envs = eng.make_envs([(x.rvec, x.numbers) for x in m.X], dtype=f64)
    radii = eng.radii_table()

    def desc(rvec, sidx, mask, rad, route, spectrum_dtype=None):
        fwd = sk.soap_coeff_fwd if route == "kernel" else sk.soap_coeff_fwd_plain
        with torch.no_grad():
            cr, ci = fwd(rvec, sidx, mask, rad, params)
        if spectrum_dtype is not None:
            cr, ci = cr.to(spectrum_dtype), ci.to(spectrum_dtype)
        S = rad.shape[0]
        return power_spectrum(cr.reshape(-1, S, nf, L, L),
                              ci.reshape(-1, S, nf, L, L), params)

    ev = (envs.rvec, envs.sidx, envs.mask)
    ev32 = (envs.rvec.to(f32), envs.sidx, envs.mask)
    cpu = tuple(t.cpu() for t in ev32)
    X = {
        "float64 kernel": desc(*ev, radii, "kernel"),
        "float64 kernel, rvec rounded to float32":
            desc(envs.rvec.to(f32).to(f64), envs.sidx, envs.mask, radii, "kernel"),
        "float64 kernel, X rounded to float32":
            desc(*ev, radii, "kernel").to(f32),
        "float32 kernel": desc(*ev32, radii.to(f32), "kernel"),
        "float32 kernel coefficients, float64 spectrum":
            desc(*ev32, radii.to(f32), "kernel", f64),
        "float32 plain version on the card": desc(*ev32, radii.to(f32), "plain"),
        "float32 plain version on the CPU": desc(*cpu, radii.cpu().to(f32), "plain"),
    }
    X = {k: v.to(device) for k, v in X.items()}
    x32 = X["float32 kernel"].to(f64)
    X["float32 kernel, renormalised in float64"] = x32 / x32.norm(dim=1, keepdim=True)
    x64 = X["float64 kernel"]
    cfg64 = eng.make_config(system)
    with torch.no_grad():
        rv = _env_rvec_of(cfg64)
    mask = cfg64.nbr_mask & cfg64.atom_mask[:, None]
    P = {
        "float64 kernel": desc(rv, cfg64.nbr_sidx, mask, radii, "kernel"),
        "float32 kernel": desc(_env_rvec_of(cfg64, f32), cfg64.nbr_sidx, mask,
                               radii.to(f32), "kernel"),
    }
    lone = torch.zeros(cfg64.npad, dtype=torch.bool, device=device)
    amask = cfg64.atom_mask

    def energy(p, x, dtype):
        k = gram(p.to(dtype), cfg64.numbers, lone, x.to(dtype), ma.X_num,
                 ma.X_lone, eng.exponent)
        k = k * (amask[:, None] & mm[None, :])
        return float((k @ ma.mu.to(dtype)).sum())

    log("precision breakdown: energy error per atom of float64 predict "
        "with one stage in float32 (descriptor errors: max, rms over the "
        "live components of X; norm errors |x| - 1: rms, mean)")
    live = x64.abs() > 0
    for name, x in X.items():
        dx = (x.to(f64) - x64)[live]
        dn = x.to(f64).norm(dim=1) - 1
        err = (energy(P["float64 kernel"], x, f64) - e_ref) / n
        log(f"  X {name}: {err:+.3e} eV/atom; dX max {dx.abs().max():.2e} "
            f"rms {dx.pow(2).mean().sqrt():.2e}; norm rms "
            f"{dn.pow(2).mean().sqrt():.2e} mean {dn.mean():+.2e}")
    # the spread of that error over rounding patterns: X64 with a random
    # relative error of float32 rounding size (uniform in +-eps/2) per
    # component, eight draws
    g = torch.Generator(device=device).manual_seed(0)
    eps = torch.finfo(f32).eps
    draws = []
    for _ in range(8):
        u = torch.rand(x64.shape, generator=g, device=device, dtype=f64) - 0.5
        draws.append((energy(P["float64 kernel"], x64 * (1 + eps * u), f64)
                      - e_ref) / n)
    log(f"  X float64 with simulated float32 rounding, 8 draws: "
        f"{', '.join(f'{d:+.2e}' for d in draws)} eV/atom (rms "
        f"{float(np.sqrt(np.mean(np.square(draws)))):.2e})")
    err = (energy(P["float32 kernel"], x64, f64) - e_ref) / n
    log(f"  p float32 kernel (X float64): {err:+.3e} eV/atom")
    for name in ("float32 kernel", "float64 kernel, X rounded to float32"):
        err = (energy(P["float32 kernel"], X[name], f32) - e_ref) / n
        log(f"  p float32 kernel, X {name}, Gram and energy in float32: "
            f"{err:+.3e} eV/atom")


def _env_rvec_of(cfg, dtype=None):
    from autoforce_tpu_torch.engine import _env_rvec

    pos, cell = cfg.positions, cfg.cell
    if dtype is not None:
        pos, cell = pos.to(dtype), cell.to(dtype)
    return _env_rvec(pos, cell, cfg).contiguous()


def phase_md(model, card):
    """The main path: serving MD with the launch counters read around it.
    Returns (steps/s list, launches, NVE drift, MD-bucket kernel inputs)."""
    import numpy as np
    import torch

    from autoforce_tpu_torch import units
    from autoforce_tpu_torch.calculator.active import ActiveCalculator
    from autoforce_tpu_torch.descriptor import soap_kernels as sk
    from autoforce_tpu_torch.md.device_md import DeviceMD
    from autoforce_tpu_torch.system import maxwell_boltzmann_velocities
    from autoforce_tpu_torch.tools import soap_bench as sb

    sk.soap_coeff_fwd.launches = 0
    sk.soap_coeff_bwd.launches = 0
    calc = ActiveCalculator(covariance=MODEL, calculator=None, skin=SKIN)
    system = sb.bench_system()
    system.calc = calc
    maxwell_boltzmann_velocities(system, 300, seed=3)
    dyn = DeviceMD(system, calc, dt=2 * units.fs, temperature_K=300,
                   friction=0.02, chunk=100, check_beta=False)
    dyn.run(100)  # warm-up: first calls, neighbor bucket
    torch.cuda.synchronize()
    steps = 300
    rates = []
    for _ in range(3):
        t0 = time.time()
        dyn.run(steps)
        torch.cuda.synchronize()
        rates.append(steps / (time.time() - t0))
    launches = {"soap_coeff_fwd": sk.soap_coeff_fwd.launches,
                "soap_coeff_bwd": sk.soap_coeff_bwd.launches}
    T = system.get_temperature()
    pos = system.get_positions()
    log(f"Langevin MD: {len(system)} atoms, K bucket {calc.cfg.nbr_idx.shape[1]}, "
        f"100 + {3 * steps} steps, steps/s {', '.join(f'{r:.1f}' for r in rates)} "
        f"[{card}]; T = {T:.1f} K; launches {launches}")
    if not (np.isfinite(pos).all() and np.isfinite(T)):
        raise AssertionError("Langevin MD produced non-finite state")
    for name, c in launches.items():
        if c == 0:
            raise AssertionError(f"{name} never launched on the MD path")
    md_inputs = sb.kernel_inputs(calc.engine, system, kpad=calc.cfg.nbr_idx.shape[1],
                              cutoff=calc.engine.params.rc + SKIN)

    # NVE energy conservation (bench.accuracy_gate)
    s = sb.bench_system()
    maxwell_boltzmann_velocities(s, 300, seed=11)
    calc2 = ActiveCalculator(covariance=model, calculator=None, skin=SKIN)
    s.calc = calc2

    def etot():
        return s.get_potential_energy() + s.get_kinetic_energy()

    nve = DeviceMD(s, calc2, dt=2 * units.fs, chunk=500, check_beta=False,
                   thermostat="none")
    e0 = etot()
    t0 = time.time()
    nve.run(1000)
    torch.cuda.synchronize()
    t_nve = time.time() - t0
    e1 = etot()
    drift = abs(e1 - e0) / len(s)
    log(f"NVE: 1000 steps in {t_nve:.2f} s ({1000 / t_nve:.1f} steps/s) "
        f"[{card}]; drift {drift:.3e} eV/atom per 1k steps (bar 1e-3)")
    if not drift < 1e-3:
        raise AssertionError("NVE drift above the bar")
    return rates, launches, drift, md_inputs, dyn


def phase_profile(dyn, ms_per_step, card):
    """Device time by kernel over 50 MD steps (torch.profiler), and the
    device's busy share of an unprofiled step ('not measured' when the
    profiler sees no device time)."""
    import collections

    import torch
    from torch.profiler import ProfilerActivity, profile

    steps = 50
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        dyn.run(steps)
        torch.cuda.synchronize()
    by_name = collections.defaultdict(lambda: [0.0, 0])
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            row = by_name[ev.name]
            row[0] += ev.time_range.elapsed_us()
            row[1] += 1
    if not by_name:
        log("profile: no device time seen (not measured)")
        return
    busy_us = sum(r[0] for r in by_name.values()) / steps
    launches = sum(r[1] for r in by_name.values()) / steps
    log(f"profile over {steps} MD steps [{card}]: {launches:.0f} device kernels "
        f"per step, {busy_us:.1f} us of device time per step; unprofiled step "
        f"{ms_per_step * 1e3:.1f} us -> device busy {100 * busy_us / (ms_per_step * 1e3):.1f}%")
    rows = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    for name, (us, count) in rows[:12]:
        log(f"  {us / steps:8.2f} us/step  x{count / steps:5.1f}/step  {name[:100]}")
    # where the host's time goes (the device is idle most of the step)
    import cProfile
    import io
    import pstats

    pr = cProfile.Profile()
    pr.enable()
    dyn.run(steps)
    torch.cuda.synchronize()
    pr.disable()
    out = io.StringIO()
    pstats.Stats(pr, stream=out).sort_stats("tottime").print_stats(18)
    log(f"host profile over {steps} MD steps (cProfile, self time):")
    for line in out.getvalue().splitlines():
        if line.strip() and not line.startswith(("   Ordered", "   List")):
            log("  " + line.rstrip()[:150])


def phase_timings(cases, worst, launches, card):
    """Each kernel's device time beside its plain version's and its bound
    at every timing shape; the MD bucket's numbers are the row's own."""
    import torch

    from autoforce_tpu_torch.descriptor import soap_kernels as sk
    from autoforce_tpu_torch.tools import soap_bench as sb

    rows = {"soap_coeff_fwd": [], "soap_coeff_bwd": []}
    for shape, (params, (rvec, sidx, mask, radii)) in cases.items():
        N, K, _ = rvec.shape
        S = radii.shape[0]
        CH = sk.channels(S, params)
        g = torch.Generator(device="cuda").manual_seed(11)
        crb = torch.randn((N, CH), generator=g, device="cuda", dtype=rvec.dtype)
        cib = torch.randn((N, CH), generator=g, device="cuda", dtype=rvec.dtype)
        (fb, fo), (bb, bo), (n_valid, n_live) = sb.soap_work(rvec, sidx, mask,
                                                             radii, params)
        dname = str(rvec.dtype).replace("torch.", "")
        specs = (
            ("soap_coeff_fwd", "soap_fwd_kernel",
             lambda: sk.soap_coeff_fwd(rvec, sidx, mask, radii, params),
             lambda: sk.soap_coeff_fwd_plain(rvec, sidx, mask, radii, params), fb, fo),
            ("soap_coeff_bwd", "soap_bwd_kernel",
             lambda: sk.soap_coeff_bwd(rvec, sidx, mask, radii, crb, cib, params),
             lambda: sk.soap_coeff_bwd_plain(rvec, sidx, mask, radii, crb, cib, params),
             bb, bo),
        )
        for name, kname, kern, plain, nbytes, ops in specs:
            # device time of the kernel and of the plain version's kernels;
            # the elapsed time per call (CUDA events over back-to-back calls)
            # is bounded by the host when the device time is shorter
            ms = sb.device_ms(kern, 200, kname)
            plain_ms = sb.device_ms(plain, 10)
            call_ms = sb.cuda_ms(kern, 200)
            plain_call_ms = sb.cuda_ms(plain, 10)
            if ms is None or plain_ms is None:
                log("profiler saw no device kernels: times are elapsed per call")
                ms, plain_ms = call_ms, plain_call_ms
            b_ms, b_by = sb.bound(nbytes, ops, dname)
            log(f"{name} {shape} {dname} N={N} K={K} S={S} ({n_valid} valid, "
                f"{n_live} live slots): device {ms * 1e3:.2f} us (plain "
                f"{plain_ms * 1e3:.1f} us), per call {call_ms * 1e3:.1f} us (plain "
                f"{plain_call_ms * 1e3:.1f} us), bound {b_ms * 1e3:.2f} us ({b_by}: "
                f"{nbytes / 1e6:.2f} MB, {ops / 1e6:.1f} Mop), {100 * b_ms / ms:.0f} % "
                f"of the bound [{card}]")
            rows[name].append({
                "shape": shape, "N": N, "K": K, "S": S, "valid": n_valid,
                "live": n_live, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                "bound_by": b_by,
            })
    out = []
    for w, (name, line) in enumerate((("soap_coeff_fwd", 104), ("soap_coeff_bwd", 146))):
        md = rows[name][0]
        out.append({
            "name": name, "route": "cuda",
            "source": "autoforce_tpu_torch/csrc/soap_coeff.cu",
            "replaces": f"autoforce_tpu/descriptor/pallas_soap.py:{line}",
            "launches": launches[name], "max_abs_err": worst["md_bucket"][w],
            "ms": md["ms"], "plain_ms": md["plain_ms"], "bound_ms": md["bound_ms"],
            "bound_by": md["bound_by"], "library_ms": None, "shapes": rows[name],
        })
    return out


def main():
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "autoforce_tpu_torch")):
        print("chip_smoke: run it from a checkout of the repository "
              "(autoforce_tpu_torch/ not found)", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from autoforce_tpu_torch.io.model_io import load_model
    from autoforce_tpu_torch.tools import soap_bench as sb

    card = sb.card_line()
    kind = torch.cuda.get_device_name(0)
    log(f"card: {card}; torch {torch.__version__} CUDA {torch.version.cuda}; "
        f"device 0: {kind}")
    phase_build()
    model = load_model(MODEL, device="cuda", dtype=torch.float32)
    model_ms = load_model(MODEL_MS, device="cuda", dtype=torch.float32)
    eng, eng_ms = model.engine, model_ms.engine
    # the MD bucket (what ActiveCalculator gives at rc + skin), the
    # 10,192-atom snapshot at the same rule, and the 4-species snapshot
    timing = sb.timing_cases(eng, eng_ms)
    both = (torch.float64, torch.float32)
    cases = {
        "md_bucket": timing["md_bucket"] + (both,),
        "snapshot_rc": (eng.params, sb.kernel_inputs(eng, sb.bench_system()), both),
        "multispecies": timing["multispecies"] + (both,),
        "scale_10k": timing["scale_10k"] + ((torch.float32,),),
    }
    worst = phase_kernels(cases)
    del cases
    phase_accuracy(model)
    rates, launches, drift, md_inputs, dyn = phase_md(model, card)
    k_md = timing["md_bucket"][1][0].shape[1]
    if md_inputs[0].shape[1] != k_md:
        log(f"note: MD bucket K={md_inputs[0].shape[1]} (phase 2 used {k_md})")
    timing["md_bucket"] = (eng.params, md_inputs)
    rows = phase_timings(timing, worst, launches, card)
    rates.sort()
    phase_profile(dyn, 1.0 / rates[1] * 1e3, card)
    log(f"summary: {len(md_inputs[0])}-atom Cu Langevin MD median "
        f"{rates[1]:.1f} steps/s [{card}]")
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    except Exception:
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        rc = 1
    sys.stdout.flush()
    os._exit(rc)
