"""Driver entries of the port: the fused SGPR step on the card and a
dry run of one whole learning step over a device mesh.

The counterpart of the JAX package's root ``__graft_entry__.py``:

  * :func:`entry` returns ``(fn, args)``: ``fn(*args)`` is the port's
    fused SGPR forward step, ``engine.predict_fn`` (energy, forces,
    virial, covariance, uncertainty), on :func:`_build_state`'s
    8-environment Cu model;
  * :func:`dryrun_multichip` runs, over ``make_mesh`` of ``n`` devices,
    what the reference's ``_dryrun_worker`` runs, in its order and with
    its checks: sharded predict, a learning step whose training
    covariance is sharded (``kernel_block``) on Lennard-Jones targets
    with the host solve, the cross-check against one device,
    ``kernel_block`` on both routes, NVE, NHC and NPT chunks, a NEB band,
    committee MD, FIRE in both cell modes on a two-species pair-term
    model whose 13 atoms pad unevenly, and on-the-fly learning, each
    sharded run held against the unsharded one.

A torch mesh may repeat a device, so no subprocess is needed: the devices
are the visible cards when there are ``n``, else ``cuda:0`` repeated; on
the CPU ``["cpu"] * n``.  The dry run is float64, so the reference's
1e-8 tolerances hold unchanged.

CLI:  python -m autoforce_tpu_torch.graft_entry [n] [--device cuda]
"""

from __future__ import annotations

import numpy as np
import torch


def _build_state(natoms_reps=(2, 2, 2), m_envs=8, rc=4.5, device="cuda",
                 dtype=None):
    """(engine, model, system, config, model arrays, vscale) of the
    reference's state: ``m_envs`` inducing environments of rattled fcc Cu,
    weights and ``choli`` made with numpy from seed 0 exactly as the
    reference makes them, and a rattled Cu crystal."""
    from .descriptor.soap import SoapParams
    from .engine import Engine
    from .neighbors import displacements, neighbor_table
    from .regression.sgpr import InducingEnv, SgprModel
    from .system import bulk_fcc

    eng = Engine(params=SoapParams(lmax=3, nmax=3, rc=rc), exponent=4,
                 species=[29], device=device, dtype=dtype)
    model = SgprModel(eng)
    for seed in range(m_envs):
        s = bulk_fcc("Cu", 3.6)
        s.rattle(0.1, seed=seed)
        t = neighbor_table(s.positions, s.cell, s.pbc, rc)
        r = displacements(s.positions, s.cell, t)
        i = seed % len(s)
        mask = t.mask[i]
        env = InducingEnv.from_arrays(
            s.numbers[i], r[i][mask], s.numbers[t.idx[i][mask]]
        )
        model.add_inducing(env, remake=False)
    m = model.m
    rng = np.random.default_rng(0)
    model.mu = rng.normal(size=m) * 0.1
    model.choli = np.linalg.inv(np.linalg.cholesky(model.M + 1e-6 * np.eye(m)))
    model._model_arrays = None

    sys_ = bulk_fcc("Cu", 3.6).repeat(natoms_reps)
    sys_.rattle(0.05, seed=7)
    cfg = eng.make_config(sys_)
    ma = model.full_model_arrays()
    vs = np.ones(cfg.npad)
    return eng, model, sys_, cfg, ma, vs


def entry(device="cuda", dtype=None):
    """(fn, example_args): the fused SGPR forward step (energy, forces,
    virial, covariance, uncertainty) on the 8-environment Cu model, on
    ``device`` (the card by default)."""
    from .engine import predict_fn

    eng, model, sys_, cfg, ma, vs = _build_state(device=device, dtype=dtype)
    params, exponent = eng.params, eng.exponent
    radii = eng.radii_table()

    def fn(cfg, ma, radii, vscale):
        return predict_fn(cfg, ma, radii, vscale, params, exponent)

    vscale = torch.as_tensor(vs, dtype=cfg.positions.dtype,
                             device=cfg.positions.device)
    return fn, (cfg, ma, radii, vscale)


def dryrun_devices(n_devices, device="cuda"):
    """``n_devices`` torch devices for the dry run's mesh: on the CPU
    ``cpu`` repeated; on CUDA the visible cards when there are enough,
    else ``cuda:0`` repeated."""
    if torch.device(device).type == "cpu":
        return ["cpu"] * n_devices
    cards = torch.cuda.device_count()
    if cards >= n_devices:
        return [f"cuda:{i}" for i in range(n_devices)]
    return ["cuda:0"] * n_devices


def _close(got, want, atol=0.0, rtol=0.0, what=""):
    def host(x):
        return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)

    np.testing.assert_allclose(host(got), host(want), atol=atol, rtol=rtol,
                               err_msg=what)


def _ms_engine(device, dtype):
    """The two-species engine with two pair terms and chemical mixing of
    the reference's FIRE check."""
    from .descriptor.soap import SoapParams
    from .engine import Engine
    from .pairkernels import PairTerm

    return Engine(params=SoapParams(lmax=2, nmax=2, rc=4.0), exponent=4,
                  species=[29, 47], device=device, dtype=dtype,
                  pair_terms=(PairTerm(a=29, b=29, rc=4.0, factor="polycut"),
                              PairTerm(a=29, b=47, rc=4.0, factor="polycut")),
                  chemical="rbf")


def _ms_inducing(model, centre, rc=4.0):
    """Four inducing environments of fcc Cu with one Ag site each;
    ``centre(seed)`` picks the central atom."""
    from .neighbors import displacements, neighbor_table
    from .regression.sgpr import InducingEnv
    from .system import bulk_fcc

    for seed in range(4):
        s = bulk_fcc("Cu", 3.6)
        s.numbers[centre(seed, len(s))[0]] = 47
        s.rattle(0.1, seed=seed)
        t = neighbor_table(s.positions, s.cell, s.pbc, rc)
        r = displacements(s.positions, s.cell, t)
        i = centre(seed, len(s))[1]
        msk = t.mask[i]
        model.add_inducing(InducingEnv.from_arrays(
            s.numbers[i], r[i][msk], s.numbers[t.idx[i][msk]]), remake=False)


def _thirteen(base16, rattle, seed):
    """13 atoms of the 16-atom Cu box, every fifth Ag: odd under every
    mesh shape, so the data axis pads them unevenly."""
    from .system import System

    s = System(numbers=np.where(np.arange(13) % 5 == 0, 47, 29),
               positions=base16.positions[:13].copy(), cell=base16.cell,
               pbc=base16.pbc)
    s.rattle(rattle, seed=seed)
    return s


def dryrun_multichip(n_devices: int, device="cuda") -> dict:
    """One full active-learning step and every sharded driver over an
    ``n_devices`` ('data' x 'model') mesh on tiny shapes, each sharded
    result held against the single-device one (1e-8, float64); prints the
    reference's ``multichip dryrun ok: mesh=(...)`` line and returns its
    numbers."""
    from . import units
    from .calculator.active import ActiveCalculator
    from .calculator.oracles import LennardJones, MixtureLennardJones
    from .engine import ModelArrays
    from .md.device_md import DeviceMD, md_chunk
    from .md.device_npt import md_chunk_npt
    from .opt.device_fire import DeviceFIRE
    from .opt.device_neb import DeviceNEB
    from .parallel.mesh import make_mesh, pad_chain
    from .regression.sgpr import DataRecord, SgprModel
    from .system import bulk_fcc, maxwell_boltzmann_velocities

    f64 = torch.float64
    n_model = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    n_data = n_devices // n_model
    mesh = make_mesh(n_data, n_model, devices=dryrun_devices(n_devices, device))

    eng, model, sys_, cfg, ma, vs = _build_state(
        natoms_reps=(2, 1, 1), m_envs=4, device=mesh.first, dtype=f64)
    dev = cfg.positions.device

    def t(a, dtype=f64):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    # 1) sharded predict (atoms over 'data', inducing over 'model')
    eng.mesh = mesh
    e, f, w, cov, beta = eng.predict(cfg, ma, vs)
    assert np.isfinite(float(e)), "sharded energy is not finite"
    assert torch.isfinite(f).all()

    # 2) a learning step whose training covariance rows are sharded
    # (add_data builds Ke/Kf/Kv through Engine.kernel_block over the
    # mesh) on Lennard-Jones targets, then the host solve
    lj = LennardJones(epsilon=0.15, sigma=2.3, rc=4.0)
    for seed in (11, 12):
        s = sys_.copy()
        s.rattle(0.04, seed=seed)
        s.calc = lj
        model.add_data(DataRecord.from_system(s), remake=False)
    model.make_munu(optimize=True, noise_f=0.01)

    # 3) sharded predict with the updated weights
    ma2 = model.full_model_arrays()
    vsc = model.vscale_for(cfg.numbers.cpu().numpy())
    e2, f2, w2, cov2, beta2 = eng.predict(cfg, ma2, vsc)
    assert np.isfinite(float(e2))
    assert torch.isfinite(beta2).any()

    # 4) the sharded step against the single-device step; kernel_block on
    # both routes
    eng.mesh = None
    e3, f3, w3, cov3, beta3 = eng.predict(cfg, ma2, vsc)
    _close(float(e2), float(e3), rtol=1e-8, what="energy")
    _close(f2, f3, atol=1e-8, what="forces")
    for method in ("vjp", "jac"):
        eng.mesh = None
        ke, kf, kv = eng.kernel_block(cfg, ma2, method=method)
        eng.mesh = mesh
        ke2, kf2, kv2 = eng.kernel_block(cfg, ma2, method=method)
        _close(ke2, ke, atol=1e-8, what=f"kernel_block {method} Ke")
        _close(kf2, kf, atol=1e-8, what=f"kernel_block {method} Kf")
    eng.mesh = None

    # 5) device MD over the mesh: the NVE chunk (4 steps) and an NHC chunk
    # against the single-device chunk
    npad = cfg.npad
    vel = np.zeros((npad, 3))
    vel[: len(sys_)] = np.random.default_rng(1).normal(
        0, 0.005, (len(sys_), 3))
    vsc0 = np.where(np.isfinite(vsc), vsc, 0.0)
    radii = eng.radii_table()
    kw = dict(params=eng.params, exponent=eng.exponent, check_beta=True,
              ks=eng.kernel_space())
    chain = dict(cfg=cfg, ma=ma2, vs=t(vsc0), vel=t(vel),
                 masses=t(np.ones((npad, 1))), pos0=cfg.positions,
                 mean_e=None)
    padded = pad_chain(chain, mesh)

    def md(ch, thermostat, kT=0.0, **extra):
        sharded = "oidx" in ch
        return md_chunk(
            ch["cfg"], ch["ma"], radii, ch["vs"], ch["vel"], ch["masses"],
            ch["pos0"], 0.5, kT, 0.02, 10.0, 1e9, 4, thermostat=thermostat,
            mesh=mesh if sharded else None, own_idx=ch.get("oidx"),
            noise_rows=ch.get("noise_rows"), **kw, **extra)

    out0 = md(chain, "none")
    out1 = md(padded, "none")
    assert int(out0[5]) == int(out1[5]) == 4
    _close(out1[0][:npad], out0[0], atol=1e-8, what="NVE positions")
    _close(out1[2][:npad], out0[2], atol=1e-8, what="NVE forces")
    nhc = dict(nhc_Q=t([30.0, 10.0, 10.0]), nhc_dof=3.0 * len(sys_),
               nhc_vxi=t(np.zeros(3)), nhc_xi=t(np.zeros(3)))
    nh0 = md(chain, "nhc", kT=0.01, **nhc)
    nh1 = md(padded, "nhc", kT=0.01, **nhc)
    assert int(nh0[5]) == int(nh1[5]) == 4
    _close(nh1[0][:npad], nh0[0], atol=1e-8, what="NHC positions")
    _close(nh1[-2], nh0[-2], atol=1e-8, what="NHC chain velocities")

    # 6) device NPT over the mesh: positions and cell against the
    # single-device chunk
    z3 = t(np.zeros(3))

    def npt(ch):
        sharded = "oidx" in ch
        return md_chunk_npt(
            ch["cfg"], ch["ma"], radii, ch["vs"], ch["vel"], ch["masses"],
            ch["pos0"], t(np.asarray(sys_.cell)), 0.5, 0.01, 0.001, 5000.0,
            10.0, 1e9, 3, t([30.0, 10.0, 10.0]), 3.0 * len(sys_), z3, z3,
            t([10.0, 10.0, 10.0]), z3, z3, t(0.0),
            mesh=mesh if sharded else None, own_idx=ch.get("oidx"), **kw)

    outn0, outn1 = npt(chain), npt(padded)
    assert int(outn0[6]) == int(outn1[6]) == 3
    _close(outn1[0][:npad], outn0[0], atol=1e-8, what="NPT positions")
    _close(outn1[2], outn0[2], atol=1e-10, what="NPT cell")

    # 7) a NEB band over the mesh: four images from the crystal to a
    # displaced copy, three band-FIRE iterations against one device
    n = len(sys_)
    disp = np.random.default_rng(3).normal(0, 0.02, (n, 3))
    bands = {}
    for use_mesh in (False, True):
        eng.mesh = mesh if use_mesh else None
        calc = ActiveCalculator(covariance=model, calculator=None,
                                logfile=None, pckl=None, tape=None)
        images = []
        for r in range(4):
            im = sys_.copy()
            im.positions = sys_.positions + (r / 3) * disp
            im.calc = calc
            images.append(im)
        band = DeviceNEB(images, calc, k=0.1, dt=0.05, chunk=3)
        band.run(fmax=1e-9, steps=3)
        bands[use_mesh] = (np.stack([im.positions for im in images]),
                           band.nsteps)
    eng.mesh = None
    assert bands[False][1] == bands[True][1] == 3
    _close(bands[True][0], bands[False][0], atol=1e-8, what="NEB band")

    # 8) committee MD over the mesh: two experts (the model twice, with
    # different uncertainty scales and mean energies)
    ma_c = ModelArrays(*(None if x is None else torch.stack([x, x])
                         for x in ma2))
    committee = dict(chain, ma=ma_c, vs=t(np.stack([vsc0, 0.5 * vsc0 + 0.1])),
                     mean_e=t([0.0, 0.05]))
    mean_e = committee["mean_e"]
    outc0 = md(committee, "none", mean_e=mean_e)
    outc1 = md(pad_chain(committee, mesh), "none", mean_e=mean_e)
    assert int(outc0[5]) == int(outc1[5]) == 4
    _close(outc1[0][:npad], outc0[0], atol=1e-8, what="committee positions")

    # 9) FIRE (positions, then the variable cell) on the two-species
    # pair-term + chemical engine with 13 atoms (uneven padding) and a
    # skin tight enough that the in-loop rebuild fires
    base16 = bulk_fcc("Cu", 3.6).repeat((2, 2, 1))
    fire_out = {}
    for use_mesh in (False, True):
        eng2 = _ms_engine(mesh.first, f64)
        eng2.mesh = mesh if use_mesh else None
        mdl = SgprModel(eng2)
        _ms_inducing(mdl, lambda seed, n4: (seed % n4, seed % n4))
        rng2 = np.random.default_rng(5)
        mdl.mu = rng2.normal(size=mdl.m) * 0.1
        mdl.choli = np.linalg.inv(
            np.linalg.cholesky(mdl.M + 1e-6 * np.eye(mdl.m)))
        mdl._model_arrays = None
        sms = _thirteen(base16, 0.22, 11)
        calc2 = ActiveCalculator(covariance=mdl, calculator=None,
                                 logfile=None, pckl=None, tape=None,
                                 skin=0.3)
        sms.calc = calc2
        p0 = sms.positions.copy()
        dopt = DeviceFIRE(sms, calc2, dt=0.08, chunk=6, check_beta=False)
        assert dopt.in_loop_rebuild
        dopt.run(fmax=1e-9, steps=12)
        assert dopt.nsteps == 12
        sc = sms.copy()
        sc.calc = calc2
        dcell = DeviceFIRE(sc, calc2, dt=0.05, chunk=6, check_beta=False,
                           cell=True)
        dcell.run(fmax=1e-9, steps=8)
        assert dcell.nsteps == 8
        fire_out[use_mesh] = (sms.positions.copy(), sc.positions.copy(),
                              np.asarray(sc.cell).copy(),
                              float(np.abs(sms.positions - p0).max()))
    _close(fire_out[True][0], fire_out[False][0], atol=1e-8,
           what="FIRE positions")
    _close(fire_out[True][1], fire_out[False][1], atol=1e-8,
           what="FIRE cell positions")
    _close(fire_out[True][2], fire_out[False][2], atol=1e-10, what="FIRE cell")
    # the relaxation moved atoms past half the 0.3 A skin: the in-loop
    # rebuild fired inside the chunks on both paths
    breached = fire_out[True][3] > 0.15
    assert breached, f"skin never breached (max disp {fire_out[True][3]})"

    # 10) on-the-fly learning over the mesh from a trained start: the
    # uncertainty trip fires mid-chunk, sampling adds data and inducing
    # environments through the sharded kernel_block, the model refits and
    # the chunks resume; the decisions and the trajectory equal the
    # single-device run's
    otf_out = {}
    for use_mesh in (False, True):
        oracle = MixtureLennardJones(
            {(29, 29): 0.15, (47, 47): 0.12}, {(29, 29): 2.3, (47, 47): 2.6},
            rc=4.0)
        eng3 = _ms_engine(mesh.first, f64)
        eng3.pair_terms = ()
        eng3.chemical = None
        eng3.mesh = mesh if use_mesh else None
        mdl3 = SgprModel(eng3)
        # two inducing environments per species: a 47 centre, a 29 centre
        _ms_inducing(mdl3, lambda seed, n4: (
            (seed + 1) % n4, (seed + 1) % n4 if seed % 2 == 0 else seed % n4))
        sot = _thirteen(base16, 0.05, 21)
        strain = sot.copy()
        strain.calc = oracle
        mdl3.add_data(DataRecord.from_system(strain), remake=False)
        mdl3.make_munu(optimize=True, noise_f=0.01)
        calc3 = ActiveCalculator(
            covariance=mdl3, calculator=oracle, logfile=None, pckl=None,
            tape=None, ediff=0.02, ediff_tot=0.05, fdiff=0.08, noise_f=0.01)
        sot = sot.copy()
        sot.rattle(0.1, seed=24)  # hot: the uncertainty trip must fire
        sot.calc = calc3
        maxwell_boltzmann_velocities(sot, 400, seed=22)
        dyn3 = DeviceMD(sot, calc3, dt=2 * units.fs, temperature_K=400,
                        friction=0.02, chunk=8, seed=23)
        assert dyn3.check_beta
        dyn3.run(4)
        otf_out[use_mesh] = (sot.positions.copy(), calc3.size,
                             calc3.event_counts.get("fp_calls", 0))
    assert otf_out[True][1] == otf_out[False][1], (otf_out[True][1],
                                                   otf_out[False][1])
    assert otf_out[True][2] == otf_out[False][2]
    assert otf_out[True][1][1] > 4, otf_out[True][1]
    _close(otf_out[True][0], otf_out[False][0], atol=1e-7,
           what="OTF positions")

    numbers = dict(
        mesh=f"{n_data}x{n_model}", devices=[str(d) for d in mesh.devices.ravel()],
        natoms=len(sys_), npad=npad, padded_rows=padded["cfg"].npad,
        m=model.m, E=float(e2), md_steps=int(out1[5]), nhc_steps=int(nh1[5]),
        npt_steps=int(outn1[6]), neb_steps=bands[True][1],
        committee_md_steps=int(outc1[5]), fire_steps=12, fire_cell_steps=8,
        otf_mesh_size=list(otf_out[True][1]), otf_fp_calls=otf_out[True][2],
        breached=breached)
    print(
        f"multichip dryrun ok: mesh=({n_data}x{n_model}) "
        f"natoms={len(sys_)} m={model.m} E={float(e2):.6f} "
        f"md_steps={int(out1[5])} nhc_steps={int(nh1[5])} "
        f"npt_steps={int(outn1[6])} neb_steps={bands[True][1]} "
        f"committee_md_steps={int(outc1[5])} "
        f"fire_steps=12 fire_cell_steps=8 "
        f"otf_mesh_size={otf_out[True][1]} "
        f"otf_fp_calls={otf_out[True][2]} "
        f"(multispecies pair+chemical, 13 atoms uneven padding, "
        f"in-loop rebuild breached skin: {breached}) "
        "(sharded MD + NHC + NPT + NEB + committee-MD + FIRE + OTF-learning "
        "trajectories == single-device)", flush=True)
    return numbers


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description="Dry run of one learning step "
                                "and the sharded drivers over a device mesh")
    p.add_argument("n", nargs="?", type=int, default=4)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    dryrun_multichip(args.n, device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
