"""The port on a CUDA card: the SOAP-coefficient kernels against their
plain versions, the wrappers' checks and launch counts, float32 predict
against float64, and a short device-resident MD run.

Every test carries the ``gpu`` marker and skips where there is no card.
The module imports neither JAX nor the JAX package, so it also runs where
JAX is not installed:

    python -m pytest tests/test_torch_kernels_gpu.py -m gpu --noconftest -o addopts=""
"""

import os

import numpy as np
import pytest
import torch

from autoforce_tpu_torch.descriptor import soap_kernels as sk
from autoforce_tpu_torch.descriptor.soap import SoapParams
from autoforce_tpu_torch.tools import driver_bench as db

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = os.path.join(ROOT, "baselines", "bench_model.pckl")
PARAMS = SoapParams(lmax=3, nmax=3, rc=4.0)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def batch(device, dtype, n=37, k=29, nspecies=2, seed=0):
    rng = np.random.default_rng(seed)
    rvec = rng.uniform(-1, 1, (n, k, 3)) * 2.2
    rvec += np.sign(rvec) * 0.4
    sidx = rng.integers(0, nspecies, (n, k))
    sidx[0, :3] = [-1, nspecies, 0]  # out-of-table species add nothing
    mask = rng.random((n, k)) < 0.8
    rvec[~mask] = 0.0
    radii = np.array([1.0, 1.2, 0.9][:nspecies])
    return (torch.as_tensor(rvec, dtype=dtype, device=device),
            torch.as_tensor(sidx, device=device),
            torch.as_tensor(mask, device=device),
            torch.as_tensor(radii, dtype=dtype, device=device))


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("nspecies", [1, 3])
def test_kernels_match_plain_on_card(cuda, dtype, nspecies):
    dt = getattr(torch, dtype)
    args = batch(cuda, dt, nspecies=nspecies)
    cr, ci = sk.soap_coeff_fwd(*args, PARAMS)
    pr, pi = sk.soap_coeff_fwd_plain(*args, PARAMS)
    rb = sk.soap_coeff_bwd(*args, pr, pi, PARAMS)
    pb = sk.soap_coeff_bwd_plain(*args, pr, pi, PARAMS)
    torch.cuda.synchronize()
    # float32: reordered sums over K slots, relative to the largest value
    tol = 1e-10 if dt == torch.float64 else 1e-5
    for a, b in ((cr, pr), (ci, pi), (rb, pb)):
        scale = 1.0 if dt == torch.float64 else b.abs().max().item()
        assert (a - b).abs().max().item() <= tol * scale


def layout_batch(device, dtype, n, k, nspecies=1, seed=0, packed=False,
                 empty_rows=False, lmax=3):
    """Slots spread over 0.2-1.5 rc, so many lie at rc < d < rc + skin,
    under a random mask that is not packed to the left of the row (or is,
    with ``packed``); with ``empty_rows`` row 0 has no live slot (all kept
    slots beyond rc) and row 1 is all masked."""
    rng = np.random.default_rng(seed)
    rc = PARAMS.rc
    dirs = rng.normal(size=(n, k, 3))
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    rvec = dirs * (rng.uniform(0.2, 1.5, (n, k)) * rc)[..., None]
    sidx = rng.integers(0, nspecies, (n, k))
    mask = rng.random((n, k)) < 0.75
    if packed:
        mask = np.sort(mask, axis=1)[:, ::-1].copy()
    if empty_rows and n > 2:
        rvec[0] *= 1.6 * rc / np.linalg.norm(rvec[0], axis=-1, keepdims=True)
        mask[0] = True
        mask[1] = False
    rvec[~mask & (rng.random((n, k)) < 0.5)] = 0.0  # both padding values
    radii = np.array([1.0, 1.2, 0.9, 1.1][:nspecies])
    params = SoapParams(lmax=lmax, nmax=3, rc=rc)
    return params, (torch.as_tensor(rvec, dtype=dtype, device=device),
                    torch.as_tensor(sidx, device=device),
                    torch.as_tensor(mask, device=device),
                    torch.as_tensor(radii, dtype=dtype, device=device))


# (id, layout_batch keywords, dtypes): the cases that the live-slot
# compaction, the atoms per backward block and the forward's chunks meet
LAYOUTS = [
    ("N_not_multiple_of_atoms_per_block", dict(n=37, k=176), ("float64", "float32")),
    ("N_1", dict(n=1, k=176), ("float64", "float32")),
    ("K_1", dict(n=23, k=1), ("float64", "float32")),
    ("K_300", dict(n=5, k=300), ("float64", "float32")),
    ("K_700_two_forward_chunks", dict(n=3, k=700), ("float64", "float32")),
    ("rows_without_live_slots", dict(n=9, k=64, empty_rows=True), ("float64", "float32")),
    ("left_packed", dict(n=11, k=96, packed=True), ("float64", "float32")),
    ("S_4", dict(n=13, k=80, nspecies=4), ("float64", "float32")),
    ("lmax_7", dict(n=7, k=120, nspecies=2, lmax=7), ("float64",)),
]


@pytest.mark.parametrize("layout", LAYOUTS, ids=[c[0] for c in LAYOUTS])
def test_kernel_layouts_match_plain_on_card(cuda, layout):
    _, kw, dtypes = layout
    for dtype in dtypes:
        dt = getattr(torch, dtype)
        params, args = layout_batch(cuda, dt, seed=len(kw), **kw)
        N = args[0].shape[0]
        CH = sk.channels(args[3].shape[0], params)
        g = torch.Generator(device="cuda").manual_seed(1)
        crb = torch.randn((N, CH), generator=g, device=cuda, dtype=dt)
        cib = torch.randn((N, CH), generator=g, device=cuda, dtype=dt)
        cr, ci = sk.soap_coeff_fwd(*args, params)
        pr, pi = sk.soap_coeff_fwd_plain(*args, params)
        rb = sk.soap_coeff_bwd(*args, crb, cib, params)
        pb = sk.soap_coeff_bwd_plain(*args, crb, cib, params)
        torch.cuda.synchronize()
        # float32: reordered sums over K slots, relative to the largest value
        tol = 1e-10 if dt == torch.float64 else 1e-5
        for a, b in ((cr, pr), (ci, pi), (rb, pb)):
            scale = 1.0 if dt == torch.float64 else b.abs().max().item()
            assert (a - b).abs().max().item() <= tol * scale, dtype
        # dead slots get exactly zero gradient
        rvec, sidx, mask, radii = args
        live = mask & (rvec.norm(dim=-1) < params.rc)
        assert (rb[~live] == 0).all()


def test_kernel_gradient_matches_autograd_on_card(cuda):
    rvec, sidx, mask, radii = batch(cuda, torch.float64, seed=3)
    g = torch.Generator(device="cuda").manual_seed(0)
    CH = sk.channels(radii.shape[0], PARAMS)
    crb = torch.randn((rvec.shape[0], CH), generator=g, device=cuda, dtype=torch.float64)
    cib = torch.randn((rvec.shape[0], CH), generator=g, device=cuda, dtype=torch.float64)
    rv = rvec.clone().requires_grad_(True)
    cr, ci = sk.sesoap_coefficients_k(rv, sidx, mask, radii, PARAMS)
    (gk,) = torch.autograd.grad((cr * crb).sum() + (ci * cib).sum(), rv)
    rv = rvec.clone().requires_grad_(True)
    pr, pi = sk.soap_coeff_fwd_plain(rv, sidx, mask, radii, PARAMS)
    (gp,) = torch.autograd.grad((pr * crb).sum() + (pi * cib).sum(), rv)
    assert (gk - gp).abs().max().item() <= 1e-9 * gp.abs().max().item()


def test_wrappers_count_launches_and_check_inputs(cuda):
    args = batch(cuda, torch.float32)
    sk.soap_coeff_fwd.launches = 0
    sk.soap_coeff_bwd.launches = 0
    cr, ci = sk.soap_coeff_fwd(*args, PARAMS)
    sk.soap_coeff_bwd(*args, cr, ci, PARAMS)
    sk.soap_coeff_fwd_plain(*args, PARAMS)
    assert sk.soap_coeff_fwd.launches == 1 and sk.soap_coeff_bwd.launches == 1
    rvec, sidx, mask, radii = args
    with pytest.raises(ValueError, match="contiguous"):
        sk.soap_coeff_fwd(rvec.transpose(0, 1), sidx.T, mask.T, radii, PARAMS)
    with pytest.raises(TypeError):
        sk.soap_coeff_fwd(rvec.half(), sidx, mask, radii, PARAMS)
    with pytest.raises(ValueError):
        sk.soap_coeff_fwd(rvec, sidx.cpu(), mask, radii, PARAMS)
    with pytest.raises(ValueError):
        sk.soap_coeff_bwd(*args, cr[:, :-1].contiguous(), ci, PARAMS)
    # channels whose shared rows exceed a block: refused before launching,
    # on the first call of a shape and on the cached check of the next
    big = SoapParams(lmax=7, nmax=50, rc=4.0)
    r64 = rvec.double()
    wide = torch.ones(30, dtype=torch.float64, device=cuda)
    z = torch.zeros((r64.shape[0], sk.channels(30, big)), dtype=torch.float64,
                    device=cuda)
    for _ in range(2):
        with pytest.raises(ValueError, match="too large"):
            sk.soap_coeff_fwd(r64, sidx, mask, wide, big)
        with pytest.raises(ValueError, match="too many channels"):
            sk.soap_coeff_bwd(r64, sidx, mask, wide, z, z, big)
    assert sk.soap_coeff_fwd.launches == 1 and sk.soap_coeff_bwd.launches == 1


def test_float32_predict_on_card_matches_float64(cuda):
    from autoforce_tpu_torch.io.model_io import load_model
    from autoforce_tpu_torch.system import bulk_fcc

    s = bulk_fcc("Cu", 3.6).repeat((3, 3, 3))
    s.rattle(0.05, seed=1)
    out = {}
    for dev, dt in (("cuda", torch.float32), ("cpu", torch.float64)):
        model = load_model(MODEL, device=dev, dtype=dt)
        eng = model.engine
        cfg = eng.make_config(s)
        e, f, w, cov, beta = eng.predict(cfg, model.full_model_arrays(),
                                         np.ones(cfg.npad))
        out[dev] = (float(e), f.cpu().double().numpy()[: len(s)])
    n = len(s)
    assert abs(out["cuda"][0] - out["cpu"][0]) / n < 2e-4
    assert np.abs(out["cuda"][1] - out["cpu"][1]).mean() < 1e-2


def test_device_md_runs_through_the_kernels(cuda):
    from autoforce_tpu_torch import units
    from autoforce_tpu_torch.calculator.active import ActiveCalculator
    from autoforce_tpu_torch.md.device_md import DeviceMD
    from autoforce_tpu_torch.system import bulk_fcc, maxwell_boltzmann_velocities

    calc = ActiveCalculator(covariance=MODEL, calculator=None, skin=1.2,
                            logfile=None, pckl=None, tape=None)
    s = bulk_fcc("Cu", 3.6).repeat((4, 4, 4))
    s.rattle(0.05, seed=1)
    s.calc = calc
    maxwell_boltzmann_velocities(s, 300, seed=3)
    dyn = DeviceMD(s, calc, dt=2 * units.fs, chunk=20, check_beta=False,
                   thermostat="none")
    e0 = s.get_potential_energy() + s.get_kinetic_energy()
    sk.soap_coeff_fwd.launches = 0
    sk.soap_coeff_bwd.launches = 0
    dyn.run(60)
    e1 = s.get_potential_energy() + s.get_kinetic_energy()
    assert dyn.nsteps == 60
    assert sk.soap_coeff_fwd.launches >= 60 and sk.soap_coeff_bwd.launches >= 60
    assert np.isfinite(s.positions).all()
    assert abs(e1 - e0) / len(s) < 1e-3


@pytest.fixture
def learned(cuda):
    """A small model learned on the card from the LJ oracle: 72 atoms (not
    a multiple of the 16-atom padding), three learning steps, float64."""
    from autoforce_tpu_torch.calculator.active import ActiveCalculator
    from autoforce_tpu_torch.calculator.oracles import LennardJones
    from autoforce_tpu_torch.system import bulk_fcc

    calc = ActiveCalculator(
        covariance=None, calculator=LennardJones(epsilon=0.15, sigma=2.3, rc=4.0),
        logfile=None, pckl=None, tape=None,
        kernel_kw=dict(cutoff=4.0, lmax=3, nmax=3), ediff=0.005, fdiff=0.02,
        device=cuda, dtype=torch.float64)
    s = bulk_fcc("Cu", 3.6).repeat((3, 3, 2))
    for k in range(3):
        t = s.copy()
        t.rattle(0.1, seed=10 + k)
        calc.calculate(t)
    assert calc.model.m > 8 and calc.model.ndata >= 1
    return calc


def close(got, ref, tol):
    for g, r in zip(got, ref):
        scale = r.abs().max().item()
        assert (g.double() - r).abs().max().item() <= tol * max(scale, 1e-300)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_kernel_block_kernel_route_matches_plain(learned, dtype):
    eng, model = learned.engine, learned.model
    ma = model.full_model_arrays()
    cfg64 = model.data[-1].cfg
    # batch sizes that do not divide m: a partial last column chunk
    bs = 7 if model.m % 7 else 5
    sk.soap_coeff_fwd.launches = 0
    sk.soap_coeff_bwd.launches = 0
    cfg = cfg64._replace(positions=cfg64.positions.to(getattr(torch, dtype)),
                         cell=cfg64.cell.to(getattr(torch, dtype)))
    from autoforce_tpu_torch.engine import kernel_block_fn

    radii = eng.radii_table().to(getattr(torch, dtype))
    got = kernel_block_fn(cfg, ma, radii, eng.params, eng.exponent, batch_size=bs)
    # one forward launch for the record, one backward launch per chunk
    assert sk.soap_coeff_fwd.launches == 1
    assert sk.soap_coeff_bwd.launches == -(-model.m // bs)
    with db.plain_kernels():
        ref = kernel_block_fn(cfg64, ma, eng.radii_table(), eng.params,
                              eng.exponent, batch_size=bs)
    close(got, ref, 1e-10 if dtype == "float64" else 1e-4)


def test_kernel_cols_multi_kernel_route_matches_plain(learned):
    eng, model = learned.engine, learned.model
    ma = model.full_model_arrays()
    cfg = model.data[-1].cfg
    cfgs = [cfg, cfg._replace(positions=cfg.positions + 0.01)]
    args = (cfgs, ma.X_desc[:3], ma.X_num[:3].cpu().numpy(), ma.X_lone[:3])
    sk.soap_coeff_fwd.launches = 0
    sk.soap_coeff_bwd.launches = 0
    got = eng.kernel_cols_multi(*args)
    assert sk.soap_coeff_fwd.launches == 1 and sk.soap_coeff_bwd.launches == 1
    with db.plain_kernels():
        ref = eng.kernel_cols_multi(*args)
    close(got, ref, 1e-10)


def test_strain_gradient_float32_matches_float64_on_card(cuda):
    """The anisotropic dE/deps of the NPT and variable-cell FIRE steps:
    float32 through the kernels against float64 through the plain
    versions on the 1008-atom bench snapshot (tolerance justified beside
    driver_bench.STRESS_REL_TOL)."""
    from autoforce_tpu_torch.tools import soap_bench as sb

    err, scale, _ = db.stress_rel_err(db.serving_calc(), sb.bench_system())
    assert err <= db.STRESS_REL_TOL * scale, (err, scale)


def test_driver_chunks_never_wait_for_the_card(cuda):
    """One chunk of every structure driver under CUDA's sync debug mode
    (a host sync inside raises), with both kernels launched in it."""
    from autoforce_tpu_torch import units
    from autoforce_tpu_torch.md import device_md as dmd
    from autoforce_tpu_torch.md import device_npt as dnpt
    from autoforce_tpu_torch.opt import device_fire as dfire
    from autoforce_tpu_torch.system import bulk_fcc, maxwell_boltzmann_velocities

    def system():
        s = bulk_fcc("Cu", 3.6).repeat((4, 4, 4))
        s.rattle(0.05, seed=1)
        maxwell_boltzmann_velocities(s, 300, seed=3)
        return s

    fs = units.fs
    runs = (
        (dmd, "md_chunk", 5, lambda s, c: dmd.DeviceMD(
            s, c, 2 * fs, temperature_K=300, chunk=10, check_beta=False,
            thermostat="nhc").run(10)),
        (dnpt, "md_chunk_npt", 6, lambda s, c: dnpt.DeviceNPT(
            s, c, 2 * fs, temperature_K=300, pressure_GPa=120.0, chunk=10,
            check_beta=False, mask=(1, 1, 0)).run(10)),
        (dfire, "fire_chunk", 9, lambda s, c: dfire.DeviceFIRE(
            s, c, chunk=10, check_beta=False).run(fmax=1e-9, steps=10)),
        (dfire, "fire_cell_chunk", 11, lambda s, c: dfire.DeviceFIRE(
            s, c, chunk=10, check_beta=False, cell=True).run(fmax=1e-9,
                                                             steps=10)),
    )
    for module, name, ndone_at, run in runs:
        calc = db.serving_calc()
        s = system()
        s.calc = calc
        with db.chunk_probe(module, name, ndone_at) as rec:
            run(s, calc)
        assert rec["sync_checked"] and rec["steps"] == 10, (name, rec)
        assert rec["soap_coeff_fwd"] >= 10 and rec["soap_coeff_bwd"] >= 10


def test_neb_launches_each_kernel_once_per_band_evaluation(cuda):
    from autoforce_tpu_torch.opt import device_neb as dneb
    from autoforce_tpu_torch.opt.neb import interpolate_images

    calc = db.serving_calc()
    first, last = db.vacancy_hop(reps=(4, 4, 4))
    images = interpolate_images(first, last, 5)
    for im in images:
        im.calc = calc
    band = dneb.DeviceNEB(images, calc, k=0.1, climb=True, dt=0.05,
                          maxstep=0.1, chunk=8, check_beta=False)
    with db.chunk_probe(dneb, "neb_chunk", 9) as rec:
        band.run(fmax=1e-9, steps=20)
    evals = rec["steps"] + rec["calls"]
    assert band.nsteps == rec["steps"] == 20 and rec["sync_checked"]
    assert rec["soap_coeff_fwd"] == rec["soap_coeff_bwd"] == evals, rec


def test_neb_band_float32_matches_float64_per_image(cuda):
    """The interior images stacked as the band's chunks see them, float32
    through the kernels, against each image alone in float64 through the
    plain versions (tolerances justified beside driver_bench.BAND_F_TOL;
    the forces relative to the largest slot term, driver_bench.slot_scale)."""
    from autoforce_tpu_torch.opt import device_neb as dneb
    from autoforce_tpu_torch.opt.neb import interpolate_images

    calc = db.serving_calc()
    first, last = db.vacancy_hop(reps=(4, 4, 4))
    images = interpolate_images(first, last, 5)
    for im in images:
        im.calc = calc
    band = dneb.DeviceNEB(images, calc, k=0.1, climb=True, check_beta=False)
    de, e_scale, df, f_scale, _, rows = db.band_rel_err(band)
    assert rows[0].shape[0] == 3 * band._npad
    assert de <= db.BAND_E_TOL * e_scale, (de, e_scale)
    assert df <= db.BAND_F_TOL * f_scale, (df, f_scale)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_kernel_block_jacobian_route_on_card(learned, dtype):
    """The Jacobian route (one one-hot launch of the backward kernel)
    against the column route and against float64 through the plain
    versions; tolerances as the column route's test above."""
    eng, model = learned.engine, learned.model
    ma = model.full_model_arrays()
    cfg64 = model.data[-1].cfg
    dt = getattr(torch, dtype)
    cfg = cfg64._replace(positions=cfg64.positions.to(dt),
                         cell=cfg64.cell.to(dt))
    from autoforce_tpu_torch.engine import kernel_block_fn, kernel_block_jac_fn

    radii = eng.radii_table().to(dt)
    sk.soap_coeff_fwd.launches = 0
    sk.soap_coeff_bwd.launches = 0
    got = kernel_block_jac_fn(cfg, ma, radii, eng.params, eng.exponent, chunk=5)
    assert sk.soap_coeff_fwd.launches == 1 and sk.soap_coeff_bwd.launches == 1
    col = kernel_block_fn(cfg, ma, radii, eng.params, eng.exponent)
    with db.plain_kernels():
        ref = kernel_block_jac_fn(cfg64, ma, eng.radii_table(), eng.params,
                                  eng.exponent)
    tol = 1e-10 if dtype == "float64" else 1e-4
    close(got, ref, tol)
    close(got, [c.double() for c in col], tol)


def test_one_hot_launch_matches_plain_on_card(cuda):
    """Both kernels at the one-hot launch's shape (the rows repeated
    2 (nmax+1)(lmax+1)^2 times) against their plain versions."""
    from autoforce_tpu_torch.engine import coeff_jacobian

    args = batch(cuda, torch.float64, n=9, nspecies=3)
    sk.soap_coeff_bwd.launches = 0
    got = coeff_jacobian(*args, PARAMS)
    assert sk.soap_coeff_bwd.launches == 1
    Q = (PARAMS.nmax + 1) * (PARAMS.lmax + 1) ** 2
    assert got.shape == (2, Q) + tuple(args[0].shape)
    with db.plain_kernels():
        from autoforce_tpu_torch import engine as engine_mod

        ref = engine_mod.coeff_jacobian(*args, PARAMS)
    torch.cuda.synchronize()
    assert (got - ref).abs().max().item() <= 1e-10 * max(1.0, ref.abs().max().item())


def test_kernel_space_predict_on_card(cuda):
    """Chemical mixing, a pair term and a kernel expression: float32
    predict through the kernels against float64 through the plain
    versions (energies 1e-5, forces 1e-4 of their largest values)."""
    from autoforce_tpu_torch.calculator.active import ActiveCalculator
    from autoforce_tpu_torch.calculator.oracles import MixtureLennardJones
    from autoforce_tpu_torch.engine import Engine
    from autoforce_tpu_torch.kernelalgebra import from_state
    from autoforce_tpu_torch.pairkernels import PairTerm
    from autoforce_tpu_torch.regression.sgpr import SgprModel
    from autoforce_tpu_torch.system import bulk_fcc

    eng = Engine(params=SoapParams(lmax=2, nmax=2, rc=4.0), exponent=4,
                 species=[29, 47], chemical="rbf",
                 kernel=from_state("Exp(Mul(Const(-1.0), Mul(SqD(), Positive(0.5))))"),
                 pair_terms=(PairTerm(a=29, b=47, rc=4.0, lengthscale=0.5),),
                 device=cuda, dtype=torch.float64)
    eps = {(29, 29): 0.15, (29, 47): 0.12, (47, 47): 0.1}
    sig = {k: 2.3 for k in eps}
    calc = ActiveCalculator(covariance=SgprModel(eng),
                            calculator=MixtureLennardJones(eps, sig, rc=4.0),
                            logfile=None, pckl=None, tape=None, ediff=0.005,
                            fdiff=0.02)
    s = bulk_fcc("Cu", 3.6).repeat((2, 2, 2))
    s.numbers[::3] = 47
    for k in range(3):
        t = s.copy()
        t.rattle(0.1, seed=20 + k)
        calc.calculate(t)
    model = calc.model
    assert model.m > 4
    ma = model.full_model_arrays()
    cfg64 = eng.make_config(t)
    vs = np.ones(cfg64.npad)
    eng.dtype = torch.float32
    cfg32 = eng.make_config(t)
    e32, f32, *_ = eng.predict(cfg32, ma, vs)
    eng.dtype = torch.float64
    with db.plain_kernels():
        e64, f64, *_ = eng.predict(cfg64, ma, vs)
    assert abs(float(e32) - float(e64)) <= 1e-5 * max(abs(float(e64)), 1.0)
    assert (f32.double() - f64).abs().max().item() <= 1e-4 * f64.abs().max().item()


@pytest.fixture
def committee(cuda, tmp_path):
    """A Lennard-Jones Cu committee learned on the CPU in float64 (at least
    two experts), served on the card in float32 from its expert folders."""
    from autoforce_tpu_torch import units
    from autoforce_tpu_torch.calculator.bcm import BCMActiveCalculator
    from autoforce_tpu_torch.calculator.oracles import LennardJones
    from autoforce_tpu_torch.md import Langevin
    from autoforce_tpu_torch.system import bulk_fcc, maxwell_boltzmann_velocities

    pckl = str(tmp_path / "bcm.pckl")
    kernel = dict(cutoff=4.0, lmax=3, nmax=3)
    calc = BCMActiveCalculator(
        calculator=LennardJones(epsilon=0.15, sigma=2.3, rc=4.0), pckl=pckl,
        logfile=None, kernel_kw=kernel, ediff=0.002, ediff_tot=0.01,
        fdiff=0.02, noise_f=0.005, max_data=2, max_inducing=12, seed=5,
        device="cpu", dtype=torch.float64)
    s = bulk_fcc("Cu", 3.6).repeat((2, 2, 2))
    s.rattle(0.05, seed=0)
    s.calc = calc
    maxwell_boltzmann_velocities(s, 500, seed=1)
    dyn = Langevin(s, 2 * units.fs, 500, friction=0.02, seed=2)
    for _ in range(30):
        if len(calc.experts) >= 2:
            break
        dyn.run(5)
    assert len(calc.experts) >= 2
    served = BCMActiveCalculator(calculator=None, pckl=pckl, logfile=None,
                                 kernel_kw=kernel, dtype=torch.float32)
    big = bulk_fcc("Cu", 3.6).repeat((3, 3, 3))
    big.rattle(0.05, seed=4)
    return served, big


def test_committee_step_float32_matches_float64_plain(committee):
    """One committee evaluation on the card: one launch of each kernel for
    every expert at once, and float32 through the kernels within the
    bench.py:412 bars of the host committee in float64 through the plain
    versions.  The weights themselves move with float32 rounding: each is
    -log(c)/c of an expert's largest covloss, and on these small,
    ill-conditioned experts 1 - ||choli k||^2 cancels most of its digits."""
    from autoforce_tpu_torch.md import device_md as dmd
    from autoforce_tpu_torch.tools import bcm_bench as bb

    calc, s = committee
    calc.calculate(s)
    chain = dmd.new_chain(calc, s, False)
    cfg, eng = chain["cfg"], calc.engine
    assert chain["mean_e"] is not None and chain["ma"].X_desc.shape[0] >= 2
    db.reset_launches()
    dmd._sgpr_forces(cfg.positions, cfg, chain["ma"], chain["radii"],
                     chain["vs"], eng.params, eng.exponent, True,
                     chain["ks"], chain["mean_e"])
    torch.cuda.synchronize()
    assert db.launches() == {"soap_coeff_fwd": 1, "soap_coeff_bwd": 1}
    e_err, e_abs, f_err, f_mae, f_abs, w_dev, w_host = bb.committee_rel_err(
        calc, s)
    assert e_err / len(s) < 2e-4, e_err
    assert f_mae < 1e-2, f_mae
    for w in (w_dev, w_host):
        assert np.isfinite(w).all() and (w >= 0).all()
        assert abs(w.sum() - 1.0) < 1e-9


def test_neb_band_with_a_cell_per_image_on_card(cuda):
    """A vacancy hop whose last end point is stretched along x, a cell per
    image: one launch of each kernel per band evaluation, and the stacked
    float32 band against each image alone in float64 plain."""
    from autoforce_tpu_torch.opt import device_neb as dneb

    calc = db.serving_calc()
    first, last = db.vacancy_hop(reps=(4, 4, 4))
    images = db.strained_band(first, last, 5)
    assert images[-1].cell[0, 0] > images[0].cell[0, 0]
    for im in images:
        im.calc = calc
    band = dneb.DeviceNEB(images, calc, k=0.1, climb=True, dt=0.05,
                          maxstep=0.1, chunk=8, check_beta=False)
    with db.evaluation_probe(dneb, "band_forces") as ev:
        band.run(fmax=1e-9, steps=16)
    assert band.nsteps == 16 and ev["calls"] >= 16 and ev["off"] == 0, ev
    de, e_scale, df, f_scale, _, _ = db.band_rel_err(band)
    assert de <= db.BAND_E_TOL * e_scale, (de, e_scale)
    assert df <= db.BAND_F_TOL * f_scale, (df, f_scale)


def test_replica_ensemble_step_on_card(cuda):
    """Three walkers stacked as one configuration: one launch of each
    kernel per ensemble evaluation, and the stacked float32 rows within
    BAND_E_TOL / BAND_F_TOL of each walker alone in float64 plain."""
    from autoforce_tpu_torch import units
    from autoforce_tpu_torch.md import device_md as dmd
    from autoforce_tpu_torch.md.replica_md import ReplicaMD
    from autoforce_tpu_torch.system import bulk_fcc, maxwell_boltzmann_velocities
    from autoforce_tpu_torch.tools import ensemble_bench as eb

    calc = db.serving_calc()
    walkers = []
    for r in range(3):
        s = bulk_fcc("Cu", 3.6).repeat((4, 4, 4))
        s.rattle(0.05, seed=10 + r)
        maxwell_boltzmann_velocities(s, 300, seed=20 + r)
        walkers.append(s)
    dyn = ReplicaMD(walkers, calc, 2 * units.fs, temperature_K=300,
                    friction=0.02, chunk=10, check_beta=False)
    with db.evaluation_probe(dmd, "_sgpr_forces") as ev:
        dyn.run(20)
    assert dyn.nsteps == 20 and ev["calls"] >= 20 and ev["off"] == 0, ev
    de, e_scale, df, f_scale, _, rows = eb.replica_rel_err(dyn)
    assert rows[0].shape[0] == 3 * 256
    assert de <= db.BAND_E_TOL * e_scale, (de, e_scale)
    assert df <= db.BAND_F_TOL * f_scale, (df, f_scale)


def test_fused_meta_step_on_card(cuda, tmp_path, monkeypatch):
    """ActiveMeta fused into DeviceMD on a model learned on the card: one
    launch of each kernel per step, and the bias alone in float32 through
    the kernels against meta_covloss_fn in float64 plain
    (ensemble_bench.meta_rel_err's bounds)."""
    from autoforce_tpu_torch import units
    from autoforce_tpu_torch.calculator.active import ActiveCalculator
    from autoforce_tpu_torch.calculator.emt import EMT
    from autoforce_tpu_torch.calculator.meta import ActiveMeta
    from autoforce_tpu_torch.md import Langevin
    from autoforce_tpu_torch.md import device_md as dmd
    from autoforce_tpu_torch.system import bulk_fcc, maxwell_boltzmann_velocities
    from autoforce_tpu_torch.tools import ensemble_bench as eb

    monkeypatch.chdir(tmp_path)
    calc = ActiveCalculator(covariance=None, calculator=EMT(), logfile=None,
                            pckl=None, tape=None, kernel_kw=dict(
                                cutoff=4.5, lmax=3, nmax=3), ediff=0.02,
                            ediff_tot=0.05, fdiff=0.06, seed=0)
    s = bulk_fcc("Cu", 3.6).repeat((2, 2, 2))
    s.rattle(0.05, seed=0)
    s.calc = calc
    maxwell_boltzmann_velocities(s, 300, seed=1)
    Langevin(s, 2 * units.fs, 300, friction=0.01, seed=2).run(10)
    calc._calc = None
    calc.meta = ActiveMeta(scale=0.05)
    big = bulk_fcc("Cu", 3.6).repeat((3, 3, 3))
    big.rattle(0.05, seed=4)
    big.calc = calc
    maxwell_boltzmann_velocities(big, 300, seed=5)
    dyn = dmd.DeviceMD(big, calc, 2 * units.fs, temperature_K=300,
                       chunk=10, check_beta=False)
    assert dyn.meta_scale == 0.05
    with db.evaluation_probe(dmd, "_sgpr_forces") as ev:
        dyn.run(20)
    assert dyn.nsteps == 20 and ev["calls"] >= 20 and ev["off"] == 0, ev
    t = bulk_fcc("Cu", 3.6).repeat((3, 3, 3))
    t.rattle(0.15, seed=33)
    m = eb.meta_rel_err(calc, t, 0.05)
    assert m["beta_median"] >= 1e-3, m
    assert m["e_err"] <= m["e_tol"], m
    assert m["f_err"] <= eb.META_F_TOL * m["f_scale"], m


def test_sharded_predict_on_card_matches_unsharded(cuda):
    """Engine.predict under a 2x2 mesh of the card repeated against the
    same engine without it, both float32 through the kernels
    (tools/mesh_checks.py's MESH_*_TOL), and one launch of each kernel
    per data shard."""
    from autoforce_tpu_torch.io.model_io import load_model
    from autoforce_tpu_torch.parallel import make_mesh
    from autoforce_tpu_torch.system import bulk_fcc
    from autoforce_tpu_torch.tools import mesh_checks as mc

    s = bulk_fcc("Cu", 3.6).repeat((4, 4, 4))
    s.rattle(0.05, seed=1)
    model = load_model(MODEL, device="cuda", dtype=torch.float32)
    eng = model.engine
    cfg = eng.make_config(s)
    ma = model.full_model_arrays()
    mesh = make_mesh(2, 2, devices=["cuda:0"] * 4)
    errs = mc.predict_diff(eng, cfg, ma, np.ones(cfg.npad), mesh)
    assert not mc.within(errs), errs
    db.reset_launches()
    eng.mesh = mesh
    try:
        eng.predict(cfg, ma, np.ones(cfg.npad))
    finally:
        eng.mesh = None
    assert db.launches() == {"soap_coeff_fwd": 2, "soap_coeff_bwd": 2}


def test_sharded_md_chunk_on_card_never_waits(cuda):
    """A sharded DeviceMD chunk under CUDA's sync debug mode "error" (no
    host read inside it) launches each kernel twice per evaluation on a
    2x2 mesh, and its first evaluation matches the unsharded one."""
    from autoforce_tpu_torch import units
    from autoforce_tpu_torch.calculator.active import ActiveCalculator
    from autoforce_tpu_torch.md import device_md as dmd
    from autoforce_tpu_torch.parallel import make_mesh
    from autoforce_tpu_torch.system import bulk_fcc, maxwell_boltzmann_velocities
    from autoforce_tpu_torch.tools import mesh_checks as mc

    mesh = make_mesh(2, 2, devices=["cuda:0"] * 4)
    calc = ActiveCalculator(covariance=MODEL, calculator=None, skin=1.2,
                            logfile=None, pckl=None, tape=None, mesh=mesh)
    s = bulk_fcc("Cu", 3.6).repeat((4, 4, 4))
    s.rattle(0.05, seed=1)
    s.calc = calc
    maxwell_boltzmann_velocities(s, 300, seed=3)
    dyn = dmd.DeviceMD(s, calc, 2 * units.fs, temperature_K=300, chunk=20,
                       check_beta=False)
    with mc.evaluation_counter(2) as ev, \
            db.chunk_probe(dmd, "md_chunk", 5) as rec:
        dyn.run(40)
    assert rec["sync_checked"] and rec["steps"] == 40
    assert ev["calls"] >= 40 and ev["off"] == 0, ev
    plain = db.serving_calc()
    t = bulk_fcc("Cu", 3.6).repeat((4, 4, 4))
    t.rattle(0.05, seed=1)
    t.calc = plain
    t.get_potential_energy()
    chain = dmd.DeviceMD(t, plain, 2 * units.fs, temperature_K=300,
                         check_beta=False)._new_chain()
    errs = mc.eval_diff(chain, mesh, plain.engine)
    assert not mc.within(errs), errs


@pytest.mark.parametrize("thermostat", ["langevin", "nhc"])
def test_padded_mesh_md_on_card_matches_unsharded(cuda, thermostat):
    """A 3 x 1 mesh of the card repeated pads 256 rows to 258: DeviceMD
    (0.3 A skin, 900 K, one 20-step chunk with in-loop breaches) under it
    against the unsharded driver from the same state and noise, float32
    through the kernels: equal breach reads, forces within MESH_F_TOL of
    the largest slot term, positions within traj_bound
    (tools/mesh_checks.py)."""
    from autoforce_tpu_torch.parallel import make_mesh
    from autoforce_tpu_torch.system import bulk_fcc
    from autoforce_tpu_torch.tools import mesh_checks as mc

    def cu256():
        s = bulk_fcc("Cu", 3.6).repeat((4, 4, 4))
        s.rattle(0.05, seed=1)
        return s

    mesh = make_mesh(3, 1, devices=["cuda:0"] * 3)
    r = mc.padded_md(MODEL, mesh, thermostat, temperature_K=900.0,
                     system=cu256)
    assert r["rows"] == 256 and r["mesh_rows"] == 258, r
    assert r["steps"] == (20, 20) and r["chunks"][0] == r["chunks"][1], r
    assert r["breach_reads"][0] == r["breach_reads"][1] > 0, r
    assert not mc.within(dict(f=r["f"])), r
    assert r["dpos"] <= r["dpos_bound"], r
