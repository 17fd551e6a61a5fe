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

    calc = ActiveCalculator(covariance=MODEL, calculator=None, skin=1.2)
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
