"""SOAP coefficients and descriptors of the PyTorch port against the JAX
package (CPU, float64): the plain versions of the two CUDA kernels, the
GEMM form, the autograd Function and the kernel wrappers' dispatch.  The
kernels themselves run only on a card (tests/test_torch_kernels_gpu.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autoforce_tpu.descriptor.pallas_soap import sesoap_coefficients_pl
from autoforce_tpu.descriptor.soap import SoapParams as JaxSoapParams
from autoforce_tpu.descriptor.soap import sesoap_coefficients as jax_coefficients
from autoforce_tpu.descriptor.soap import sesoap_descriptors as jax_descriptors
from autoforce_tpu_torch.descriptor import soap_kernels as sk
from autoforce_tpu_torch.descriptor.soap import (
    SoapParams,
    sesoap_coefficients,
    sesoap_descriptors,
)

JPARAMS = JaxSoapParams(lmax=3, nmax=3, rc=4.0)
PARAMS = SoapParams(lmax=3, nmax=3, rc=4.0)


def make_batch(n=8, k=16, nspecies=2, seed=0):
    """The inputs of tests/test_pallas_soap.py, as numpy arrays."""
    rng = np.random.default_rng(seed)
    rvec = rng.uniform(-1, 1, (n, k, 3)) * 2.2
    rvec += np.sign(rvec) * 0.4
    sidx = rng.integers(0, nspecies, (n, k))
    mask = rng.random((n, k)) < 0.8
    rvec[~mask] = 0.0  # padding convention
    radii = np.array([1.0, 1.2][:nspecies])
    return rvec, sidx, mask, radii


def as_jax(batch):
    return tuple(jnp.asarray(a) for a in batch)


def as_torch(batch):
    return tuple(torch.as_tensor(a) for a in batch)


@pytest.mark.parametrize("nspecies", [1, 2])
def test_plain_forward_matches_jax_and_pallas(nspecies):
    batch = make_batch(nspecies=nspecies, seed=nspecies)
    cR, cI = jax_coefficients(*as_jax(batch), JPARAMS)
    cr_pl, ci_pl = sesoap_coefficients_pl(*as_jax(batch), JPARAMS, interpret=True)
    cr, ci = sk.soap_coeff_fwd_plain(*as_torch(batch), PARAMS)
    n = batch[0].shape[0]
    for mine, gemm, pallas in ((cr, cR, cr_pl), (ci, cI, ci_pl)):
        np.testing.assert_allclose(mine.numpy(), np.asarray(gemm).reshape(n, -1),
                                   atol=1e-10)
        np.testing.assert_allclose(mine.numpy(), np.asarray(pallas), atol=1e-10)
    # the port's own GEMM form agrees as well
    gR, gI = sesoap_coefficients(*as_torch(batch), PARAMS)
    np.testing.assert_allclose(gR.reshape(n, -1).numpy(), cr.numpy(), atol=1e-10)
    np.testing.assert_allclose(gI.reshape(n, -1).numpy(), ci.numpy(), atol=1e-10)


def test_plain_forward_writes_zero_m_above_l():
    batch = make_batch(seed=4)
    cr, ci = sk.soap_coeff_fwd_plain(*as_torch(batch), PARAMS)
    L = PARAMS.lmax + 1
    upper = np.triu(np.ones((L, L), bool), 1)
    cr = cr.numpy().reshape(cr.shape[0], -1, L, L)
    ci = ci.numpy().reshape(ci.shape[0], -1, L, L)
    assert (cr[:, :, upper] == 0).all() and (ci[:, :, upper] == 0).all()
    assert np.abs(cr[:, :, ~upper]).max() > 0


@pytest.mark.parametrize("nspecies", [1, 2])
def test_descriptors_match_jax(nspecies):
    batch = make_batch(nspecies=nspecies, seed=10 + nspecies)
    pj = np.asarray(jax_descriptors(*as_jax(batch), JPARAMS))
    pk = sk.sesoap_descriptors_k(*as_torch(batch), PARAMS).numpy()
    pg = sesoap_descriptors(*as_torch(batch), PARAMS).numpy()
    assert pk.shape == (batch[0].shape[0], PARAMS.dim(nspecies))
    np.testing.assert_allclose(pk, pj, atol=1e-10)
    np.testing.assert_allclose(pg, pj, atol=1e-10)


def test_plain_backward_matches_autograd():
    batch = make_batch(seed=2)
    rvec, sidx, mask, radii = as_torch(batch)
    rng = np.random.default_rng(3)
    n = rvec.shape[0]
    CH = sk.channels(2, PARAMS)
    crb = torch.as_tensor(rng.normal(size=(n, CH)))
    cib = torch.as_tensor(rng.normal(size=(n, CH)))
    rbar = sk.soap_coeff_bwd_plain(rvec, sidx, mask, radii, crb, cib, PARAMS)
    rv = rvec.clone().requires_grad_(True)
    cr, ci = sk.soap_coeff_fwd_plain(rv, sidx, mask, radii, PARAMS)
    (g,) = torch.autograd.grad((cr * crb).sum() + (ci * cib).sum(), rv)
    np.testing.assert_allclose(rbar.numpy(), g.numpy(), rtol=1e-7, atol=1e-10)
    # padded slots get exactly zero gradient
    assert (rbar.numpy()[~batch[2]] == 0).all()


@pytest.mark.parametrize("nspecies", [1, 2])
def test_descriptor_gradient_matches_jax_grad(nspecies):
    batch = make_batch(nspecies=nspecies, seed=20 + nspecies)
    v = np.random.default_rng(5).normal(size=PARAMS.dim(nspecies))
    rvec_j, sidx_j, mask_j, radii_j = as_jax(batch)

    def loss(rv):
        return (jax_descriptors(rv, sidx_j, mask_j, radii_j, JPARAMS) * v).sum()

    gj = np.asarray(jax.grad(loss)(rvec_j))
    rvec, sidx, mask, radii = as_torch(batch)
    rv = rvec.clone().requires_grad_(True)
    p = sk.sesoap_descriptors_k(rv, sidx, mask, radii, PARAMS)
    (gt,) = torch.autograd.grad((p * torch.as_tensor(v)).sum(), rv)
    np.testing.assert_allclose(gt.numpy(), gj, rtol=1e-7, atol=1e-12)


def test_wrappers_dispatch_cpu_tensors_to_plain():
    batch = as_torch(make_batch(seed=6))
    sk.soap_coeff_fwd.launches = 0
    sk.soap_coeff_bwd.launches = 0
    cr, ci = sk.soap_coeff_fwd(*batch, PARAMS)
    pr, pi = sk.soap_coeff_fwd_plain(*batch, PARAMS)
    assert torch.equal(cr, pr) and torch.equal(ci, pi)
    rbar = sk.soap_coeff_bwd(*batch, cr, ci, PARAMS)
    assert torch.equal(rbar, sk.soap_coeff_bwd_plain(*batch, cr, ci, PARAMS))
    # the plain versions are no kernel launches
    assert sk.soap_coeff_fwd.launches == 0 and sk.soap_coeff_bwd.launches == 0


def test_wrapper_refuses_other_devices():
    rvec, sidx, mask, radii = (t.to("meta") for t in as_torch(make_batch()))
    with pytest.raises(ValueError, match="unsupported device"):
        sk.soap_coeff_fwd(rvec, sidx, mask, radii, PARAMS)


def test_channel_layout_matches_reshape():
    """(s, n, l, m) flattening: cR.reshape(N, S, nmax+1, L, L)."""
    batch = make_batch(seed=7)
    cr, _ = sk.soap_coeff_fwd_plain(*as_torch(batch), PARAMS)
    cR, _ = jax_coefficients(*as_jax(batch), JPARAMS)
    L = PARAMS.lmax + 1
    np.testing.assert_allclose(
        cr.numpy().reshape(cr.shape[0], 2, PARAMS.nmax + 1, L, L),
        np.asarray(cR), atol=1e-10,
    )


def dead_slot_batch(seed, n=6, k=20, nspecies=2):
    """Slots spread over 0.3-1.6 rc (one exactly at rc, of unit radius)
    under a random mask; masked slots keep their coordinates, many of them
    inside rc.  Returns the batch and the live slots (kept, d < rc)."""
    rng = np.random.default_rng(seed)
    rc = PARAMS.rc
    dirs = rng.normal(size=(n, k, 3))
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    rvec = dirs * (rng.uniform(0.3, 1.6, (n, k)) * rc)[..., None]
    sidx = rng.integers(0, nspecies, (n, k))
    rvec[0, 0] = [rc, 0.0, 0.0]
    sidx[0, 0] = 0
    mask = rng.random((n, k)) < 0.7
    mask[0, 0] = True
    radii = np.array([1.0, 1.2][:nspecies])
    live = mask & (np.linalg.norm(rvec, axis=-1) < rc)
    assert live.any() and (mask & ~live).any() and (~mask & ~live).any()
    return (rvec, sidx, mask, radii), live


def _coefficients(route, rvec, sidx, mask, radii):
    if route == "plain":
        cr, ci = sk.soap_coeff_fwd_plain(*as_torch((rvec, sidx, mask, radii)), PARAMS)
        return cr.numpy(), ci.numpy()
    cr, ci = sesoap_coefficients_pl(*as_jax((rvec, sidx, mask, radii)), JPARAMS,
                                    interpret=True)
    return np.asarray(cr), np.asarray(ci)


@pytest.mark.parametrize("route", ["plain", "pallas"])
def test_dead_slots_add_exactly_zero(route):
    """Masked slots and slots at d >= rc add exactly zero to cR and cI:
    alone they give zero, and dropping them changes no bit."""
    (rvec, sidx, mask, radii), live = dead_slot_batch(seed=30)
    for c in _coefficients(route, rvec, sidx, mask & ~live, radii):
        assert (c == 0).all()
    full = _coefficients(route, rvec, sidx, mask, radii)
    only_live = _coefficients(route, rvec, sidx, live, radii)
    for a, b in zip(full, only_live):
        np.testing.assert_array_equal(a, b)
    assert np.abs(full[0]).max() > 0


@pytest.mark.parametrize("route", ["plain", "autograd", "pallas"])
def test_dead_slots_get_exactly_zero_gradient(route):
    (rvec, sidx, mask, radii), live = dead_slot_batch(seed=31)
    rng = np.random.default_rng(32)
    CH = sk.channels(2, PARAMS)
    crb = rng.normal(size=(rvec.shape[0], CH))
    cib = rng.normal(size=(rvec.shape[0], CH))
    if route == "pallas":
        _, sidx_j, mask_j, radii_j = as_jax((rvec, sidx, mask, radii))

        def loss(rv):
            cr, ci = sesoap_coefficients_pl(rv, sidx_j, mask_j, radii_j, JPARAMS,
                                            interpret=True)
            return (cr * crb).sum() + (ci * cib).sum()

        g = np.asarray(jax.grad(loss)(jnp.asarray(rvec)))
    else:
        rv, st, mt, rt = as_torch((rvec, sidx, mask, radii))
        cbt, cit = torch.as_tensor(crb), torch.as_tensor(cib)
        if route == "plain":
            g = sk.soap_coeff_bwd_plain(rv, st, mt, rt, cbt, cit, PARAMS).numpy()
        else:
            rv = rv.clone().requires_grad_(True)
            cr, ci = sk.soap_coeff_fwd_plain(rv, st, mt, rt, PARAMS)
            (g,) = torch.autograd.grad((cr * cbt).sum() + (ci * cit).sum(), rv)
            g = g.numpy()
    assert (g[~live] == 0).all()
    assert (np.abs(g[live]).max(axis=-1) > 0).all()
