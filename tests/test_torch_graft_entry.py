"""The port's driver entries (``autoforce_tpu_torch.graft_entry``) against
the JAX package's root ``__graft_entry__.py`` (CPU, float64): the same
seeded 8-environment Cu model and crystal, the fused SGPR step of
``entry()`` on both, and ``dryrun_multichip`` over CPU meshes of three
(3 x 1: the data axis adds rows) and four (2 x 2) devices, which holds
every sharded path against one device with the reference's 1e-8 checks.

Tolerances: 1e-10 relative to each output's largest value for energy,
forces, virial and covariance (both packages sum the same float64 terms
in other orders); beta relative to its bound sqrt(vscale) = 1, as the
mesh tests hold it (``choli`` inverts a Cholesky factor with a 1e-6
ridge, which scales the packages' rounding of M by ~1e4)."""

import numpy as np
import pytest
import torch

import __graft_entry__ as jax_entry
from autoforce_tpu_torch import graft_entry

REL = 1e-10


@pytest.fixture(scope="module")
def steps():
    fn, args = jax_entry.entry()
    want = [np.asarray(x) for x in fn(*args)]
    tfn, targs = graft_entry.entry(device="cpu", dtype=torch.float64)
    got = [x.numpy() for x in tfn(*targs)]
    return got, want, targs


def test_build_state_matches_jax():
    jeng, jm, js, jcfg, jma, jvs = jax_entry._build_state()
    teng, tm, ts, tcfg, tma, tvs = graft_entry._build_state(
        device="cpu", dtype=torch.float64)
    np.testing.assert_array_equal(tm.mu, jm.mu)
    np.testing.assert_array_equal(ts.positions, js.positions)
    np.testing.assert_array_equal(tvs, jvs)
    assert tm.m == jm.m == 8 and tcfg.npad == jcfg.npad
    assert np.abs(tm.M - jm.M).max() <= REL * np.abs(jm.M).max()
    assert np.abs(tm.choli - jm.choli).max() <= 1e-8 * np.abs(jm.choli).max()


@pytest.mark.parametrize("k, name", list(enumerate(("energy", "forces",
                                                    "virial", "cov"))))
def test_entry_step_matches_jax(steps, k, name):
    got, want, _ = steps
    scale = np.abs(want[k]).max()
    assert np.abs(got[k] - want[k]).max() <= REL * scale, name


def test_entry_beta_matches_jax(steps):
    got, want, targs = steps
    live = np.asarray(targs[0].atom_mask)
    b, bw = got[4][live], want[4][live]
    assert np.isfinite(b).all() and np.abs(b - bw).max() <= REL
    assert (got[4][~live] == -np.inf).all()


def test_entry_defaults_to_the_card():
    import inspect

    for fn in (graft_entry.entry, graft_entry.dryrun_multichip,
               graft_entry._build_state):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    assert graft_entry.dryrun_devices(3, "cpu") == ["cpu"] * 3


@pytest.mark.parametrize("n, shape, padded", [(3, "3x1", True),
                                              (4, "2x2", False)])
def test_dryrun_multichip_on_a_cpu_mesh(n, shape, padded, capsys):
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        out = graft_entry.dryrun_multichip(n, device="cpu")
    finally:
        torch.set_num_threads(threads)
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith(f"multichip dryrun ok: mesh=({shape}) ")
    assert out["mesh"] == shape and out["devices"] == ["cpu"] * n
    assert (out["padded_rows"] > out["npad"]) == padded
    assert out["md_steps"] == out["nhc_steps"] == 4
    assert out["npt_steps"] == out["neb_steps"] == 3
    assert out["committee_md_steps"] == 4 and out["breached"]
    assert out["otf_mesh_size"][1] > 4
