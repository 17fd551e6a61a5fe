"""``ActiveCalculator.include_folder`` on the port against the JAX package
(CPU, float64): a reference torch-pickle model folder, fabricated in the
reference's on-disk layout by the JAX package's own fixture writer
(tests/test_torch_interop.py), is read by the port's copy of
``io/torch_interop.py`` and replayed through the sampling loop.  The
extraction must be the same item for item, and the learned model the
same size with ``mu`` within 1e-8 (as tests/test_torch_active.py holds
learning runs)."""

import os

import numpy as np
import pytest
import torch

from autoforce_tpu.calculator.active import ActiveCalculator as JaxCalc
from autoforce_tpu.io.torch_interop import \
    read_reference_folder as jax_read_reference_folder
from autoforce_tpu_torch.calculator.active import ActiveCalculator
from autoforce_tpu_torch.io.torch_interop import (load_reference_folder,
                                                  read_reference_folder)

from test_torch_interop import RC, write_fixture_folder


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ref") / "refmodel.pckl")
    write_fixture_folder(path)
    return path


def test_read_reference_folder_matches_jax(folder):
    items, meta = read_reference_folder(folder)
    ref, ref_meta = jax_read_reference_folder(folder)
    assert meta == ref_meta
    assert [c for c, _ in items] == [c for c, _ in ref]
    for (cls, a), (_, b) in zip(items, ref):
        np.testing.assert_array_equal(a.numbers, b.numbers)
        if cls == "local":
            assert a.number == b.number
            np.testing.assert_array_equal(a.rvec, b.rvec)
        else:
            np.testing.assert_array_equal(a.positions, b.positions)
            np.testing.assert_array_equal(a.cell, b.cell)
            assert a.calc.results["energy"] == b.calc.results["energy"]
            np.testing.assert_array_equal(a.calc.results["forces"],
                                          b.calc.results["forces"])
    model = load_reference_folder(folder, kernel_kw=dict(device="cpu"))
    assert model.size == (2, 10)


@pytest.mark.parametrize("ndata", [None, 1])
def test_include_folder_matches_jax(folder, tmp_path, ndata):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # sum order: the decisions are threshold tests
    out = {}
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        for name, cls, extra in (
                ("jax", JaxCalc, {}),
                ("port", ActiveCalculator,
                 dict(device="cpu", dtype=torch.float64))):
            calc = cls(covariance=None, calculator=None, logfile=None,
                       pckl=None, tape=None,
                       kernel_kw=dict(cutoff=RC, lmax=3, nmax=3), **extra)
            calc.include_folder(folder, ndata=ndata)
            out[name] = (calc.size, np.asarray(calc.model.mu).copy())
    finally:
        os.chdir(cwd)
        torch.set_num_threads(threads)
    assert out["port"][0] == out["jax"][0]
    assert out["port"][0][0] >= 1 and out["port"][0][1] > 0
    np.testing.assert_allclose(out["port"][1], out["jax"][1], atol=1e-8)
