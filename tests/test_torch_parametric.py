"""The Func algebra and the parametric pair potentials of the port against
the JAX package (CPU, float64): values and gradients of a composed Func,
the softplus parameters, Lennard-Jones and Coulomb terms served as a
calculator (energy, forces, stress), and the least-squares fit of a
trainable epsilon.

Tolerances: 1e-12 relative for Func values and gradients between the
packages (the same float64 arithmetic), 1e-10 for the calculators'
energies, forces and stresses; central differences to 1e-4 relative (the
JAX test's); the fitted parameter to 1e-6 relative (both minimize with
scipy from the same start, with gradients that agree to rounding).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autoforce_tpu.calculator.parametric import ParametricCalculator as JaxPC
from autoforce_tpu.calculator.parametric import get_coulomb_terms as jax_coulomb
from autoforce_tpu.calculator.parametric import get_lj_terms as jax_lj_terms
from autoforce_tpu.descriptor import func as jax_func
from autoforce_tpu.system import System as JaxSystem
from autoforce_tpu.system import bulk_fcc as jax_bulk_fcc
from autoforce_tpu_torch.calculator.oracles import (LennardJones,
                                                    MixtureLennardJones)
from autoforce_tpu_torch.calculator.parametric import (ParametricCalculator,
                                                       get_coulomb_terms,
                                                       get_lj_terms)
from autoforce_tpu_torch.descriptor import func
from autoforce_tpu_torch.system import System, bulk_fcc


def composed(m):
    return (m.Exp(-0.5 * m.I() ** 2) * m.CutFunc(3.0)
            + 0.3 * m.ParamedRepulsiveCore(2.0, eta=2, name="z")
            + m.Param(0.7, positive=False, name="a") * m.RepulsiveCore(3))


def test_func_algebra_matches_jax():
    d = np.array([0.5, 1.0, 2.9, 3.5])
    params = {"z": 0.4, "a": -1.2}
    v, g = composed(func).value_and_grad(torch.as_tensor(d), params)
    jv, jg = composed(jax_func).value_and_grad(jnp.asarray(d), params)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=1e-12)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-12)
    assert composed(func).params().keys() == {"z", "a"}
    # the first term alone against its closed form and central differences
    f = func.Exp(-0.5 * func.I() ** 2) * func.CutFunc(3.0)
    v, g = f.value_and_grad(torch.as_tensor(d))
    np.testing.assert_allclose(
        v.numpy(), np.exp(-0.5 * d**2) * np.where(d < 3, (1 - d / 3) ** 2, 0),
        rtol=1e-12)
    h = 1e-6
    fd = (f(torch.as_tensor(d + h)) - f(torch.as_tensor(d - h))).numpy() / (2 * h)
    np.testing.assert_allclose(g.numpy(), fd, atol=1e-5)


def test_param_positivity():
    p = func.Param(0.5, positive=True, name="x")
    params = p.params()
    np.testing.assert_allclose(params["x"], jax_func.Param(
        0.5, positive=True, name="x").params()["x"], rtol=1e-15)
    assert abs(float(p(torch.zeros(1), params)[0]) - 0.5) < 1e-12


def lj_pair(rc=6.0, trainable=False, eps=0.15):
    kw = dict(epsilon=eps, sigma=2.3, rc=rc, trainable=trainable)
    return (JaxPC(jax_lj_terms([(29, 29)], **kw), rc=rc),
            ParametricCalculator(get_lj_terms([(29, 29)], **kw), rc=rc,
                                 device="cpu"))


def assert_same(pr, jr):
    assert abs(pr["energy"] - jr["energy"]) <= 1e-10 * max(1, abs(jr["energy"]))
    np.testing.assert_allclose(pr["forces"], jr["forces"], rtol=0, atol=1e-10)
    np.testing.assert_allclose(pr["stress"], jr["stress"], rtol=0, atol=1e-10)


def test_lj_parametric_matches_jax_and_oracle():
    """Untrainable LJ terms: the JAX calculator's results, central
    differences, and the smoothly cut LJ oracle of the same form."""
    jpc, pc = lj_pair()
    js = jax_bulk_fcc("Cu", 3.6).repeat((2, 2, 2))
    js.rattle(0.05, seed=0)
    s = bulk_fcc("Cu", 3.6).repeat((2, 2, 2))
    s.set_positions(js.positions)
    res = pc.calculate(s)
    assert_same(res, jpc.calculate(js))
    ref = MixtureLennardJones({(29, 29): 0.15}, {(29, 29): 2.3},
                              rc=6.0).calculate(s)
    assert abs(res["energy"] - ref["energy"]) < 1e-10 * abs(ref["energy"])
    np.testing.assert_allclose(res["forces"], ref["forces"], rtol=0,
                               atol=1e-10)
    p = s.positions.copy()
    h = 1e-5
    for a, b in [(0, 1), (2, 2)]:
        e = []
        for sign in (1, -1):
            pp = p.copy()
            pp[a, b] += sign * h
            s.set_positions(pp)
            e.append(pc.calculate(s)["energy"])
        np.testing.assert_allclose(res["forces"][a, b], -(e[0] - e[1]) / (2 * h),
                                   rtol=1e-4, atol=1e-7)


def test_fit_recovers_epsilon():
    """Fitting the trainable LJ epsilon to the shifted-LJ oracle's data:
    the force error drops as in JAX, to the same fitted parameter."""
    rc = 5.0
    lj = LennardJones(epsilon=0.15, sigma=2.3, rc=rc)
    data, jdata = [], []
    for k in range(3):
        s = bulk_fcc("Cu", 3.6)
        s.rattle(0.06, seed=k)
        s.calc = lj
        data.append(s)
        js = jax_bulk_fcc("Cu", 3.6)
        js.set_positions(s.positions)
        from autoforce_tpu.calculator.oracles import LennardJones as JaxLJ

        js.calc = JaxLJ(epsilon=0.15, sigma=2.3, rc=rc)
        jdata.append(js)
    jpc, pc = lj_pair(rc=rc, trainable=True, eps=0.05)

    def f_mae():
        return np.mean([np.abs(pc.calculate(s)["forces"] - s.get_forces()).mean()
                        for s in data])

    before = f_mae()
    pc.fit(data, steps=100)
    after = f_mae()
    assert after < 0.5 * before, (before, after)
    jpc.fit(jdata, steps=100)
    (name,) = pc.param_values
    np.testing.assert_allclose(pc.param_values[name], jpc.param_values[name],
                               rtol=1e-6)


def test_coulomb_terms():
    terms = get_coulomb_terms({11: 1.0, 17: -1.0}, rc=6.0, trainable=False)
    assert len(terms) == 3  # (11,11), (11,17), (17,17)
    s = System(numbers=[11, 17], positions=[[0, 0, 0], [2.5, 0, 0]])
    res = ParametricCalculator(terms, rc=6.0, device="cpu").calculate(s)
    assert res["energy"] < 0  # opposite charges attract
    assert res["forces"][0, 0] > 0  # pulled toward each other
    js = JaxSystem(numbers=[11, 17], positions=[[0, 0, 0], [2.5, 0, 0]])
    jres = JaxPC(jax_coulomb({11: 1.0, 17: -1.0}, rc=6.0, trainable=False),
                 rc=6.0).calculate(js)
    assert abs(res["energy"] - jres["energy"]) < 1e-10
    np.testing.assert_allclose(res["forces"], jres["forces"], atol=1e-10)


def test_parametric_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        ParametricCalculator(get_lj_terms([(29, 29)]))
