"""The plain reference against the port's plain path on the CPU, at small
sizes, for one and four species: descriptors, energy, forces and the
neighbor sets of both of the port's table builders."""

import numpy as np
import pytest
import torch

from portbench.reference import judge, neighbors
from portbench.reference import model as ref_model

from ._fixtures import CPU, crystal, load, port_model

CASES = {"cu_tiny": (4, 4, 4), "lgps4_tiny": (2, 2, 2)}


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    torch.set_num_threads(1)
    config = load(request.param)
    model = ref_model.build(config, 3, CPU)
    eng, sgpr = port_model(config, model)
    return config, CASES[request.param], model, eng, sgpr


def _system(config, reps, seed=5, rattle=0.1):
    from autoforce_tpu_torch.system import System

    pos, numbers, cell = crystal(config, reps, seed, rattle)
    return pos, numbers, cell, System(numbers=numbers.numpy(),
                                      positions=pos.numpy(),
                                      cell=cell.numpy(), pbc=True)


def _keys(i, j, n):
    n = torch.as_tensor(n, dtype=torch.int64)
    return set(zip(torch.as_tensor(i).tolist(), torch.as_tensor(j).tolist(),
                   map(tuple, n.tolist())))


def test_inducing_descriptors_match_port(case):
    _, _, model, eng, sgpr = case
    port = np.stack([x.desc for x in sgpr.X])
    np.testing.assert_allclose(port, model.X.numpy(), rtol=0, atol=1e-12)


def test_energy_forces_match_port(case):
    config, reps, model, eng, sgpr = case
    pos, numbers, cell, system = _system(config, reps)
    cfg = eng.make_config(system)
    ma = sgpr.full_model_arrays()
    vs = sgpr.vscale_for(cfg.numbers.numpy())
    e, f, _, _, _ = eng.predict(cfg, ma, vs)
    pairs = neighbors.pairs(pos, cell, model.rc)
    leaf = pos.clone().requires_grad_(True)
    E = sum(float(b[4]) for b in judge.blocks(model, pos, cell, numbers, pairs,
                                             leaf, 100))
    F = -leaf.grad
    n = len(system)
    # float64 both sides: the energy sums terms ~1e2 times |E| (large
    # weights of both signs), so rounding reaches ~1e-10 of |E|
    assert abs(float(e) - E) <= 1e-8 * max(1.0, abs(E))
    np.testing.assert_allclose(f[:n].numpy(), F.numpy(), rtol=0,
                               atol=1e-8 * float(F.abs().max()))


def test_neighbor_set_matches_port_host_table(case):
    from autoforce_tpu_torch.neighbors import neighbor_table

    config, reps, model, _, _ = case
    pos, _, cell, system = _system(config, reps)
    t = neighbor_table(system.positions, system.cell, system.pbc, model.rc)
    pi, pk = np.nonzero(t.mask)
    port = _keys(pi, t.idx[pi, pk], t.off[pi, pk])
    ref = _keys(*neighbors.pairs(pos, cell, model.rc))
    assert port == ref and len(ref) > 0


def test_neighbor_set_matches_port_rebuilt_table(case):
    """The in-loop builder of the port's device MD, on positions moved
    from the crystal by up to half an Angstrom."""
    from autoforce_tpu_torch.neighbors_device import device_neighbor_table

    config, reps, model, _, _ = case
    pos, _, cell, _ = _system(config, reps, seed=9, rattle=0.25)
    n = pos.shape[0]
    idx, off, mask, kmax, over = device_neighbor_table(
        pos, cell, torch.ones(n, dtype=torch.bool), model.rc, 160)
    assert int(kmax) <= 160 and not bool(over)
    pi, pk = torch.nonzero(mask, as_tuple=True)
    port = _keys(pi, idx[pi, pk], off[pi, pk])
    ref = _keys(*neighbors.pairs(pos, cell, model.rc))
    assert port == ref


def test_binned_search_matches_image_search():
    """The two search paths of the reference agree on a box wide enough
    for both."""
    config = load("cu_tiny")
    pos, _, cell = crystal(config, (6, 6, 6), 4, 0.2)
    a = _keys(*neighbors.pairs(pos, cell, 4.0))
    b = _keys(*neighbors._images(pos, cell, 4.0))
    assert a == b


def test_port_numbers_of_an_exact_state_are_small(case):
    """The judge fed the port's own float64 plain outputs: every number at
    rounding."""
    config, reps, model, eng, sgpr = case
    pos, numbers, cell, system = _system(config, reps)
    cfg = eng.make_config(system, kpad=None)
    ma = sgpr.full_model_arrays()
    vs = sgpr.vscale_for(cfg.numbers.numpy())
    e, f, _, cov, _ = eng.predict(cfg, ma, vs)
    p, _ = eng.descriptors(cfg)
    n, m = len(system), model.X.shape[0]
    state = {"pos": pos, "start": pos - 0.1, "cell": cell, "numbers": numbers,
             "nbr_idx": cfg.nbr_idx[:n], "nbr_off": cfg.nbr_off[:n],
             "nbr_mask": cfg.nbr_mask[:n], "p": p[:n], "K": cov[:n, :m],
             "energy": e, "forces": f[:n]}
    nums = judge.port_numbers(model, state, block=100)
    assert nums["nbr_mismatch"] == 0
    assert nums["desc_err"] < 1e-12 and nums["gram_err"] < 1e-12
    assert nums["energy_err"] < 1e-10 and nums["force_err"] < 1e-8
