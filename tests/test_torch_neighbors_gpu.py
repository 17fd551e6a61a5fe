"""The cell-list kernels of the on-device neighbor table
(``csrc/cell_pairs.cu``) on a CUDA card, against the plain brute force
(``device_neighbor_table_plain``) on the same card: the same (j, off)
pairs per row, the counts and flags, empty slots, determinism, no host
sync, and the in-loop rebuild of ``DeviceMD`` going through the kernels.

Every test carries the ``gpu`` marker and skips where there is no card.
The module imports neither JAX nor the JAX package:

    python -m pytest tests/test_torch_neighbors_gpu.py -m gpu --noconftest -o addopts=""
"""

import os

import numpy as np
import pytest
import torch

from autoforce_tpu_torch import neighbors_device as nd
from neighbor_sets import rattled, row_sets, slot_keys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = os.path.join(ROOT, "baselines", "bench_model.pckl")
CUT = 4.7  # bins (2, 4, 4) on 3 x 6 x 6 cells of 3.6 A, (3, 4, 4) on 4 x 6 x 6

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def on(dev, *arrays, dtype=torch.float64):
    return [torch.as_tensor(a, device=dev,
                            dtype=dtype if np.asarray(a).dtype.kind == "f" else None)
            for a in arrays]


def case(name, dev):
    """(positions, cell, atom_mask, cutoff, kpad, keywords) of one case."""
    rng = np.random.default_rng(7)
    if name.startswith("cu_62k"):  # the benchmark cell's crystal
        s = rattled((25, 25, 25), stdev=0.05, seed=11)
        dt = torch.float32 if name.endswith("float32") else torch.float64
        pos, cell = on(dev, s.positions, s.cell, dtype=dt)
        return pos, cell, torch.ones(len(s), dtype=torch.bool, device=dev), 7.2, 200, {}
    reps = {"g2": (3, 6, 6), "g3": (4, 6, 6), "sheared": (4, 4, 5)}.get(name, (4, 5, 6))
    s = rattled(reps, seed=3, shear=0.9 if name == "sheared" else 0.0)
    n = len(s)
    pos, amask, kw = s.positions, np.ones(n, bool), {}
    if name == "unwrapped":  # several box vectors away
        pos = pos + rng.integers(-3, 4, (n, 3)) @ s.cell
    elif name == "padded":
        pos = np.concatenate([pos, np.zeros((7, 3))])
        amask = np.arange(n + 7) < n
        amask[5] = False
    elif name == "batched":
        pos = np.stack([rattled(reps, seed=k).positions for k in range(3)])
        amask = np.ones((3, n), bool)
        amask[1, -4:] = False
    elif name == "row_ids":
        rows = np.r_[np.arange(0, n, 3), [n - 1, 2]]
        rmask = np.ones(len(rows), bool)
        rmask[4] = False
        kw = dict(row_ids=torch.as_tensor(rows, device=dev),
                  row_mask=torch.as_tensor(rmask, device=dev))
    pos, cell, amask = on(dev, pos, s.cell, amask)
    return pos, cell, amask, CUT, 80, kw


def host_rows(table):
    """(idx, off, mask) of a table as numpy, replicas' rows one after
    another."""
    idx, off, mask = table[:3]
    K = idx.shape[-1]
    return (idx.reshape(-1, K).cpu().numpy(), off.reshape(-1, K, 3).cpu().numpy(),
            mask.reshape(-1, K).cpu().numpy())


def near_cutoff(keys, positions, cell, cut, rows):
    """Whether every (row, j, off) key lies within float32 rounding of
    the cutoff, measured in float64."""
    code = keys & ((1 << 24) - 1)
    o = torch.stack([(code >> 16) & 255, (code >> 8) & 255, code & 255], -1) - 128
    rj = keys >> 24
    i, j = rows[rj >> 20], rj & ((1 << 20) - 1)
    p, c = positions.to(torch.float64), cell.to(torch.float64)
    d2 = (p[j] - p[i] + o.to(torch.float64) @ c).pow(2).sum(-1)
    return bool(((d2 - cut**2).abs() <= 1e-5 * cut**2).all())


@pytest.mark.parametrize("name", ["cu_62k-float32", "cu_62k-float64", "g2", "g3",
                                  "sheared", "unwrapped", "padded", "batched",
                                  "row_ids"])
def test_kernel_table_matches_plain_on_card(cuda, name):
    pos, cell, amask, cut, kpad, kw = case(name, cuda)
    nd.device_neighbor_table.launches = 0
    out = nd.device_neighbor_table(pos, cell, amask, cut, kpad, **kw)
    ref = nd.device_neighbor_table_plain(pos, cell, amask, cut, kpad, **kw)
    torch.cuda.synchronize()
    assert nd.device_neighbor_table.launches == 3
    for a, b in zip(out, ref):
        assert a.shape == b.shape and a.dtype == b.dtype and a.device == b.device
    idx, off, mask, kmax, over = out
    assert int(kmax) <= kpad and not bool(over)
    # empty slots point at their own row with off 0
    ids = kw.get("row_ids", torch.arange(pos.shape[-2], device=cuda)).to(idx.dtype)
    assert torch.equal(idx[~mask], ids[:, None].expand_as(mask)[~mask])
    assert not off[~mask].any()
    if name.startswith("cu_62k"):
        mine, theirs = slot_keys(idx, off, mask), slot_keys(*ref[:3])
        if name.endswith("float64"):
            assert torch.equal(mine, theirs) and int(kmax) == int(ref[3])
        else:  # the arithmetic may round pairs at the cutoff otherwise
            rows = torch.arange(pos.shape[0], device=cuda)
            diff = torch.cat([mine[~torch.isin(mine, theirs)],
                              theirs[~torch.isin(theirs, mine)]])
            assert diff.numel() <= 4 and near_cutoff(diff, pos, cell, cut, rows)
            assert abs(int(kmax) - int(ref[3])) <= diff.numel()
        return
    assert int(kmax) == int(ref[3])
    assert row_sets(*host_rows(out)) == row_sets(*host_rows(ref))


def test_overflows_are_reported_on_card(cuda):
    pos, cell, amask, cut, kpad, _ = case("unwrapped", cuda)
    full = nd.device_neighbor_table(pos, cell, amask, cut, kpad)
    count = int(full[3])
    short = nd.device_neighbor_table(pos, cell, amask, cut, count - 5)
    assert int(short[3]) == count > count - 5 and not bool(short[4])
    # the written slots are pairs of the full table, as many as fit
    have = row_sets(*host_rows(short))
    want = row_sets(*host_rows(full))
    assert all(h <= w and len(h) == min(len(w), count - 5)
               for h, w in zip(have, want))
    far = pos.clone()
    far[7] += 200 * cell[0]  # an image offset beyond int8
    out = nd.device_neighbor_table(far, cell, amask, cut, kpad)
    ref = nd.device_neighbor_table_plain(far, cell, amask, cut, kpad)
    assert bool(out[4]) and bool(ref[4])


def test_kernel_table_is_deterministic(cuda):
    pos, cell, amask, cut, kpad, _ = case("cu_62k-float32", cuda)
    a = nd.device_neighbor_table(pos, cell, amask, cut, kpad)
    b = nd.device_neighbor_table(pos, cell, amask, cut, kpad)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_kernel_table_never_waits_for_the_host(cuda):
    pos, cell, amask, cut, kpad, _ = case("sheared", cuda)
    cut_t = torch.tensor(cut, dtype=torch.float64, device=cuda)
    nd.device_neighbor_table(pos, cell, amask, cut, kpad)  # build and load
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        nd.device_neighbor_table(pos, cell, amask, cut, kpad)
        nd.device_neighbor_table(pos, cell, amask, cut_t, kpad)
    finally:
        torch.cuda.set_sync_debug_mode(0)


def test_device_md_rebuilds_through_the_kernels(cuda):
    from autoforce_tpu_torch import units
    from autoforce_tpu_torch.calculator.active import ActiveCalculator
    from autoforce_tpu_torch.md.device_md import DeviceMD
    from autoforce_tpu_torch.system import bulk_fcc, maxwell_boltzmann_velocities

    calc = ActiveCalculator(covariance=MODEL, calculator=None, skin=1.2,
                            logfile=None, pckl=None, tape=None)
    s = bulk_fcc("Cu", 3.6).repeat((5, 5, 5))  # 18 A: two bins a side
    s.rattle(0.05, seed=1)
    s.calc = calc
    maxwell_boltzmann_velocities(s, 300, seed=3)
    dyn = DeviceMD(s, calc, dt=2 * units.fs, chunk=20, check_beta=False,
                   thermostat="none")
    assert dyn.in_loop_rebuild
    nd.device_neighbor_table.launches = 0
    dyn.run(40)
    assert dyn.nsteps == 40
    assert nd.device_neighbor_table.launches >= 6  # a rebuild per chunk start
    assert np.isfinite(s.positions).all()
