"""The port's on-device neighbor tables (plain torch) against the host
builder and the JAX package's device builder (CPU)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autoforce_tpu.neighbors_device import device_neighbor_table as jax_device_table
from autoforce_tpu.neighbors_device import reverse_slots as jax_reverse_slots
from autoforce_tpu_torch.neighbors import neighbor_table, reverse_slots_host
from autoforce_tpu_torch import neighbors_device
from autoforce_tpu_torch.neighbors_device import (
    device_neighbor_table,
    device_rebuild_ok,
    reverse_slots,
)
from autoforce_tpu_torch.system import bulk_fcc
from neighbor_sets import rattled, row_sets


@pytest.mark.parametrize("shear,block", [(0.0, 512), (0.9, 16)])
def test_device_table_matches_host_table_as_sets(shear, block):
    s = rattled(shear=shear, seed=3)
    cut = 4.8
    assert device_rebuild_ok(s.cell, s.pbc, cut)
    host = neighbor_table(s.positions, s.cell, s.pbc, cut)
    n = len(s)
    count = int(host.mask.sum(1).max())
    npad, kpad = n + 5, count + 8
    pos = np.zeros((npad, 3))
    # unwrapped positions: image shifts must come out right
    pos[:n] = s.positions + s.cell[0] * (np.arange(n) % 3 == 0)[:, None]
    amask = np.arange(npad) < n
    idx, off, mask, kmax, over = device_neighbor_table(
        torch.as_tensor(pos), torch.as_tensor(s.cell), torch.as_tensor(amask),
        cut, kpad, block=block,
    )
    assert int(kmax) == count and not bool(over)
    assert idx.dtype == torch.int32 and off.dtype == torch.int8
    mine = row_sets(idx.numpy()[:n], off.numpy()[:n], mask.numpy()[:n])
    # the host table is built on wrapped positions: shift its offsets back
    shift = (np.arange(n) % 3 == 0).astype(int)
    ref_off = host.off.copy()
    ref_off[..., 0] += shift[:, None] - shift[host.idx]
    ref = row_sets(host.idx, ref_off, host.mask)
    assert mine == ref
    # padded rows hold nothing and empty slots self-point at their row
    assert not mask.numpy()[n:].any()
    empty = ~mask.numpy()
    rows = np.broadcast_to(np.arange(npad)[:, None], empty.shape)
    np.testing.assert_array_equal(idx.numpy()[empty], rows[empty])
    assert (off.numpy()[empty] == 0).all()


def test_device_table_matches_jax_device_table():
    s = rattled(seed=5)
    cut, kpad = 4.8, 64
    amask = np.ones(len(s), bool)
    ref = jax_device_table(jnp.asarray(s.positions), jnp.asarray(s.cell),
                           jnp.asarray(amask), cut, kpad)
    out = device_neighbor_table(torch.as_tensor(s.positions), torch.as_tensor(s.cell),
                                torch.as_tensor(amask), cut, kpad)
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_bucket_overflow_is_reported():
    s = rattled(seed=1)
    cut = 4.8
    host = neighbor_table(s.positions, s.cell, s.pbc, cut)
    count = int(host.mask.sum(1).max())
    kpad = count - 3
    idx, off, mask, kmax, over = device_neighbor_table(
        torch.as_tensor(s.positions), torch.as_tensor(s.cell),
        torch.ones(len(s), dtype=torch.bool), cut, kpad,
    )
    assert int(kmax) == count > kpad
    assert idx.shape == (len(s), kpad) and bool(mask.all(1).any())


def test_cpu_tensor_takes_the_plain_search(monkeypatch):
    monkeypatch.setattr(device_neighbor_table, "launches", 0)
    monkeypatch.setattr(neighbors_device, "_load", None)  # never reached
    s = rattled(seed=2)
    args = (torch.as_tensor(s.positions), torch.as_tensor(s.cell),
            torch.ones(len(s), dtype=torch.bool), 4.8, 64)
    out = device_neighbor_table(*args, block=32)
    ref = neighbors_device.device_neighbor_table_plain(*args, block=32)
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    assert device_neighbor_table.launches == 0


@pytest.mark.parametrize("seed", [0, 1])
def test_reverse_slots_match_host_and_jax(seed):
    s = rattled(seed=seed)
    t = neighbor_table(s.positions, s.cell, s.pbc, 4.8).pad_to(64)
    off8 = t.off.astype(np.int8)
    ref = reverse_slots_host(t.idx, off8, t.mask)
    rev = reverse_slots(torch.as_tensor(t.idx), torch.as_tensor(off8),
                        torch.as_tensor(t.mask))
    assert rev.dtype == torch.int32
    np.testing.assert_array_equal(rev.numpy(), ref)
    jrev = jax_reverse_slots(jnp.asarray(t.idx), jnp.asarray(off8), jnp.asarray(t.mask))
    np.testing.assert_array_equal(rev.numpy(), np.asarray(jrev))
    # every valid slot has a mirror, and mirroring twice is the identity
    flat = rev.numpy().reshape(-1)
    valid = t.mask.reshape(-1)
    assert (flat[valid] >= 0).all() and (flat[~valid] == -1).all()
    np.testing.assert_array_equal(flat[flat[valid]], np.nonzero(valid)[0])


def test_reverse_slots_keep_periodic_images_apart():
    # a thin cell: one pair of atoms meets through several images
    s = bulk_fcc("Cu", 3.6)
    t = neighbor_table(s.positions, s.cell, s.pbc, 4.0)
    off8 = t.off.astype(np.int8)
    rev = reverse_slots(torch.as_tensor(t.idx), torch.as_tensor(off8),
                        torch.as_tensor(t.mask))
    np.testing.assert_array_equal(rev.numpy(), reverse_slots_host(t.idx, off8, t.mask))


def test_rebuild_gate():
    s = rattled()
    assert device_rebuild_ok(s.cell, s.pbc, 5.0)
    assert not device_rebuild_ok(s.cell, s.pbc, 5.5)
    assert not device_rebuild_ok(s.cell, [True, True, False], 4.0)
