"""On-device neighbor-table rebuild (minimum-image convention), plain torch
(port of ``autoforce_tpu/neighbors_device.py``).

Rebuilds the padded table on the device from the current device
positions, so device-resident MD (md/device_md.py) never leaves the card
for a skin breach.

Method: chunked brute-force MIC.  For each row block of B atoms, the
fractional pair deltas g = f_j - f_i give the image shift
``off = -rint(g)`` and displacement ``rvec = (g + off) @ cell``; pairs
with d <= cutoff are compacted left into the fixed K slots with a cumsum +
scatter (no sort).  Slots past ``kpad`` are scattered into one extra trash
column that is sliced off (torch has no drop mode for scatters).

Valid when every perpendicular cell width is >= 2 * cutoff and the system
is fully periodic; callers check :func:`device_rebuild_ok`.

Semantics match ``neighbors.neighbor_table`` row-wise as a SET: same
(j, off) pairs per atom (order may differ; every consumer is
order-invariant).
"""

from __future__ import annotations

import numpy as np
import torch


def device_rebuild_ok(cell, pbc, cutoff):
    """Host-side gate: MIC brute-force validity for this box."""
    pbc = np.asarray(pbc, dtype=bool)
    if not pbc.all():
        return False
    cell = np.asarray(cell, dtype=float)
    if abs(np.linalg.det(cell)) < 1e-12:
        return False
    inv = np.linalg.inv(cell)
    widths = 1.0 / np.linalg.norm(inv, axis=0)  # perpendicular widths
    return bool((widths >= 2.0 * cutoff).all())


def det3(m):
    """Determinant of (..., 3, 3) matrices as a triple product."""
    return (m[..., 0, :] * torch.linalg.cross(m[..., 1, :], m[..., 2, :])).sum(-1)


def inv3(m):
    """Inverse of (..., 3, 3) matrices by the adjugate.  Written out, like
    :func:`det3`, because ``torch.linalg`` checks for errors or factors on
    the host, which would make a device step wait for the card."""
    a, b, c = m[..., 0, :], m[..., 1, :], m[..., 2, :]
    adj = torch.stack([torch.linalg.cross(b, c), torch.linalg.cross(c, a),
                       torch.linalg.cross(a, b)], dim=-1)
    return adj / det3(m)[..., None, None]


def device_neighbor_table(positions, cell, atom_mask, cutoff, kpad, block=512,
                          row_ids=None, row_mask=None):
    """Rebuild the padded neighbor table on the device.

    Args:
        positions: (N, 3) current (possibly padded) positions, or (R, N, 3)
            for R independent systems under one cell (the walkers of a
            replica ensemble): each gets its own table, indices within it.
        cell: (3, 3) rows = lattice vectors.
        atom_mask: (N,) bool (or (R, N)); padded rows produce/receive no
            pairs.
        cutoff: scalar (rc + skin), float or 0-d tensor.
        kpad: neighbor-slot count of the existing table bucket.
        row_ids: optional (n,) int64 atom ids to build rows for (a mesh
            shard rebuilds its own rows; the candidates j still span all
            N positions).  Default: all N rows.  Not with (R, N, 3).
        row_mask: (n,) bool validity of the ``row_ids`` rows (default
            ``atom_mask[row_ids]``).
    Returns:
        (idx (N, kpad) i32, off (N, kpad, 3) i8, mask (N, kpad) bool,
         kmax (0-d i64 tensor), off_over (0-d bool tensor)), each table
        with the leading R axis when given one — the tables are complete
        only if kmax <= kpad and not off_over (an image offset beyond the
        int8 range).  Empty slots self-point at the row.  Nothing here
        synchronizes with the host.
    """
    batched = positions.dim() == 3
    if not batched:
        positions, atom_mask = positions[None], atom_mask[None]
    R, N = positions.shape[:2]
    dev = positions.device
    frac = positions @ inv3(cell)  # (R, N, 3), possibly unwrapped
    cut2 = cutoff**2  # a float or a 0-d tensor: no host-to-card copy
    rows = torch.arange(N, dtype=torch.int32, device=dev)
    if row_ids is None:
        own, fown, mown = rows, frac, atom_mask
    else:
        own = row_ids.to(torch.int32)
        fown = frac[:, row_ids]
        mown = (atom_mask[:, row_ids] if row_mask is None
                else row_mask[None])
    idx_out, off_out, msk_out, counts, overs = [], [], [], [], []
    for lo in range(0, own.shape[0], block):
        fi = fown[:, lo:lo + block]
        ri = own[lo:lo + block]
        mi = mown[:, lo:lo + block]
        B = fi.shape[1]
        g = frac[:, None, :, :] - fi[:, :, None, :]  # (R, B, N, 3) f_j - f_i
        off = -torch.round(g)  # round half to even, as rint
        rvec = (g + off) @ cell
        d2 = (rvec * rvec).sum(-1)  # (R, B, N)
        self_pair = (rows[None, :] == ri[:, None]) & (off == 0).all(-1)
        valid = ((d2 <= cut2) & ~self_pair & atom_mask[:, None, :]
                 & mi[:, :, None])
        slot = torch.cumsum(valid, dim=2) - 1  # (R, B, N)
        counts.append(valid.sum(dim=2))
        overs.append(((off.abs() > 127.0).any(-1) & valid).any())
        slot_c = torch.where(valid & (slot < kpad), slot,
                             torch.full_like(slot, kpad))
        j = rows.expand(R, B, N)
        idx_b = torch.zeros((R, B, kpad + 1), dtype=torch.int32, device=dev)
        idx_b.scatter_(2, slot_c, j)
        msk_b = torch.zeros((R, B, kpad + 1), dtype=torch.bool, device=dev)
        msk_b.scatter_(2, slot_c, valid)
        off_b = torch.zeros((R, B, kpad + 1, 3), dtype=torch.int8, device=dev)
        off_b.scatter_(2, slot_c[..., None].expand(R, B, N, 3),
                       off.clamp(-128, 127).to(torch.int8))
        idx_b = idx_b[:, :, :kpad]
        msk_b = msk_b[:, :, :kpad]
        off_b = off_b[:, :, :kpad]
        idx_out.append(torch.where(msk_b, idx_b, ri[:, None]))
        off_out.append(torch.where(msk_b[..., None], off_b,
                                   torch.zeros_like(off_b)))
        msk_out.append(msk_b)
    idx, off, mask = (torch.cat(t, dim=1) for t in (idx_out, off_out, msk_out))
    if not batched:
        idx, off, mask = idx[0], off[0], mask[0]
    return (idx, off, mask, torch.cat(counts, dim=1).max(),
            torch.stack(overs).any())


def reverse_slots(idx, off, mask):
    """Reverse-slot table: ``rev[i, k] = j * K + k'`` (flat) where slot
    ``(j, k')`` is the mirror of slot ``(i, k)`` — ``idx[j, k'] == i`` and
    ``off[j, k'] == -off[i, k]`` — and ``-1`` on masked or unmatched slots.

    The JAX package matches candidates by an O(N K^2) gather; here every
    valid slot's (row, neighbor, image) is encoded into one int64 key, the
    keys are sorted once and each slot's mirror key is binary-searched —
    O(N K log(N K)), the method of ``neighbors.reverse_slots_host`` on the
    device.  Offset matching keeps multiple periodic images of one pair
    distinct.  Preconditions: no duplicate (j, off) entries within a row
    (both builders emit each pair image once), |off| <= 127 (int8 tables)
    and N <= 2^19.
    """
    N, K = idx.shape
    if N > (1 << 19):
        raise ValueError("reverse_slots: more than 2^19 rows")
    dev = idx.device
    r = torch.arange(N, dtype=torch.int64, device=dev)[:, None].expand(N, K)
    j = idx.to(torch.int64)
    o = off.to(torch.int64)
    oc = ((o[..., 0] + 128) << 16) | ((o[..., 1] + 128) << 8) | (o[..., 2] + 128)
    moc = ((128 - o[..., 0]) << 16) | ((128 - o[..., 1]) << 8) | (128 - o[..., 2])
    key = ((r * N + j) << 24) | oc
    mirror = ((j * N + r) << 24) | moc
    # masked slots get a key no mirror can hit
    key = torch.where(mask, key, torch.full_like(key, -1)).reshape(-1)
    skey, order = torch.sort(key)
    pos = torch.searchsorted(skey, mirror.reshape(-1)).clamp(max=N * K - 1)
    hit = (skey[pos] == mirror.reshape(-1)) & mask.reshape(-1)
    rev = torch.where(hit, order[pos], torch.full_like(pos, -1))
    return rev.to(torch.int32).reshape(N, K)
