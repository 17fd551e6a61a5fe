"""What decides ``correct``: the port's outputs at the end of the window
against the float64 reference at the same positions and cell.

Numbers compared (each against a limit of the cell's file):

- ``nbr_mismatch``: pairs closer than rc in one of the port's table (as
  the in-loop rebuild left it) and the reference's own pair search, and
  not in the other; exact, limit 0.
- ``desc_err``: largest |p_port - p_ref| over every component of every
  atom's normalized descriptor (the SOAP forward kernel's output).
- ``gram_err``: largest |K_port - K(p_port)| over the (atoms x inducing)
  Gram, K(p_port) being the kernel of the port's own descriptors
  computed here in float64: the Gram stage alone.
- ``energy_err``: |E_port - E_ref| / N (eV/atom).
- ``force_err``: largest |F_port - F_ref| component (eV/A): the step's
  single backward through both SOAP kernels and the Gram.
- ``moved_rms``: RMS displacement of the atoms over the window (A), which
  a step that returns its state unchanged leaves at 0; a lower limit.

The control (:func:`control_numbers`) is the reference put in the port's
place one precision lower than the configuration states: descriptors in
bfloat16 (stated float32), the Gram and the energy in float32 (stated
float64).
"""

from __future__ import annotations

import torch

from . import model as model_mod
from . import neighbors, soap


def blocks(model, pos, cell, numbers, pairs, leaf, block, desc_dtype=None,
           gram_dtype=None):
    """Yield (lo, hi, p, K, e) over row blocks of the configuration; each
    block's energy is backpropagated into ``leaf`` (positions) before it is
    yielded, so ``-leaf.grad`` is the force once the blocks are done."""
    i, j, n = pairs
    N = pos.shape[0]
    sidx = model.species_index(numbers)
    S = len(model.species)
    gram_dtype = gram_dtype or torch.float64
    mu = model.mu.to(gram_dtype)
    for lo in range(0, N, block):
        hi = min(N, lo + block)
        a = int(torch.searchsorted(i, lo))
        b = int(torch.searchsorted(i, hi))
        ib, jb, nb = i[a:b], j[a:b], n[a:b]
        slot, mask = model_mod.padded(ib - lo, hi - lo)
        nsx = torch.cat([sidx[jb], sidx.new_zeros(1)])[slot]
        with torch.enable_grad():
            rv = model_mod.env_rvec(leaf, cell, ib, jb, nb, slot)
            p = soap.descriptors(rv, nsx, mask, S, model.lmax, model.nmax,
                                 model.rc, dtype=desc_dtype)
            K = model_mod.gram(p, numbers[lo:hi], model.X, model.Xz,
                               model.zeta, dtype=gram_dtype)
            e = (K @ mu).sum()
            e.backward()
        yield lo, hi, p.detach(), K.detach(), e.detach()


def _leaf(pos):
    return pos.detach().to(torch.float64).clone().requires_grad_(True)


def port_numbers(model, out, block=8192):
    """The numbers compared for the port's end-of-window state ``out``:
    positions ``pos`` (N, 3), ``start`` (positions at the window's start),
    ``cell``, atomic ``numbers``, the table ``nbr_idx`` / ``nbr_off`` /
    ``nbr_mask`` (rows of the N atoms), descriptors ``p`` (N, D),
    Gram ``K`` (N, m), ``energy`` and ``forces`` (N, 3)."""
    pos = out["pos"].to(torch.float64)
    cell = out["cell"].to(torch.float64)
    numbers = out["numbers"]
    N = pos.shape[0]
    with torch.no_grad():
        pairs = neighbors.pairs(pos, cell, model.rc)
        mismatch = _table_mismatch(pos, cell, out, pairs, model.rc)
    leaf = _leaf(pos)
    desc_err = gram_err = 0.0
    energy = torch.zeros((), dtype=torch.float64, device=pos.device)
    for lo, hi, p, K, e in blocks(model, pos, cell, numbers, pairs, leaf, block):
        pp = out["p"][lo:hi]
        desc_err = max(desc_err, float((pp.to(torch.float64) - p).abs().max()))
        k64 = model_mod.gram(pp.to(torch.float64), numbers[lo:hi], model.X,
                             model.Xz, model.zeta)
        gram_err = max(gram_err, float((out["K"][lo:hi] - k64).abs().max()))
        energy += e
    forces = -leaf.grad
    dpos = pos - out["start"].to(torch.float64)
    return {
        "nbr_mismatch": mismatch,
        "desc_err": desc_err,
        "gram_err": gram_err,
        "energy_err": abs(float(out["energy"]) - float(energy)) / N,
        "force_err": float((out["forces"].to(torch.float64) - forces).abs().max()),
        "moved_rms": float(dpos.pow(2).sum(-1).mean().sqrt()),
    }


def control_numbers(model, pos, cell, numbers, block=8192,
                    desc_dtype=torch.bfloat16, gram_dtype=torch.float32):
    """The same numbers (but the table and the motion, which the control
    does not make) for the reference computed in ``desc_dtype`` /
    ``gram_dtype`` in the port's place, at ``pos``."""
    pos = pos.to(torch.float64)
    cell = cell.to(torch.float64)
    N = pos.shape[0]
    with torch.no_grad():
        pairs = neighbors.pairs(pos, cell, model.rc)
    ref_leaf, low_leaf = _leaf(pos), _leaf(pos)
    ref = blocks(model, pos, cell, numbers, pairs, ref_leaf, block)
    low = blocks(model, pos, cell, numbers, pairs, low_leaf, block,
                 desc_dtype, gram_dtype)
    desc_err = gram_err = 0.0
    e_ref = torch.zeros((), dtype=torch.float64, device=pos.device)
    e_low = torch.zeros((), dtype=torch.float64, device=pos.device)
    for (lo, hi, p, _, e), (_, _, pl, Kl, el) in zip(ref, low):
        desc_err = max(desc_err, float((pl.to(torch.float64) - p).abs().max()))
        k64 = model_mod.gram(pl.to(torch.float64), numbers[lo:hi], model.X,
                             model.Xz, model.zeta)
        gram_err = max(gram_err, float((Kl.to(torch.float64) - k64).abs().max()))
        e_ref += e
        e_low += el.to(torch.float64)
    return {
        "desc_err": desc_err,
        "gram_err": gram_err,
        "energy_err": abs(float(e_low) - float(e_ref)) / N,
        "force_err": float((low_leaf.grad - ref_leaf.grad).abs().max()),
    }


def _table_mismatch(pos, cell, out, pairs, rc, band=1e-9):
    """Pairs within rc (by more than ``band``) in one table and not the
    other, keyed by (i, j, image shift)."""
    N = pos.shape[0]
    idx = out["nbr_idx"].long()
    off = out["nbr_off"].long()
    mask = out["nbr_mask"].bool()
    pi, pk = torch.nonzero(mask, as_tuple=True)
    pj, pn = idx[pi, pk], off[pi, pk]
    d = torch.linalg.vector_norm(neighbors.displacement(pos, cell, pi, pj, pn), dim=-1)
    i, j, n = pairs
    dr = torch.linalg.vector_norm(neighbors.displacement(pos, cell, i, j, n), dim=-1)

    def keys(a, b, s, dist):
        inside = dist < rc - band
        edge = (dist - rc).abs() <= band
        k = ((a * N + b) * 256 + (s[:, 0] + 128)) * 256 + (s[:, 1] + 128)
        k = k * 256 + (s[:, 2] + 128)
        return k[inside], k[edge]

    kp, ep = keys(pi, pj, pn, d)
    kr, er = keys(i, j, n, dr)
    edge = torch.cat([ep, er])
    kp = kp[~torch.isin(kp, edge)]
    kr = kr[~torch.isin(kr, edge)]
    return int((~torch.isin(kp, kr)).sum() + (~torch.isin(kr, kp)).sum())


def decide(numbers, limits):
    """(correct, [(name, value, limit, "max" | "min")]) of every number
    that has a limit; a number with a limit but no value fails."""
    rows, ok = [], True
    for name, lim in limits.items():
        kind = "max" if "max" in lim else "min"
        bound = float(lim[kind])
        value = numbers.get(name)
        good = value is not None and (value <= bound if kind == "max" else value >= bound)
        ok = ok and good
        rows.append((name, value, bound, kind))
    return ok, rows
