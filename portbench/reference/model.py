"""A configuration's frozen sparse-GP model, made from the seed.

The recipe of the repo's benchmark models (``bench.py``), with frames of
a Lennard-Jones MD in place of rattled copies: independent copies of the
configuration's sample cell, run by Langevin MD under its Lennard-Jones
mixture, give the frames; the inducing environments are every site of
the first frames, and the weights are fitted to the energies and forces
of the next ones (the last is held out), so that MD under the model stays
in the crystal.  The kernel is k(p, q) = delta(z_p, z_q) (p . q)^zeta on
normalized SeSoap descriptors; the weights solve the projected-process
least squares

    min_mu  |W (y - K_nm mu)|^2 + mu^T K_mm mu

by a QR factorization of [W K_nm; L^T] (K_mm + jitter = L L^T).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.autograd.forward_ad as fwad

from . import lattice, lj, neighbors, soap


@dataclass
class Model:
    species: list  # sorted atomic numbers: the species table
    lmax: int
    nmax: int
    rc: float
    zeta: int
    X: torch.Tensor  # (m, D) inducing descriptors, float64
    Xz: torch.Tensor  # (m,) central atomic numbers
    mu: torch.Tensor  # (m,)
    choli: torch.Tensor  # (m, m) inverse Cholesky factor of K_mm
    envs: list  # [(z, rvec (k, 3), neighbor numbers (k,))] on the host
    fit: dict  # force RMSE on the training and on held-out copies (eV/A)

    def species_index(self, numbers):
        table = torch.full((int(max(self.species)) + 1,), -1, dtype=torch.int64,
                           device=numbers.device)
        for s, z in enumerate(self.species):
            table[z] = s
        return table[numbers]


def generator(device, seed, stream):
    """An independent stream ``stream`` of the run's ``seed``."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 8 + int(stream)) % (1 << 63))
    return g


def padded(i, N):
    """(slot index into the pair list (N, K), mask (N, K)) of pairs sorted
    by i: row i holds its pairs left-aligned."""
    counts = torch.bincount(i, minlength=N)
    K = max(int(counts.max()) if N else 0, 1)
    start = torch.cumsum(counts, 0) - counts
    col = torch.arange(i.shape[0], device=i.device) - start[i]
    slot = torch.full((N, K), i.shape[0], dtype=torch.int64, device=i.device)
    slot[i, col] = torch.arange(i.shape[0], device=i.device)
    return slot, slot < i.shape[0]


def env_rvec(pos, cell, i, j, n, slot):
    """(N, K, 3) displacements of the padded table (zeros where masked)."""
    r = neighbors.displacement(pos, cell, i, j, n)
    r = torch.cat([r, r.new_zeros((1, 3))])
    return r[slot]


def gram(p, pz, X, Xz, zeta, dtype=None):
    dtype = dtype or p.dtype
    k = (p.to(dtype) @ X.to(dtype).T) ** zeta
    return k * (pz[:, None] == Xz[None, :]).to(dtype)


def _inducing(config, frames, numbers, cell, species):
    """Environment k is site k mod |cell| of frame k div |cell|."""
    m = int(config["m"])
    rc = float(config["rc"])
    M0 = frames.shape[1]
    dev = frames.device
    reach = [int(-(-rc // float(w))) for w in neighbors.widths(cell)]
    rng = [torch.arange(-k, k + 1, device=dev) for k in reach]
    shifts = torch.stack(torch.meshgrid(*rng, indexing="ij"), -1).reshape(-1, 3)
    k = torch.arange(m, device=dev)
    pos = frames[k // M0]  # (m, M0, 3)
    centre = k % M0
    img = (pos[:, None, :, :] + (shifts.to(pos.dtype) @ cell)[None, :, None, :])
    r = img.reshape(m, -1, 3) - pos[k, centre][:, None, :]
    jn = numbers.repeat(shifts.shape[0])
    zero = (shifts == 0).all(-1).repeat_interleave(M0)
    self_pair = zero[None, :] & (torch.arange(M0, device=dev).repeat(
        shifts.shape[0])[None, :] == centre[:, None])
    keep = (torch.linalg.vector_norm(r, dim=-1) < rc) & ~self_pair
    K = int(keep.sum(1).max())
    order = torch.argsort((~keep).to(torch.int8), dim=1, stable=True)[:, :K]
    rv = torch.gather(r, 1, order[..., None].expand(m, K, 3))
    mk = torch.gather(keep, 1, order)
    nz = jn[order]
    sx = torch.searchsorted(torch.tensor(species, device=dev), nz)
    X = soap.descriptors(rv, sx, mk, len(species), config["lmax"],
                         config["nmax"], rc)
    Xz = numbers[centre]
    envs = []
    rv_h, mk_h, nz_h, z_h = rv.cpu(), mk.cpu(), nz.cpu(), Xz.cpu()
    for q in range(m):
        envs.append((int(z_h[q]), rv_h[q][mk_h[q]].numpy(),
                     nz_h[q][mk_h[q]].numpy()))
    return X, Xz, envs


def _rows(frames, cell, pz, sidx, X, Xz, config, nspecies, chunk=16):
    """(energy rows (F, m), force rows (F, 3n, m)) of the kernel sums of
    ``frames`` (F, n, 3) of one cell, by forward-mode differentiation:
    each frame is repeated once per coordinate, that coordinate's unit
    vector its tangent.  Pair lists and tables are padded to the largest
    frame's."""
    rc = float(config["rc"])
    F, n, _ = frames.shape
    with torch.no_grad():
        tables = [neighbors.pairs(pos, cell, rc) for pos in frames]
    P = max(t[0].shape[0] for t in tables)
    K = max(int(torch.bincount(t[0], minlength=n).max()) for t in tables)
    dev = frames.device
    ii = torch.zeros((F, P), dtype=torch.int64, device=dev)
    jj = torch.zeros((F, P), dtype=torch.int64, device=dev)
    ss = torch.zeros((F, P, 3), dtype=frames.dtype, device=dev)
    slots = torch.full((F, n, K), P, dtype=torch.int64, device=dev)
    for f, (i, j, s) in enumerate(tables):
        ii[f, :i.shape[0]], jj[f, :i.shape[0]], ss[f, :i.shape[0]] = i, j, s
        slot, _ = padded(i, n)
        slots[f, :, :slot.shape[1]] = torch.where(slot == i.shape[0], P, slot)
    masks = slots < P
    nsx = torch.gather(torch.cat([sidx[jj], jj.new_zeros((F, 1))], 1), 1,
                       slots.reshape(F, -1)).reshape(F, n, K)
    T = 3 * n
    basis = torch.eye(T, dtype=frames.dtype, device=dev).reshape(T, n, 3)
    zeta = int(config["zeta"])
    e_rows, f_rows = [], []
    for lo in range(0, F, chunk):
        hi = min(F, lo + chunk)
        f = hi - lo
        with fwad.dual_level():
            p = fwad.make_dual(frames[lo:hi, None].expand(f, T, n, 3).contiguous(),
                               basis[None].expand(f, T, n, 3).contiguous())

            def at(idx):  # (f, P) -> (f, T, P, 3)
                return torch.gather(p, 2, idx[:, None, :, None].expand(f, T, P, 3))

            r = at(jj[lo:hi]) - at(ii[lo:hi]) + (ss[lo:hi] @ cell)[:, None]
            r = torch.cat([r, r.new_zeros((f, T, 1, 3))], 2)
            sl = slots[lo:hi].reshape(f, 1, n * K, 1).expand(f, T, n * K, 3)
            rv = torch.gather(r, 2, sl).reshape(f * T * n, K, 3)
            rep = (f, T, n, K)
            d = soap.descriptors(rv, nsx[lo:hi, None].expand(*rep).reshape(-1, K),
                                 masks[lo:hi, None].expand(*rep).reshape(-1, K),
                                 nspecies, config["lmax"], config["nmax"], rc)
            k = gram(d, pz.repeat(f * T), X, Xz, zeta)
            k = k.reshape(f, T, n, -1).sum(2)  # (f, T, m)
            primal, tangent = fwad.unpack_dual(k)
        e_rows.append(primal[:, 0])
        f_rows.append(-tangent)
    return torch.cat(e_rows), torch.cat(f_rows)


def build(config, seed, device):
    """The configuration's model for ``seed``, on ``device``."""
    if float(config["radii"]) != 1.0:
        raise ValueError("the reference's radial basis takes radii 1")
    species = sorted(int(z) for z in config["species"])
    unit, numbers, cell = lattice.sample_cell(config, device)
    sidx = torch.searchsorted(torch.tensor(species, device=device), numbers)
    gen = generator(device, seed, 0)
    M0 = unit.shape[0]
    n_ind = -(-int(config["m"]) // M0)
    data = config["data"]
    n_train = int(data["n"])
    md = config["sample_md"]
    rc = float(config["rc"])
    tabs = lj.tables(config["lj"], species, device)
    frames = lj.frames(unit, cell, sidx, lattice.masses(numbers), tabs, rc,
                       float(md["temperature_K"]), n_ind + n_train + 1,
                       int(md["steps"]), gen, dt=float(md["dt_fs"]),
                       friction=float(md["friction_per_fs"]))
    X, Xz, envs = _inducing(config, frames[:n_ind], numbers, cell, species)
    if X.shape[1] != int(config["D"]):
        raise ValueError(f"descriptor width {X.shape[1]}, file says {config['D']}")
    data_frames = frames[n_ind:]
    energy, forces = lj.energy_forces(data_frames, cell, sidx, tabs, rc,
                                      lj.image_shifts(cell, rc))
    # the last frame is held out
    ke_all, kf_all = _rows(data_frames, cell, numbers, sidx, X, Xz, config,
                           len(species))
    se = float(data["noise_e_per_atom"]) * M0
    sf = float(data["noise_f"])
    ke = ke_all[:-1]
    kf = kf_all[:-1].reshape(-1, kf_all.shape[2])
    A = torch.cat([ke / se, kf / sf])
    y = torch.cat([energy[:-1] / se, forces[:-1].reshape(-1) / sf])
    zeta = int(config["zeta"])
    Kmm = gram(X, Xz, X, Xz, zeta)
    m = Kmm.shape[0]
    eye = torch.eye(m, dtype=Kmm.dtype, device=device)
    L = torch.linalg.cholesky(Kmm + float(data["jitter"]) * eye)
    B = torch.cat([A, L.T])
    rhs = torch.cat([y, y.new_zeros(m)])
    Q, R = torch.linalg.qr(B)
    mu = torch.linalg.solve_triangular(R, (Q.T @ rhs)[:, None], upper=True)[:, 0]
    choli = torch.linalg.solve_triangular(L, eye, upper=False)
    f_train = kf @ mu - forces[:-1].reshape(-1)
    f_held = kf_all[-1] @ mu - forces[-1].reshape(-1)
    fit = {"force_rmse_train": float(f_train.pow(2).mean().sqrt()),
           "force_rmse_held": float(f_held.pow(2).mean().sqrt()),
           "force_rms_held": float(forces[-1].pow(2).mean().sqrt())}
    return Model(species, int(config["lmax"]), int(config["nmax"]),
                 float(config["rc"]), zeta, X, Xz, mu, choli, envs, fit)
