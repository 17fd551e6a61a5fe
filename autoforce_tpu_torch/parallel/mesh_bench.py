"""Mesh-path wall time and collective accounting (port of
``autoforce_tpu/parallel/mesh_bench.py``).

Reports, on one workload:

  * the per-step wall time of ``md_chunk`` over a ('data', 'model') mesh
    (the JAX package's ``sharded_md_chunk``) against the single-device
    ``md_chunk``, and the largest position difference of the two
    trajectories after the same steps (the same Langevin noise);
  * the analytic bytes that cross between the mesh's devices per step
    (:func:`collective_bytes`).  On a mesh whose devices repeat one card
    these copies are no-ops; the numbers say what distinct cards would
    move.

Collectives per sharded MD step (see ``parallel/mesh.py``):
  - the whole positions to each data shard's device ('data' broadcast),
  - a data shard's descriptors to each device of its model row and their
    cotangents back,
  - the energy partials psum'd to the first device (8 B each),
  - the (N, 3) position cotangent psum'd back from every data shard —
    the forces, the big one,
  - with the trip armed: the covariance blocks gathered over 'model' and
    one scalar max over 'data'.

CPU wall times predict nothing on the card: run it where the numbers are
wanted.  CLI (on the card unless ``--device cpu``):

    python -m autoforce_tpu_torch.parallel.mesh_bench --n-data 2 \\
        --n-model 2 [--model baselines/bench_model.pckl] [--natoms 256] \\
        [--steps 50] [--check-beta] [--device cpu]
"""

from __future__ import annotations

import time

import numpy as np
import torch


def collective_bytes(natoms, dim, mcap, n_data, n_model, esize, check_beta):
    """Bytes crossing between the devices of a mesh per sharded MD step
    (one force evaluation), by collective, for ``natoms`` rows of
    descriptor width ``dim`` in ``esize``-byte floats against ``mcap``
    inducing columns (float64 model state)."""
    nb = -(-natoms // n_data)
    out = {
        "positions_to_data_shards": (n_data - 1) * natoms * 3 * esize,
        "descriptors_over_model": 2 * n_data * (n_model - 1) * nb * dim * esize,
        "psum_energy": n_data * n_model * 8,
        "psum_forces": (n_data - 1) * natoms * 3 * esize,
    }
    if check_beta:
        out["gather_cov"] = n_data * (n_model - 1) * nb * (mcap // n_model) * 8
        out["pmax_beta"] = n_data * 8
    return out


def synthetic_model(device, dtype, lmax=3, nmax=3, rc=4.5, m=16):
    """The JAX harness's model: ``m`` inducing environments of rattled fcc
    Cu cells, random weights, a ridge-regularised choli."""
    from ..descriptor.soap import SoapParams
    from ..engine import Engine
    from ..neighbors import displacements, neighbor_table
    from ..regression.sgpr import InducingEnv, SgprModel
    from ..system import bulk_fcc

    eng = Engine(params=SoapParams(lmax=lmax, nmax=nmax, rc=rc), exponent=4,
                 species=[29], device=device, dtype=dtype)
    model = SgprModel(eng)
    for seed in range(m):
        s = bulk_fcc("Cu", 3.6)
        s.rattle(0.1, seed=seed)
        t = neighbor_table(s.positions, s.cell, s.pbc, rc)
        r = displacements(s.positions, s.cell, t)
        i = seed % len(s)
        mask = t.mask[i]
        model.add_inducing(InducingEnv.from_arrays(
            s.numbers[i], r[i][mask], s.numbers[t.idx[i][mask]]),
            remake=False)
    rng = np.random.default_rng(0)
    model.mu = rng.normal(size=model.m) * 0.1
    model.choli = np.linalg.inv(
        np.linalg.cholesky(model.M + 1e-6 * np.eye(model.m)))
    model._model_arrays = None
    return model


def mesh_devices(device, count):
    """``count`` mesh slots on ``device``'s kind: every card in turn
    (``cuda:i % cards``), or the CPU repeated."""
    if torch.device(device).type == "cuda":
        cards = torch.cuda.device_count()
        return [f"cuda:{i % cards}" for i in range(count)]
    return ["cpu"] * count


def measure(model=None, system=None, n_data=2, n_model=2, steps=50,
            check_beta=False, device="cuda", dtype=None, natoms=256,
            devices=None):
    """Time ``steps`` Langevin MD steps of ``model`` (an SgprModel; the
    synthetic one by default) on ``system`` (fcc Cu of about ``natoms``
    atoms by default) through ``md_chunk`` on one device and on an
    ``n_data`` x ``n_model`` mesh, each after one warm-up chunk.  Returns
    a dict: ms per step of both, their positions' largest difference, the
    run's duration (ASE time units), lightest mass and the spacing of the
    positions' type at their largest value, the collective bytes per
    step."""
    from ..engine import device_fetch
    from ..md.device_md import md_chunk
    from ..system import bulk_fcc
    from .mesh import make_mesh, pad_chain

    dev = torch.device(device)
    if model is None:
        model = synthetic_model(dev, dtype)
    eng = model.engine
    if system is None:
        reps = max(1, round((natoms / 4) ** (1 / 3)))
        system = bulk_fcc("Cu", 3.6).repeat((reps, reps, reps))
        system.rattle(0.05, seed=7)
    cfg = eng.make_config(system)
    wd = cfg.positions.dtype
    npad, n = cfg.npad, len(system)
    rng = np.random.default_rng(0)

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=wd, device=dev)

    vel = np.zeros((npad, 3))
    vel[:n] = rng.normal(0, 0.005, (n, 3))
    masses = np.ones((npad, 1))
    masses[:n, 0] = system.get_masses()
    one = dict(cfg=cfg, ma=model.full_model_arrays(), vs=t(np.ones(npad)),
               vel=t(vel), masses=t(masses), pos0=cfg.positions, mean_e=None)
    mesh = make_mesh(n_data, n_model, devices=devices or mesh_devices(
        dev, n_data * n_model))
    sharded = dict(pad_chain(one, mesh), mesh=mesh)
    dt = 0.5
    args = (dt, 0.01, 0.02, 1e3, 1e9, steps)
    kw = dict(params=eng.params, exponent=eng.exponent,
              check_beta=check_beta, thermostat="langevin",
              ks=eng.kernel_space())

    def run(ch):
        return md_chunk(ch["cfg"], ch["ma"], eng.radii_table(), ch["vs"],
                        ch["vel"], ch["masses"], ch["pos0"], *args,
                        mesh=ch.get("mesh"), own_idx=ch.get("oidx"),
                        noise_rows=ch.get("noise_rows"), **kw)

    def timed(ch):
        run(ch)  # warm-up: first calls, allocator
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run(ch)
        (ndone,) = device_fetch(out[5].to(torch.int32))
        return 1e3 * (time.perf_counter() - t0) / int(ndone), out

    ms_single, r1 = timed(one)
    ms_sharded, r2 = timed(sharded)
    p1, p2 = device_fetch(r1[0], r2[0][:npad])
    return dict(
        natoms=n, m=int(model.m), mcap=int(one["ma"].mu.shape[0]),
        steps=steps, mesh=(n_data, n_model),
        devices=[str(d) for d in mesh.devices.ravel()],
        ms_per_step_single=ms_single, ms_per_step_sharded=ms_sharded,
        dpos_max=float(np.abs(p2 - p1).max()), duration=steps * dt,
        mass_min=float(masses[:n].min()),
        pos_ulp=float(np.spacing(np.abs(p1).max().astype(p1.dtype))),
        bytes_per_step=collective_bytes(
            sharded["cfg"].npad, eng.dim, int(sharded["ma"].mu.shape[0]),
            n_data, n_model, cfg.positions.element_size(), check_beta),
    )


def report(res):
    """Print ``measure``'s result in the JAX harness's layout."""
    nd, nm = res["mesh"]
    print(f"mesh_bench: devices={nd * nm} mesh=({nd}x{nm}) "
          f"natoms={res['natoms']} m={res['m']} steps={res['steps']} "
          f"on {res['devices'][0]}")
    print(f"  single-device: {res['ms_per_step_single']:8.3f} ms/step   "
          f"sharded: {res['ms_per_step_sharded']:8.3f} ms/step "
          f"(x{res['ms_per_step_sharded'] / res['ms_per_step_single']:.2f})")
    print(f"  trajectory |dpos|max vs single: {res['dpos_max']:.2e}")
    parts = " + ".join(f"{k} {v / 1024:.1f} KiB"
                       for k, v in res["bytes_per_step"].items())
    print(f"  per-step bytes between distinct devices: {parts}")


def main(argv=None):
    import argparse

    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--n-data", type=int, default=2)
    parser.add_argument("--n-model", type=int, default=2)
    parser.add_argument("--model", default=None,
                        help="a model folder (default: the synthetic model)")
    parser.add_argument("--natoms", type=int, default=256)
    parser.add_argument("--steps", type=int, default=50)
    parser.add_argument("--check-beta", action="store_true")
    parser.add_argument("--device", default="cuda")
    ns = parser.parse_args(argv)
    model = None
    if ns.model:
        from ..io.model_io import load_model

        model = load_model(ns.model, device=ns.device)
    report(measure(model=model, n_data=ns.n_data, n_model=ns.n_model,
                   steps=ns.steps, check_beta=ns.check_beta,
                   device=ns.device, natoms=ns.natoms))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
