"""An ensemble of device-resident MD walkers on one card (port of
``autoforce_tpu/md/replica_md.py``).

R replicas (ensemble MD, beads, walkers of ensemble learning) share one
SGPR model and step in lockstep.  The JAX package ``vmap``s its MD chunk
over them; here the walkers are stacked as rows of one configuration
(``md.device_md.stack_images`` with their shared cell), so each ensemble
step is one launch of each SOAP kernel, one Gram product and one backward
for all walkers (:func:`..md.device_md.md_chunk` with ``nrep``).  A skin
breach of any walker is served inside the chunk by rebuilding every
walker's table on the card; the chunk ends early at an uncertainty trip of
any walker, or when a rebuild fails (the neighbor bucket overflowed: the
host then rebuilds the tables with a larger bucket).

Active learning: at a trip the most uncertain walker gets the full
ActiveCalculator semantics on the host (predict, sample, solve) and the
updated model serves the whole ensemble, which samples configuration
space faster than one walker.

Walker r's Langevin noise is the stream ``seed + r`` of
:func:`..md.device_md._noise`: with the same model it reproduces
``DeviceMD(seed=seed + r)``.  The ensemble runs on the engine's device;
an ``engine.mesh`` is ignored here, as in the JAX package (a mesh shards
the atoms of one system, ``parallel/mesh.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import units
from ..engine import device_fetch
from ..neighbors import neighbor_table, round_up
from .device_md import (VS_UNSEEN, _graft, check_plain_surface, md_chunk,
                        stack_images)


class ReplicaMD:
    """Drive R systems with one shared (Active)Calculator.

    Args:
        systems: System list with one atom count, species layout, cell and
            pbc (an ensemble: one system at different phase-space points).
        calc: ActiveCalculator (a trained model; sampling allowed).
        dt, temperature_K, friction, thermostat, tdamp: as DeviceMD.
        chunk: steps per chunk; seed: walker r's noise stream is seed + r.
    """

    def __init__(self, systems, calc, dt, temperature_K=None, friction=0.01,
                 chunk=100, seed=0, check_beta=None, thermostat="auto",
                 tdamp=None):
        from ..neighbors_device import device_rebuild_ok

        self.systems = list(systems)
        if not self.systems:
            raise ValueError("need at least one replica")
        s0 = self.systems[0]
        for s in self.systems[1:]:
            if len(s) != len(s0) or (s.numbers != s0.numbers).any():
                raise ValueError("replicas must share the species layout")
            if not (np.allclose(s.cell, s0.cell) and (s.pbc == s0.pbc).all()):
                # shared masses and vscale, one cell for the stacked rows
                # and its rebuild check
                raise ValueError("replicas must share the cell and pbc")
        from ..calculator.bcm import BCMActiveCalculator

        if isinstance(calc, BCMActiveCalculator) and calc.experts:
            raise NotImplementedError(
                "ReplicaMD integrates the live SGPR model only; a committee "
                "with frozen experts runs under DeviceMD or the host drivers")
        check_plain_surface(calc, "ReplicaMD")
        self.calc = calc
        self.dt = float(dt)
        self.kT = units.kB * temperature_K if temperature_K else 0.0
        self.friction = float(friction)
        self.chunk = int(chunk)
        self.check_beta = check_beta if check_beta is not None else calc.active
        if thermostat == "auto":
            thermostat = "langevin" if self.kT > 0 else "none"
        if thermostat not in ("langevin", "nhc", "none"):
            raise ValueError(f"unknown thermostat {thermostat!r}")
        self.thermostat = thermostat
        self.tdamp = float(tdamp) if tdamp else 100.0 * self.dt
        R = len(self.systems)
        self.seeds = [int(seed) + r for r in range(R)]
        # chain state: host copies, refreshed by each chunk's one read
        self.nhc_vxi = np.zeros((R, 3))
        self.nhc_xi = np.zeros((R, 3))
        self._nhc_dev = None
        self.nsteps = 0
        self._stall = 0
        self._npad = 0
        self._kpad = getattr(calc, "_kpad", 0)
        self.in_loop_rebuild = device_rebuild_ok(
            s0.cell, s0.pbc, calc.engine.params.rc + calc._nlcache.skin)

    # ------------------------------------------------------------ internals
    def _build_chain(self):
        """The walkers' tables from the host (one bucket), stacked with the
        shared model state into one device chain."""
        calc = self.calc
        eng = calc.engine
        R = len(self.systems)
        cutoff = eng.params.rc + calc._nlcache.skin
        tables = [neighbor_table(s.positions, s.cell, s.pbc, cutoff)
                  for s in self.systems]
        n0 = len(self.systems[0])
        self._npad = max(self._npad, round_up(n0, 16))
        kmax = max(t.kmax for t in tables)
        self._kpad = max(self._kpad, round_up(int(kmax * 1.2) + 4, 16))
        cfg = stack_images([
            eng.make_config(s, npad=self._npad, kpad=self._kpad,
                            table=t.pad_to(self._kpad))
            for s, t in zip(self.systems, tables)], shared_cell=True)
        like = cfg.positions
        model = calc.model
        vs = model.vscale_for(self.systems[0].numbers)
        # host-inf semantics for unseen species (device_md.VS_UNSEEN)
        vs = np.where(np.isfinite(vs), vs, VS_UNSEEN)
        vs = np.concatenate([vs, np.zeros(self._npad - n0)])
        vel = np.zeros((R, self._npad, 3))
        for r, s in enumerate(self.systems):
            vel[r, :n0] = s.get_velocities()
        masses = np.ones((self._npad, 1))
        masses[:n0, 0] = self.systems[0].get_masses()
        sidx = eng.species_index(cfg.numbers.cpu().numpy())

        def t(a, dt=like.dtype):
            return torch.as_tensor(np.asarray(a), dtype=dt, device=like.device)

        return dict(
            cfg=cfg,
            ma=model.full_model_arrays(),
            radii=eng.radii_table(),
            vs=t(np.tile(vs, R)),
            vel=t(vel.reshape(R * self._npad, 3)),
            masses=t(np.tile(masses, (R, 1))),
            pos0=like,
            sidx_atom=t(np.maximum(sidx, 0), torch.int32),
            sidx_ok=t(sidx >= 0, torch.bool),
            cut=cutoff,
            beta_thresh=calc.ediff if self.check_beta else np.inf,
            ks=eng.kernel_space(),
        )

    def _sync_host(self, pos_dev, vel_dev):
        R = len(self.systems)
        n0 = len(self.systems[0])
        pos, vel = device_fetch(pos_dev, vel_dev)
        pos = pos.reshape(R, -1, 3)
        vel = vel.reshape(R, -1, 3)
        for r, s in enumerate(self.systems):
            s.set_positions(pos[r, :n0])
            s.set_velocities(vel[r, :n0])

    def _nhc_kw(self, like):
        """The chains' masses, dof and device state (R, 3) for the next
        chunk."""
        n = len(self.systems[0])
        Q = np.full(3, self.kT * self.tdamp**2)
        Q[0] *= 3.0 * n
        if self._nhc_dev is None:
            self._nhc_dev = tuple(
                torch.as_tensor(a, dtype=like.dtype, device=like.device)
                for a in (self.nhc_vxi, self.nhc_xi))
        return dict(nhc_Q=torch.as_tensor(Q, dtype=like.dtype,
                                          device=like.device),
                    nhc_dof=3.0 * n, nhc_vxi=self._nhc_dev[0],
                    nhc_xi=self._nhc_dev[1])

    def _host_step(self):
        """Step every walker once on the host: the ensemble stays in
        lockstep (stepping one walker would desynchronize trajectories and
        step counts across the walkers)."""
        from .langevin import Langevin
        from .verlet import VelocityVerlet

        for w in self.systems:
            w.calc = self.calc
            if self.thermostat == "langevin" and self.kT > 0:
                Langevin(w, self.dt, self.kT / units.kB, self.friction).step()
            else:
                VelocityVerlet(w, self.dt).step()

    # ---------------------------------------------------------------- run
    def run(self, steps):
        """Advance every replica by ``steps`` steps."""
        calc = self.calc
        eng = calc.engine
        R = len(self.systems)
        nhc = self.thermostat == "nhc"
        inloop = self.in_loop_rebuild
        done = 0
        chain = None
        pos_dev = vel_dev = None
        while done < steps:
            if chain is None:
                chain = self._build_chain()
            else:
                chain["cfg"] = chain["cfg"]._replace(positions=pos_dev)
                chain["vel"] = vel_dev
            n = min(self.chunk, steps - done)
            nhc_kw = self._nhc_kw(chain["pos0"]) if nhc else {}
            out = md_chunk(
                chain["cfg"], chain["ma"], chain["radii"], chain["vs"],
                chain["vel"], chain["masses"], chain["pos0"],
                self.dt, self.kT, self.friction, 0.5 * calc._nlcache.skin,
                chain["beta_thresh"], n,
                params=eng.params, exponent=eng.exponent,
                check_beta=self.check_beta, thermostat=self.thermostat,
                rebuild=inloop, rebuild_cut=chain["cut"],
                sidx_atom=chain["sidx_atom"], sidx_ok=chain["sidx_ok"],
                seed=self.seeds, step0=self.nsteps, ks=chain["ks"], nrep=R,
                **nhc_kw,
            )
            pos, vel, f, e, bmax, i = out[:6]
            if inloop:
                tbl, p0 = out[6:8]
                chain["cfg"] = _graft(chain["cfg"], tbl)
                chain["pos0"] = p0
            if nhc:
                self._nhc_dev = out[-2:]
                # one host read for every boundary scalar and the chains
                bm_h, i_h, self.nhc_vxi, self.nhc_xi = device_fetch(
                    bmax, i.to(torch.int32), *self._nhc_dev)
            else:
                bm_h, i_h = device_fetch(bmax, i.to(torch.int32))
            ndone = int(i_h)
            pos_dev, vel_dev = pos, vel
            done += ndone
            self.nsteps += ndone
            if ndone > 0:
                self._stall = 0
            if ndone == n:
                continue
            tripped = (self.check_beta
                       and float(bm_h.max()) >= chain["beta_thresh"])
            self._sync_host(pos_dev, vel_dev)
            pos_dev = vel_dev = None
            chain = None
            if not tripped:
                # a breach the card could not serve (the bucket overflowed,
                # or no in-loop rebuild for this box): the host rebuilds
                # every table with a larger bucket
                continue
            # the uncertainty tripped: the most uncertain walker gets the
            # full calculator semantics; the updated model then serves the
            # whole ensemble
            s = self.systems[int(np.argmax(bm_h))]
            s.calc = calc
            s.get_potential_energy()
            if ndone == 0:
                # sampling was vetoed or rejected while beta stays above
                # the threshold: force progress only once a host visit
                # already failed to unstick the chunk (DeviceMD's rule)
                self._stall += 1
                if self._stall >= 2:
                    self._host_step()
                    done += 1
                    self.nsteps += 1
                    self._stall = 0
        if pos_dev is not None:
            self._sync_host(pos_dev, vel_dev)
        return True
