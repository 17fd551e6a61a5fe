"""The device-resident MD cell: ``DeviceMD.run`` of the port, in chunks,
serving a frozen model that the benchmark made from its configuration.

Set-up builds the crystal and its velocities from the run's seed and the
model from the configuration's ``model_seed`` (``portbench.reference``),
hands them to the port through its own model API (``SgprModel``,
``ActiveCalculator(covariance=..., calculator=None)``), then warms up: one chunk that builds the kernels and the first tables,
and one host calculation that leaves the host's neighbor cache at the
window's start.  The window is one ``DeviceMD.run`` of a fixed number of
chunks: ``--seconds`` times the cell's ``window_steps_per_s``, its rate
on an H100 when it was defined, so that it lasts about ``--seconds``
there.

The port's ``md_chunk`` is wrapped (:class:`ChunkTap`) for two things
only: the traced slice starts and stops at chunk boundaries, where the
loop has just read the card, and the last chunk's outputs (positions,
forces, energy, the table the in-loop rebuild left) are kept for the
check.  The descriptors and the Gram of that end state are taken after
the window through the port's public ``Engine.descriptors`` and
``Engine.predict``.
"""

from __future__ import annotations

import gc
import math
import time

import torch

from ..counts import soap as soap_counts
from ..counts import step as step_counts
from ..reference import judge, lattice
from ..reference import model as ref_model


class ChunkTap:
    """Stands in for ``device_md.md_chunk`` while the cell runs."""

    def __init__(self, module):
        self.module = module
        self.orig = module.md_chunk
        self.calls = 0
        self.last = None
        self.steps = []  # 0-d device tensors: steps done by each chunk
        self.at = {}  # call index -> hook run at that call's entry
        module.md_chunk = self

    def __call__(self, *args, **kw):
        hook = self.at.pop(self.calls, None)
        if hook is not None:
            hook()
        out = self.orig(*args, **kw)
        self.calls += 1
        self.last = (args, kw, out)
        self.steps.append(out[5])
        return out

    def close(self):
        self.module.md_chunk = self.orig


def port_model(model, config, device, dtype=None):
    """(Engine, SgprModel) of the port serving the benchmark's ``model``:
    its inducing environments (the port computes their descriptors) and
    weights, through the port's own model API."""
    from autoforce_tpu_torch.descriptor.soap import SoapParams
    from autoforce_tpu_torch.engine import Engine
    from autoforce_tpu_torch.regression.sgpr import InducingEnv, SgprModel

    eng = Engine(params=SoapParams(lmax=model.lmax, nmax=model.nmax, rc=model.rc),
                 exponent=model.zeta, radii=float(config["radii"]),
                 species=model.species, device=device, dtype=dtype)
    sgpr = SgprModel(eng)
    sgpr.X = [InducingEnv.from_arrays(z, rv, nz) for z, rv, nz in model.envs]
    sgpr.restage()
    sgpr.mu = model.mu.cpu().numpy()
    sgpr.choli = model.choli.cpu().numpy()
    sgpr.vscale = {z: 1.0 for z in model.species}
    return eng, sgpr


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Cell:
    def __init__(self, config, work, seed, device):
        from autoforce_tpu_torch import units
        from autoforce_tpu_torch.calculator.active import ActiveCalculator
        from autoforce_tpu_torch.md import device_md
        from autoforce_tpu_torch.md.device_md import DeviceMD
        from autoforce_tpu_torch.system import System

        self.device = device
        self.work = work
        self.phases = {}
        t0 = time.perf_counter()
        # one model per configuration, whatever the run's seed: a model
        # fitted from other frames breaches the skin at another rate, so
        # the run's seed would change the work (up to 17 %, PR 13)
        self.model = ref_model.build(config, int(config["model_seed"]), device)
        _sync(device)
        self.phases["model"] = round(time.perf_counter() - t0, 3)
        self.notes = {"model_fit": self.model.fit}
        if device.type == "cuda":
            # the peak is the port's: the benchmark's own model build
            # (copies of the cell, forward-mode rows) is left out of it
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        pos, numbers, cell = lattice.crystal(config, work["reps"], device)
        gen = ref_model.generator(device, seed, 1)
        pos = pos + float(work["rattle"]) * torch.randn(
            pos.shape, generator=gen, dtype=pos.dtype, device=device)
        # the lattice takes about half of the kinetic energy it starts
        # with: start_temperature_K (twice the bath's) starts at equilibrium
        vel = lattice.velocities(numbers, float(work["start_temperature_K"]),
                                 ref_model.generator(device, seed, 2))
        self.numbers = numbers
        self.cell = cell
        m = self.model
        system = System(numbers=numbers.cpu().numpy(), positions=pos.cpu().numpy(),
                        cell=cell.cpu().numpy(), pbc=True,
                        velocities=vel.cpu().numpy())
        self.engine, sgpr = port_model(m, config, device)
        # the trip is off (check_beta=False) and ediff = inf: serving only
        calc = ActiveCalculator(covariance=sgpr, calculator=None, logfile=None,
                                pckl=None, tape=None, skin=float(work["skin"]),
                                ediff=math.inf, device=device)
        system.calc = calc
        self.system = system
        self.dyn = DeviceMD(system, calc, dt=float(work["dt_fs"]) * units.fs,
                            temperature_K=float(work["temperature_K"]),
                            friction=float(work["friction"]),
                            chunk=int(work["chunk"]), seed=int(seed),
                            check_beta=False)
        self.tap = ChunkTap(device_md)
        self.phases["port"] = round(time.perf_counter() - t0, 3)

    # ------------------------------------------------------------- warm-up
    def warm(self, seconds):
        """Build and warm every shape with one chunk, leave the host's
        neighbor cache at the window's start, and size the window: a fixed
        amount of work, ``window_steps_per_s`` steps (the cell's rate on
        an H100 when it was defined) for each of the ``seconds``, in whole
        chunks."""
        chunk = int(self.work["chunk"])
        t0 = time.perf_counter()
        self.dyn.run(chunk)
        _sync(self.device)
        t1 = time.perf_counter()
        # the window's run() starts from the table of the state it is handed
        self.system.get_potential_energy()
        self.phases.update(first_chunk=round(t1 - t0, 3),
                           host_table=round(time.perf_counter() - t1, 3))
        steps = float(self.work["window_steps_per_s"]) * seconds
        self.nchunks = max(1, int(round(steps / chunk)))
        return self.nchunks * chunk

    def traced_chunks(self):
        """The window of a traced run: at least the slice and one chunk on
        each side of it."""
        least = int(self.work["slice_at"]) + int(self.work["slice_chunks"]) + 1
        self.nchunks = max(self.nchunks, least)
        return self.nchunks * int(self.work["chunk"])

    # -------------------------------------------------------------- window
    def window(self, tracer=None):
        """One ``DeviceMD.run`` of the sized chunks.  With ``tracer``
        (a ``trace.Slice``) the chunks ``slice_at .. slice_at +
        slice_chunks`` are profiled.  Returns the record of the window."""
        chunk = int(self.work["chunk"])
        n = self.nchunks * chunk
        base = self.tap.calls
        start = torch.as_tensor(self.system.positions, device=self.device)
        rec = {"steps": n}
        marks = {}
        if tracer is not None:
            a = base + int(self.work["slice_at"])
            b = a + int(self.work["slice_chunks"])

            def begin():
                marks["t0"] = time.perf_counter()
                tracer.start()
                marks["t1"] = time.perf_counter()

            def end():
                marks["t2"] = time.perf_counter()
                tracer.stop()
                marks["t3"] = time.perf_counter()

            self.tap.at[a] = begin
            self.tap.at[b] = end
        _sync(self.device)
        t0 = time.perf_counter()
        self.dyn.run(n)
        _sync(self.device)
        wall = time.perf_counter() - t0
        rec["wall_s"] = wall
        if tracer is not None:
            a = int(self.work["slice_at"])
            b = a + int(self.work["slice_chunks"])
            done = [int(t) for t in self.tap.steps[base:]]
            slice_steps = sum(done[a:b])
            rec["slice_steps"] = slice_steps
            rec["slice_wall_s"] = marks["t2"] - marks["t1"]
            outside = wall - (marks["t3"] - marks["t0"])
            rec["step_wall_s"] = outside / max(n - slice_steps, 1)
        self.start = start
        return rec

    # --------------------------------------------------------------- state
    def final_state(self):
        """The port's end-of-window state for the check: the last chunk's
        positions, forces, energy and the table it left, and the
        descriptors and Gram of that state through the port's engine."""
        args, kw, out = self.tap.last
        cfg = args[0]
        if kw.get("rebuild"):
            tbl = out[6]
            cfg = cfg._replace(nbr_idx=tbl[0], nbr_off=tbl[1], nbr_sidx=tbl[2],
                               nbr_mask=tbl[3],
                               nbr_rev=tbl[4] if len(tbl) > 4 else None)
        cfg = cfg._replace(positions=out[0])
        N = len(self.system)
        m = self.model.X.shape[0]
        with torch.no_grad():
            p, _ = self.engine.descriptors(cfg)
        vscale = args[3].detach().to(torch.float64).cpu().numpy()
        K = self.engine.predict(cfg, args[1], vscale)[3]
        return {
            "pos": out[0][:N], "start": self.start, "cell": self.cell,
            "numbers": self.numbers,
            "nbr_idx": cfg.nbr_idx[:N], "nbr_off": cfg.nbr_off[:N],
            "nbr_mask": (cfg.nbr_mask & cfg.atom_mask[:, None])[:N],
            "p": p[:N], "K": K[:N, :m],
            "energy": out[3], "forces": out[2][:N],
        }

    def end_to_end(self, rec):
        """This driver's end-to-end metrics besides set-up and memory."""
        return {"md_steps_per_s": (rec["steps"] / rec["wall_s"], "steps/s")}

    def trace_record(self, rec, state):
        """What the per-layer readers take besides the trace: the SOAP
        kernels' work per call, counted on the last table as the step
        makes the kernels' inputs, and the step's FLOPs."""
        pos = state["pos"].to(torch.float32)
        idx = state["nbr_idx"].long()
        off = state["nbr_off"].to(torch.float32)
        rvec = pos[idx] - pos[:, None, :] + off @ self.cell.to(torch.float32)
        sidx = self.model.species_index(self.numbers)[idx]
        radii = torch.ones(len(self.model.species), dtype=torch.float32,
                           device=self.device)
        m, D = self.model.X.shape
        fwd, bwd, _ = soap_counts.soap_work(rvec, sidx, state["nbr_mask"], radii,
                                            self.model.lmax, self.model.nmax,
                                            self.model.rc)
        rec.update(soap_fwd_work=fwd, soap_bwd_work=bwd,
                   flops_per_step=step_counts.step_flops(
                       pos.shape[0], m, D, fwd[1], bwd[1]))

    def check(self, state):
        """(numbers compared, whether the end state is finite)."""
        finite = bool(torch.isfinite(state["pos"]).all()
                      and torch.isfinite(state["forces"]).all())
        return judge.port_numbers(self.model, state), finite

    def close(self):
        self.tap.close()
        self.dyn = None
        self.system.calc = None
        self.system = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
