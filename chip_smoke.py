#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``autoforce_tpu_torch``) on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (any fault ends the run with a non-zero exit and no ``ok`` line):

1. Environment: the card's name and power limit; the SOAP-coefficient
   kernels are built from ``autoforce_tpu_torch/csrc`` with ``nvcc`` and
   its register / shared-memory / spill report is printed.
2. Each kernel against its plain PyTorch version on the card, on the
   inputs of the main path (the 1008-atom bench snapshot at the MD neighbor
   bucket and at rc, and the 4-species snapshot) in float64 and float32,
   and on the 10,192-atom snapshot at the MD bucket rule in float32; the
   backward also against torch autograd through the plain forward.
3. Accuracy of ``Engine.predict`` (float32 on the card) on the 1008-atom
   Cu snapshot against the float64 reference ``baselines/_acc_ref.npz``,
   and the energy error of each float32 stage taken alone.
4. Serving MD: ``DeviceMD`` around ``ActiveCalculator(covariance=<model
   folder>, calculator=None, skin=1.2)``: Langevin 300 K, 2 fs, friction
   0.02, chunk 100 (the main path, with every launch counter read around
   it), then 1000 NVE steps for the energy drift.
5. On-the-fly learning (the second main path): the OTF flagship of
   ``bench.py`` (``measure_otf``) on the port
   (``autoforce_tpu_torch.tools.otf_bench``): the 1024-atom ordered
   4-species LGPS-like crystal learns from the Lennard-Jones mixture oracle
   during ``DeviceMD`` (400 K, 2 fs, friction 0.05, chunk 50) with the
   uncertainty trip armed, model from seed (lmax = nmax = 3, rc = 6 A,
   skin 1.2, ediff = 2 kcal/mol, max_inducing 1024): growth, production
   with learning on, then frozen MD (at least ten chunks), growth and
   production each under a wall cap (``OTF_CAPS``).  Fails
   unless production added ``OTF_PROD_FLOOR`` inducing environments or
   more, the learned forces are within 0.15 eV/A (MAE) of the oracle's,
   both kernels launched while learning, and positions stayed finite.
   Then, on the learned model: ``kernel_block`` in float32 (the kernels)
   against float64 (the plain versions) on the card, both kernels against
   their plain versions at the learning path's shapes, and the device time
   per call of ``kernel_block`` and ``kernel_cols_multi``.
7. Structure drivers (run right after phase 4; the workloads of
   ``autoforce_tpu_torch.tools.driver_bench``, the same model and
   calculator): ``DeviceMD(thermostat="nhc")`` 300 K, 2 fs, tdamp 50 fs,
   300 warm-up + 150 timed steps, mean temperature within 15 % of 300 K;
   ``DeviceNPT`` as ``bench.py``'s ``npt_1k`` (isotropic, 0 GPa, pdamp
   500 fs, 150 + 150 steps) for the rate, then at the model's own pressure
   on the snapshot 150 isotropic steps (the last 100 timed) and 100
   flexible steps with ``mask=(1, 1, 0)``: finite, volume within 5 % of
   the start, the masked strain component unmoved; the anisotropic dE/deps of
   ``_sgpr_forces_virial`` in float32 (kernels) against float64 (plain
   versions) within ``STRESS_REL_TOL``; ``DeviceFIRE`` as ``bench.py``'s
   ``relax_fire_1k`` (150 + 150 iterations), then ``cell=True`` from
   a = 3.65 A to fmax 0.05 eV/A or 500 iterations, the energy dropping;
   ``DeviceNEB`` on a 499-atom vacancy hop (end points relaxed by
   ``DeviceFIRE``, counted as a path of their own; five interior images,
   climbing image, up to 300 iterations), a finite positive barrier,
   exactly one launch of each kernel per band evaluation, and the band's
   stacked float32 energies and forces (the kernels) against each image
   alone in float64 (the plain versions) within ``BAND_E_TOL`` /
   ``BAND_F_TOL``; the same hop with the last end point's cell stretched
   by 1 % along x and a cell per image (up to 50 iterations: finite
   energies, one launch of each kernel per band evaluation, the stacked
   band against each image alone as above); then both kernels against
   their plain versions at the stacked band's shape, as in phase 2.  Every
   driver launches both kernels, and its first chunk runs under CUDA's
   sync debug mode "error" (no host sync inside the steps but the
   documented breach reads).
8. The kernel space (run right after phase 5; the workloads of
   ``autoforce_tpu_torch.tools.kernelspace_bench``).  (a) On phase 5's
   learned flagship model: ``kernel_block(method="jac")`` (the descriptor
   Jacobian from one one-hot launch of the backward kernel) in float32
   against the column route in float32 and against float64 through the
   plain versions (``JAC_KE_TOL``, ``JAC_KF_TOL``), the device time per
   call of both routes, one launch of each kernel per Jacobian call, and
   both kernels against their plain versions at the one-hot launch's
   shape.  (b) The flagship's growth stage with a trainable kernel
   expression, exp(-g ||p - q||^2) at g = 0.5, and ``kernel_hpo=1``,
   stopped at the record count whose energy-LML tensors fit
   ``LML_BYTES_CAP`` or after 30 s, whichever comes first (the wall cap,
   in the script's time limit): HPO ran, forces finite, both kernels
   launched.  (c) The force-aware LML's value and gradient on four
   32-atom Cu records, float64 on the card (kernels) against the CPU
   (plain versions), within 1e-9 relative.  (d) The flagship with
   ``chemical="rbf"`` and a Li-S pair term: a growth stage of 45 s
   (``KS_CAPS``), finite forces and positions, float32 predict against
   float64 plain on the final snapshot, then 60 frozen ``DeviceMD`` steps
   timed after a first, sync-checked chunk of 10 steps.
9. A Bayesian committee (run right after phase 8; the workloads of
   ``autoforce_tpu_torch.tools.bcm_bench``, caps in ``BCM_CAPS``, a budget
   of 150 s).  Phase 5's learned flagship model is saved as
   ``bcm_1.pckl`` and found by ``BCMActiveCalculator(pckl="bcm.pckl",
   max_inducing=256, max_data=8)`` as its live model; its first update
   freezes it as expert 1.  (a) Growth under ``DeviceMD`` (400 K, 2 fs,
   friction 0.05, trip armed) for 45 s: an expert frozen in the stage, at
   least two models served, finite positions and forces.  (b) 200 frozen
   committee MD steps (first chunk sync-checked): one launch of each
   kernel per committee evaluation, whatever the number of experts; the
   rate, device kernels and busy share per step.  (c) The device
   committee in float32 (kernels) against the host committee in float64
   (plain versions): 2e-4 eV/atom, force MAE 1e-2 eV/A; both sides'
   weights.  (d) 100 isotropic NPT steps at the committee's own pressure
   (potential and kinetic), from the crystal scaled to where its potential
   pressure vanishes (at its NVT lattice constant it sits near -9 GPa and
   expands without bound under any model of the oracle) and thermalized
   by 50 Langevin steps: finite, volume within 5 %.  (e) 100 FIRE
   iterations: the energy drops.
   (f) A Li vacancy hop: ends relaxed by committee FIRE, five interior
   images, climbing image, up to 100 iterations: a finite barrier, one
   launch of each kernel per band evaluation, the stacked band against
   each image alone as in phase 7.  (g) Both kernels against their plain
   versions at the committee band's stacked shape, timed in phase 6.
10. Replica ensembles, metadynamics, multi-task learning and the
   parametric potential (run right after phase 9; the workloads of
   ``autoforce_tpu_torch.tools.ensemble_bench``, caps in ``ENS_CAPS``, a
   budget of 100 s).  (a) ``bench.py``'s ``measure_replicas``: 16 copies of
   the bench snapshot under ``ReplicaMD`` (Langevin 300 K, 2 fs, friction
   0.02, chunk 400), 150 + 300 ensemble steps, the walkers stacked as one
   configuration of 16,128 rows: one launch of each kernel per ensemble
   step, the rates beside phase 4's single walker, and the stacked float32
   rows against each walker alone in float64 plain (``BAND_E_TOL`` /
   ``BAND_F_TOL``).  (b) ``ActiveMeta(scale=1e-2)`` fused into ``DeviceMD``
   on the bench model (100 + 200 steps, one launch of each kernel per
   step, the rate); the bias alone in float32 against
   ``engine.meta_covloss_fn`` in float64 plain, on phase 5's learned model
   and its crystal rattled 0.15 A (the bench model's beta sits at its clip
   floor everywhere); the committee's fused floor bias on phase 9's
   committee against the host formula (one evaluation, one launch of
   each kernel); 20 host Langevin steps each with ``SoapMeta`` and
   ``Meta(Posvar)``.  (c) ``MultiTaskCalculator`` with two Lennard-Jones
   tasks at weights (0.7, 0.3), learning under ``DeviceMD`` (600 K) on a
   256-atom fcc Cu cell for 30 s, then 200 static-weight steps on the bench
   snapshot and 100 more after ``set_weights([0, 1])``: a sample taken,
   one launch of each kernel per step, float32 device against float64
   host plain after each weight change (2e-4 eV/atom, 1e-2 eV/A), the two
   weightings' forces different.  (d) ``ParametricCalculator`` with LJ
   terms on the card against the oracle of the same form (``PARAM_TOL``).
   Then both kernels against their plain versions at the replica rows
   and the multi-task growth rows, timed in phase 6.
11. The offline workflow and the out-of-process oracle (run right after
   phase 10; the pieces of ``autoforce_tpu_torch.tools.offline_bench``,
   caps in ``OFF_CAPS``, a budget of 75 s), at the flagship's width
   (lmax = nmax = 3, rc = 6 A, the 1024-atom 4-species crystal, the
   oracle ``MixtureLennardJones``).  (a) ``python -m
   autoforce_tpu_torch.calculator.calc_server`` serves the oracle, written
   as a script, from a process of its own on a free localhost port;
   ``SocketCalculator`` against the oracle in this process on three
   rattled crystals (1e-10 of the largest value).  (b) ``cl.init_model``
   through the socket (``inprocess = False``, two samples): a model with
   data and inducing environments, one oracle call per answered request,
   both kernels launched.  (c) Six frames of a frozen ``DeviceMD`` run
   of phase 5's model at 400 K, labelled through the socket, and one
   ``cl.singlepoint``; then the server is stopped (its exit code held).
   (d) ``cl.train`` on four frames from seed (``offline_bench.TRAIN``'s
   thresholds), ``cl.test`` and ``scores.compare_trajectories`` on the
   two held-out frames for it (force R2 >= 0.8) and for phase 5's model
   (force MAE <= 0.15 eV/A).
   (e) ``cl.build`` from (d)'s tape: the same (ndata, m), float32 (kernels)
   against float64 (plain) on the rebuilt model (2e-4 eV/atom, 1e-2 eV/A).
   (f) ``cl.shrink -m (m - 2) -c 8`` and one prediction, which restages
   the shrunk model (the path's launches): the target reached, the
   restaged model as in (e), the held-out force R2 before and after.  (g)
   ``cl.lmp``'s ``LammpsDriver`` on the bench snapshot with phase 4's
   serving calculator and a stand-in LAMMPS handle, 20 callbacks in
   ``metal`` units: the pushed energy and forces as ``calculate``'s
   (1e-6 of the largest value), one launch of each kernel per callback.
12. The device mesh (run right after phase 11; the workloads of
   ``autoforce_tpu_torch.tools.mesh_checks``): a 2x2 ('data', 'model')
   mesh over the visible cards in turn (one card: ``cuda:0`` four times).
   (a) ``Engine.predict`` under the mesh against without it, both float32
   through the kernels (``mesh_checks.MESH_*_TOL``), and against the
   float64 reference at the bench.py:412 bars; (b) ``kernel_block`` on the
   column and Jacobian routes against the unsharded call (``KB_*`` /
   ``JAC_*``); (c) ``DeviceMD`` under the mesh: its first evaluation
   against the unsharded one, steps/s, busy share and kernels per step
   beside the unsharded driver's, every force evaluation launching each
   kernel once per data shard, its first chunk under the sync check and
   its breach reads counted; (d) ``DeviceNPT``, ``DeviceFIRE`` (both
   cells) and ``DeviceNEB`` likewise (first evaluation, finite, launches
   per evaluation); (e) phase 9's committee and the fused ActiveMeta bias
   under the mesh; (f) ``ActiveCalculator(mesh=...)`` learning the
   flagship for ``MESH_CAPS["learn_wall_cap"]`` s, its model's predict
   under the mesh against without; (g) ``cl.md`` with ``mesh =
   make_mesh(...)`` in ARGS; (h) ``parallel.mesh_bench`` at 1008 atoms:
   the sharded step against ``md_chunk``; (i) a 3 x 1 mesh, whose data
   axis pads the 1024-atom flagship's rows to 1026, serving phase 5's
   model: ``DeviceMD`` (Langevin, then NHC) for one 20-step chunk with a
   0.3 A skin, breached inside it, against the unsharded driver from the
   same state and noise (``mesh_checks.padded_md``: forces at
   ``MESH_F_TOL`` of the largest slot term, positions within
   ``traj_bound``, equal breach reads).  Both kernels are then checked
   at one data shard's rows, timed in phase 6.
13. The periphery (run right after phase 12; caps in ``PERI_CAPS``, a
   budget of 30 s).  (a) ``autoforce_tpu_torch.graft_entry.entry()``: the
   fused SGPR step float32 on the card against float64 through the plain
   versions (2e-4 eV/atom, 1e-2 eV/A), one launch of each kernel.  (b)
   ``graft_entry.dryrun_multichip(3)`` on ``cuda:0`` repeated (3 x 1, the
   data axis adds rows; its own 1e-8 checks, float64) and
   ``dryrun_multichip(4)`` (2 x 2) while the budget allows.  (c)
   ``analysis.structgen.StructureSearch`` ranking Ge <-> P swaps of the
   unrattled flagship crystal with phase 5's model served frozen: one
   epoch, every energy float32 against float64 plain (2e-4 eV/atom), one
   launch of each kernel per energy, the structure restored after every
   probe, the cache read back by a second search.  (d) ``remote.twinrun``:
   the flagship's oracle behind a ``calc_server`` process on a free port
   and a driver process serving phase 5's model on the card: the oracle
   through the socket against this process's (1e-10 of the largest
   value), the driver's launches (one of each per evaluation) and
   sizes, the port free afterwards where ``lsof`` exists.  (e)
   ``analysis.logs`` on phase 5's active.log (the last parsed sizes are
   phase 5's), ``log_to_figure`` to a PNG where matplotlib is installed,
   ``TrajAnalyser`` and ``rdf`` on frames of phase 4's serving MD.
6. Timings: steps/s of phase 4; each kernel's device time beside its
   plain version's and its bound at the timing shapes (the MD bucket of
   phase 4, the 10,192-atom snapshot, the 4-species snapshot, the NEB
   band's stacked rows, the learning path's staging and kernel_block
   rows, the Jacobian route's one-hot rows, the committee band's rows,
   the replica ensemble's stacked rows, the multi-task growth rows and
   one mesh data shard's rows;
   each plain version timed once, three calls in one traced window); a
   profiler breakdown of the MD step.

Each phase logs its wall time; the whole script is held to 1000 s on an
H100 (its time limit is 1200 s).  Before the last lines come JSON objects
with each phase's numbers (``drivers``, ``otf``, ``kernel_space``,
``committee``, ``replicas_meta_multitask_parametric``, ``offline_oracle``,
``mesh``, ``periphery``);
the line before the card's is one JSON object with every kernel's numbers
(launches split by path: serving MD, OTF learning, each structure driver,
each kernel-space path, each committee path, the replica ensemble, the
fused and host metadynamics, multi-task growth and serving, and the
offline paths: socket learning, train, test, build, shrink, LAMMPS, and
the mesh paths: predict, kernel_block, MD, NPT, FIRE, FIRE cell, NEB,
committee, ActiveMeta, learning, cl.md, mesh_bench, the padded mesh, and
the periphery's: graft_entry, dryrun, structgen and the twin run's driver
process, as it counted them); the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import os
import shutil
import sys
import tempfile
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))
MODEL = os.path.join(HERE, "baselines", "bench_model.pckl")
MODEL_MS = os.path.join(HERE, "baselines", "bench_model_ms.pckl")
ACC_REF = os.path.join(HERE, "baselines", "_acc_ref.npz")
SKIN = 1.2
# float32 kernel vs plain: both sum up to K float32 terms in different
# orders; K * eps ~ 2e-5 is the worst case at K = 176, sqrt(K) * eps the
# typical one.  Relative to the largest magnitude of the result.
F32_REL_TOL = 1e-5
F64_ABS_TOL = 1e-10
# kernel_block, float32 through the kernels against float64 through the
# plain versions, relative to the largest value of each block.  Ke sums
# (p . x)^4 over the atoms: a float32 descriptor carries ~sqrt(K) eps
# ~ 1e-6 relative error (K ~ 80 live slots), the 4th power makes it ~4e-6;
# 1e-5 leaves a factor 2.5.  Kf and Kv go through the power spectrum's
# backward and the backward kernel, each held to 1e-5 of its largest value
# on its own (F32_REL_TOL), and each force row sums ~K slot terms of both
# signs, so 10x that.
KB_KE_TOL = 1e-5
KB_KF_TOL = 1e-4
# the Jacobian route's kernel_block in float32, against the column route
# in float32 and against float64 through the plain versions, relative to
# the largest value of each block: the same form and size as KB_KE_TOL /
# KB_KF_TOL.  Ke is the same sum of (p . x)^4 on both routes; the
# Jacobian route's Kf and Kv sum, per force row, the ~K slot terms of
# dc/drvec (each as exact as the backward kernel, F32_REL_TOL) times
# the float32 chain through the spectrum, the same count of terms of both
# signs as the column route's backward.
JAC_KE_TOL = 1e-5
JAC_KF_TOL = 1e-4
# the kernel-space learning checks' stage caps (phase 8), set by the
# script's time limit.  Kernel HPO learning gets 30 s (about 5 records:
# the record cap of 17 would take minutes more).  The chemical + pair
# growth gets 45 s, which ends after its third or fourth update on an
# H100 (m ~ 250-370); its frozen MD then runs 2-8 steps/s, the pair Gram
# being plain float64 torch, so its rate is read over 20 steps after a
# first, sync-checked chunk of 10.  Not more: when the growth runs on to
# m ~ 680 the rate falls to 0.4 steps/s, and 60 steps took the script
# past 1000 s on an H100 (PERF.md)
KS_CAPS = dict(hpo_wall_cap=30.0, chem_wall_cap=45.0, frozen_steps=20,
               frozen_warmup=10)
# the OTF phase's stages and caps: the flagship's sizes, thresholds and
# step counts (bench.py measure_otf), with wall caps that keep the whole
# script inside its time limit: growth ends by m >= 512 in under a minute
# on an H100, production (about 0.3 steps/s while the model still grows)
# gets 5 1/4 minutes (6 until phase 12, the mesh, took 45 s of them).
# Production is the learning user's steady state: MD with the trip armed
# on a model past the growth stage, each trip sampling, refitting and
# resuming at m between 512 and max_inducing (1024), where the column
# blocks and the solves are largest.  The cap no longer lets it reach
# max_inducing, so what it must reach is held instead: OTF_PROD_FLOOR
# inducing environments added in production.  Seven calls on an H100
# added 372-471 in 98-122 steps (m 541-550 -> 922-1012, PERF.md sections
# 5 and 6); 256 takes m from ~545 past 800 and leaves 31 % below the
# least of them for a slow host
OTF_CAPS = dict(grow_cap=400, prod_steps=400, chunk=50, grow_wall_cap=150.0,
                prod_wall_cap=315.0)
OTF_PROD_FLOOR = 256
# phase 5's active.log, kept in the working directory for phase 13 (e)
OTF_LOG = "otf_active.log"
# the committee phase (9): the growth stage's wall cap and each driver's
# steps; the phase's budget is 150 s, the script's ceiling 1000 s
BCM_CAPS = dict(max_inducing=256, max_data=8, grow_wall_cap=45.0,
                md_steps=200, npt_steps=100, fire_steps=100, neb_steps=100,
                neb_end_steps=150)
# phase 10: the replica ensemble of bench.py's measure_replicas (R = 16,
# chunk 400, 150 warm-up + 300 timed ensemble steps), 200 ActiveMeta
# steps after a first chunk of 100, 20 host steps of each host bias, the
# multi-task growth's wall cap (checked after every chunk of 20 steps) and
# its served steps before and after the weight switch; the phase's budget
# is 100 s
ENS_CAPS = dict(replicas=16, rep_chunk=400, rep_warmup=150, rep_steps=300,
                meta_scale=1e-2, meta_steps=200, host_meta_steps=20,
                mt_wall_cap=30.0, mt_steps=200, mt_steps_switched=100)
# phase 11: the oracle server's three socket-vs-in-process checks,
# init_model's samples, the frames of the frozen run (one every 25 steps;
# the last two are held out, the others train, at offline_bench.TRAIN's
# thresholds), the shrink target (m - 2, 8 candidates per removal) and
# the LAMMPS callbacks; the phase's budget is 75 s.  Six frames, not
# eight: on eight (six trained, m = 622) the phase took 92.4 s on an H100
# (training 37.5 s, the shrink 25.1 s), on six 43.7-46.7 s (PERF.md)
OFF_CAPS = dict(socket_checks=3, init_samples=2, frames=6, every=25,
                shrink_by=2, shrink_candidates=8, lmp_callbacks=20)
# phase 12, the mesh: the learning check's wall cap (15 s at most; about
# 8 OTF chunks of 20 steps on an H100), cl.md's steps and
# mesh_bench's timed steps; the phase's budget is 45 s, paid for by OTF
# production's wall cap (360 -> 315 s)
MESH_CAPS = dict(learn_wall_cap=12.0, cl_steps=40, bench_steps=100)
# phase 13, the periphery: the budget (30 s on an H100), the StructureSearch
# probe (one epoch of Ge <-> P swaps on the unrattled flagship crystal,
# whose site deduplication keeps three children), the twin run's
# configurations, and the dry run on four devices (3.2 s on an H100), run
# last and only while PERI_CAPS["dryrun4_before"] s or more of the budget
# are left
PERI_CAPS = dict(budget=30.0, swap=(32, 15), max_child=4, max_parents=2,
                 twin_configs=3, dryrun4_before=5.0)


def log(*a):
    print(*a, flush=True)


# ----------------------------------------------------------------- phases


def phase_build():
    from autoforce_tpu_torch.descriptor import soap_kernels as sk
    from autoforce_tpu_torch.tools import soap_bench as sb

    t0 = time.time()
    sk.build_library(force=True)
    log(f"built {sk.LIB_PATH} in {time.time() - t0:.1f} s")
    sb.print_build_report(sk.build_log)


def phase_kernels(cases):
    """Every kernel against its plain version on the card, in the dtypes
    each case names; returns the float32 errors by case."""
    import torch

    from autoforce_tpu_torch.descriptor import soap_kernels as sk

    worst = {}
    for name, (params, args, dtypes) in cases.items():
        for dt in dtypes:
            rvec, sidx, mask, radii = args
            rvec = rvec.to(dt)
            radii = radii.to(dt)
            N, K, _ = rvec.shape
            CH = sk.channels(radii.shape[0], params)
            g = torch.Generator(device="cuda").manual_seed(7)
            crb = torch.randn((N, CH), generator=g, device="cuda", dtype=dt)
            cib = torch.randn((N, CH), generator=g, device="cuda", dtype=dt)
            cr, ci = sk.soap_coeff_fwd(rvec, sidx, mask, radii, params)
            pr, pi = sk.soap_coeff_fwd_plain(rvec, sidx, mask, radii, params)
            rb = sk.soap_coeff_bwd(rvec, sidx, mask, radii, crb, cib, params)
            pb = sk.soap_coeff_bwd_plain(rvec, sidx, mask, radii, crb, cib, params)
            torch.cuda.synchronize()
            e_f = max((cr - pr).abs().max().item(), (ci - pi).abs().max().item())
            e_b = (rb - pb).abs().max().item()
            s_f = max(pr.abs().max().item(), pi.abs().max().item())
            s_b = pb.abs().max().item()
            if dt == torch.float64:
                tol_f = tol_b = F64_ABS_TOL
                rv = rvec.detach().requires_grad_(True)
                a, b = sk.soap_coeff_fwd_plain(rv, sidx, mask, radii, params)
                (ga,) = torch.autograd.grad((a * crb).sum() + (b * cib).sum(), rv)
                e_a = (rb - ga).abs().max().item()
                log(f"{name} float64 N={N} K={K} S={radii.shape[0]}: "
                    f"fwd {e_f:.3e} bwd {e_b:.3e} bwd-vs-autograd {e_a:.3e} "
                    f"(tol {F64_ABS_TOL:g} abs)")
                if not e_a <= 1e-9 * max(1.0, s_b):
                    raise AssertionError(f"{name}: backward vs autograd {e_a}")
            else:
                tol_f = F32_REL_TOL * s_f
                tol_b = F32_REL_TOL * s_b
                log(f"{name} float32 N={N} K={K} S={radii.shape[0]}: "
                    f"fwd {e_f:.3e} (tol {tol_f:.3e}) bwd {e_b:.3e} "
                    f"(tol {tol_b:.3e})")
                worst[name] = (e_f, e_b)
            if not (e_f <= tol_f and e_b <= tol_b):
                raise AssertionError(f"{name} {dt}: kernel disagrees with plain")
            # the m > l channels are written as zero
            L = params.lmax + 1
            zero = torch.ones(L, L, dtype=torch.bool).triu(1).reshape(-1)
            zmask = zero.repeat(CH // (L * L)).to("cuda")
            if cr[:, zmask].abs().max().item() != 0 or ci[:, zmask].abs().max().item() != 0:
                raise AssertionError(f"{name}: m > l channels not zero")
    return worst


def phase_accuracy(model):
    import numpy as np
    import torch

    from autoforce_tpu_torch.tools import soap_bench as sb

    eng = model.engine
    system = sb.bench_system()
    n = len(system)
    cfg = eng.make_config(system)
    ma = model.full_model_arrays()
    e, f, *_ = eng.predict(cfg, ma, np.ones(cfg.npad))
    torch.cuda.synchronize()
    ref = np.load(ACC_REF)
    e_err = abs(float(e) - float(ref["e"])) / n
    f_mae = float(np.abs(f.cpu().numpy()[:n] - ref["f"]).mean())
    log(f"accuracy (float32 predict vs float64 reference, {n} atoms, "
        f"K={cfg.nbr_idx.shape[1]}): energy error {e_err:.3e} eV/atom "
        f"(bar 2e-4), force MAE {f_mae:.3e} eV/A (bar 1e-2)")
    if not (e_err < 2e-4 and f_mae < 1e-2):
        raise AssertionError("predict misses the accuracy bars")
    precision_breakdown(system, float(ref["e"]))
    return e_err, f_mae


def precision_breakdown(system, e_ref, device="cuda"):
    """Energy error of the float32 stages one at a time (informational).

    Inducing descriptors X and per-atom descriptors p are made several
    ways; each (p, X) pair is contracted in float64 against the float64
    weights, so the printed error is that of the descriptors alone, and
    two pairs are also contracted in float32 (the Gram block and energy in
    the working type)."""
    import numpy as np
    import torch

    from autoforce_tpu_torch.descriptor import soap_kernels as sk
    from autoforce_tpu_torch.descriptor.soap import power_spectrum
    from autoforce_tpu_torch.io.model_io import load_model
    from autoforce_tpu_torch.kernels import gram

    f32, f64 = torch.float32, torch.float64
    m = load_model(MODEL, device=device, dtype=f64)
    eng, params = m.engine, m.engine.params
    L, nf = params.lmax + 1, params.nmax + 1
    ma = m.full_model_arrays()
    mm = ma.m_mask
    n = len(system)
    envs = eng.make_envs([(x.rvec, x.numbers) for x in m.X], dtype=f64)
    radii = eng.radii_table()

    def desc(rvec, sidx, mask, rad, route, spectrum_dtype=None):
        fwd = sk.soap_coeff_fwd if route == "kernel" else sk.soap_coeff_fwd_plain
        with torch.no_grad():
            cr, ci = fwd(rvec, sidx, mask, rad, params)
        if spectrum_dtype is not None:
            cr, ci = cr.to(spectrum_dtype), ci.to(spectrum_dtype)
        S = rad.shape[0]
        return power_spectrum(cr.reshape(-1, S, nf, L, L),
                              ci.reshape(-1, S, nf, L, L), params)

    ev = (envs.rvec, envs.sidx, envs.mask)
    ev32 = (envs.rvec.to(f32), envs.sidx, envs.mask)
    cpu = tuple(t.cpu() for t in ev32)
    X = {
        "float64 kernel": desc(*ev, radii, "kernel"),
        "float64 kernel, rvec rounded to float32":
            desc(envs.rvec.to(f32).to(f64), envs.sidx, envs.mask, radii, "kernel"),
        "float64 kernel, X rounded to float32":
            desc(*ev, radii, "kernel").to(f32),
        "float32 kernel": desc(*ev32, radii.to(f32), "kernel"),
        "float32 kernel coefficients, float64 spectrum":
            desc(*ev32, radii.to(f32), "kernel", f64),
        "float32 plain version on the card": desc(*ev32, radii.to(f32), "plain"),
        "float32 plain version on the CPU": desc(*cpu, radii.cpu().to(f32), "plain"),
    }
    X = {k: v.to(device) for k, v in X.items()}
    x32 = X["float32 kernel"].to(f64)
    X["float32 kernel, renormalised in float64"] = x32 / x32.norm(dim=1, keepdim=True)
    x64 = X["float64 kernel"]
    cfg64 = eng.make_config(system)
    with torch.no_grad():
        rv = _env_rvec_of(cfg64)
    mask = cfg64.nbr_mask & cfg64.atom_mask[:, None]
    P = {
        "float64 kernel": desc(rv, cfg64.nbr_sidx, mask, radii, "kernel"),
        "float32 kernel": desc(_env_rvec_of(cfg64, f32), cfg64.nbr_sidx, mask,
                               radii.to(f32), "kernel"),
    }
    lone = torch.zeros(cfg64.npad, dtype=torch.bool, device=device)
    amask = cfg64.atom_mask

    def energy(p, x, dtype):
        k = gram(p.to(dtype), cfg64.numbers, lone, x.to(dtype), ma.X_num,
                 ma.X_lone, eng.exponent)
        k = k * (amask[:, None] & mm[None, :])
        return float((k @ ma.mu.to(dtype)).sum())

    log("precision breakdown: energy error per atom of float64 predict "
        "with one stage in float32 (descriptor errors: max, rms over the "
        "live components of X; norm errors |x| - 1: rms, mean)")
    live = x64.abs() > 0
    for name, x in X.items():
        dx = (x.to(f64) - x64)[live]
        dn = x.to(f64).norm(dim=1) - 1
        err = (energy(P["float64 kernel"], x, f64) - e_ref) / n
        log(f"  X {name}: {err:+.3e} eV/atom; dX max {dx.abs().max():.2e} "
            f"rms {dx.pow(2).mean().sqrt():.2e}; norm rms "
            f"{dn.pow(2).mean().sqrt():.2e} mean {dn.mean():+.2e}")
    # the spread of that error over rounding patterns: X64 with a random
    # relative error of float32 rounding size (uniform in +-eps/2) per
    # component, eight draws
    g = torch.Generator(device=device).manual_seed(0)
    eps = torch.finfo(f32).eps
    draws = []
    for _ in range(8):
        u = torch.rand(x64.shape, generator=g, device=device, dtype=f64) - 0.5
        draws.append((energy(P["float64 kernel"], x64 * (1 + eps * u), f64)
                      - e_ref) / n)
    log(f"  X float64 with simulated float32 rounding, 8 draws: "
        f"{', '.join(f'{d:+.2e}' for d in draws)} eV/atom (rms "
        f"{float(np.sqrt(np.mean(np.square(draws)))):.2e})")
    err = (energy(P["float32 kernel"], x64, f64) - e_ref) / n
    log(f"  p float32 kernel (X float64): {err:+.3e} eV/atom")
    for name in ("float32 kernel", "float64 kernel, X rounded to float32"):
        err = (energy(P["float32 kernel"], X[name], f32) - e_ref) / n
        log(f"  p float32 kernel, X {name}, Gram and energy in float32: "
            f"{err:+.3e} eV/atom")


def _env_rvec_of(cfg, dtype=None):
    from autoforce_tpu_torch.engine import _env_rvec

    pos, cell = cfg.positions, cfg.cell
    if dtype is not None:
        pos, cell = pos.to(dtype), cell.to(dtype)
    return _env_rvec(pos, cell, cfg).contiguous()


def phase_md(model, card):
    """The main path: serving MD with the launch counters read around it.
    Returns (steps/s list, launches, NVE drift, MD-bucket kernel inputs)."""
    import numpy as np
    import torch

    from autoforce_tpu_torch import units
    from autoforce_tpu_torch.calculator.active import ActiveCalculator
    from autoforce_tpu_torch.descriptor import soap_kernels as sk
    from autoforce_tpu_torch.md.device_md import DeviceMD
    from autoforce_tpu_torch.system import maxwell_boltzmann_velocities
    from autoforce_tpu_torch.tools import soap_bench as sb

    sk.soap_coeff_fwd.launches = 0
    sk.soap_coeff_bwd.launches = 0
    calc = ActiveCalculator(covariance=MODEL, calculator=None, skin=SKIN,
                            logfile=None, pckl=None, tape=None)
    system = sb.bench_system()
    system.calc = calc
    maxwell_boltzmann_velocities(system, 300, seed=3)
    dyn = DeviceMD(system, calc, dt=2 * units.fs, temperature_K=300,
                   friction=0.02, chunk=100, check_beta=False)
    dyn.run(100)  # warm-up: first calls, neighbor bucket
    torch.cuda.synchronize()
    steps = 300
    rates = []
    for _ in range(3):
        t0 = time.time()
        dyn.run(steps)
        torch.cuda.synchronize()
        rates.append(steps / (time.time() - t0))
    launches = {"soap_coeff_fwd": sk.soap_coeff_fwd.launches,
                "soap_coeff_bwd": sk.soap_coeff_bwd.launches}
    T = system.get_temperature()
    pos = system.get_positions()
    log(f"Langevin MD: {len(system)} atoms, K bucket {calc.cfg.nbr_idx.shape[1]}, "
        f"100 + {3 * steps} steps, steps/s {', '.join(f'{r:.1f}' for r in rates)} "
        f"[{card}]; T = {T:.1f} K; launches {launches}")
    if not (np.isfinite(pos).all() and np.isfinite(T)):
        raise AssertionError("Langevin MD produced non-finite state")
    for name, c in launches.items():
        if c == 0:
            raise AssertionError(f"{name} never launched on the MD path")
    md_inputs = sb.kernel_inputs(calc.engine, system, kpad=calc.cfg.nbr_idx.shape[1],
                              cutoff=calc.engine.params.rc + SKIN)

    # NVE energy conservation (bench.accuracy_gate)
    s = sb.bench_system()
    maxwell_boltzmann_velocities(s, 300, seed=11)
    calc2 = ActiveCalculator(covariance=model, calculator=None, skin=SKIN,
                             logfile=None, pckl=None, tape=None)
    s.calc = calc2

    def etot():
        return s.get_potential_energy() + s.get_kinetic_energy()

    nve = DeviceMD(s, calc2, dt=2 * units.fs, chunk=500, check_beta=False,
                   thermostat="none")
    e0 = etot()
    t0 = time.time()
    nve.run(1000)
    torch.cuda.synchronize()
    t_nve = time.time() - t0
    e1 = etot()
    drift = abs(e1 - e0) / len(s)
    log(f"NVE: 1000 steps in {t_nve:.2f} s ({1000 / t_nve:.1f} steps/s) "
        f"[{card}]; drift {drift:.3e} eV/atom per 1k steps (bar 1e-3)")
    if not drift < 1e-3:
        raise AssertionError("NVE drift above the bar")
    return rates, launches, drift, md_inputs, dyn


def phase_drivers(card):
    """7. The structure drivers on the bench model at full width (the
    workloads of ``autoforce_tpu_torch.tools.driver_bench``): NVT with a
    Nose-Hoover chain, MTK NPT (isotropic, then flexible with a mask), the
    float32 strain gradient against float64, FIRE (fixed and variable
    cell) and NEB.  Each driver's launches are counted from 0 around its
    run, its first chunk runs under CUDA's sync debug mode, and the
    physical checks of each must hold.  Returns {driver: launches}."""
    import numpy as np
    import torch

    from autoforce_tpu_torch import units
    from autoforce_tpu_torch.md import device_md as dmd
    from autoforce_tpu_torch.md import device_npt as dnpt
    from autoforce_tpu_torch.opt import device_fire as dfire
    from autoforce_tpu_torch.opt import device_neb as dneb
    from autoforce_tpu_torch.opt.neb import interpolate_images
    from autoforce_tpu_torch.system import bulk_fcc, maxwell_boltzmann_velocities
    from autoforce_tpu_torch.tools import driver_bench as db
    from autoforce_tpu_torch.tools import soap_bench as sb

    t_phase = time.time()
    fs = units.fs
    paths = {}
    numbers = {}

    def check_probe(name, rec, per_eval=False):
        """Both kernels launched inside the chunks, the first chunk free of
        host syncs; returns launches per step (per band evaluation)."""
        if not rec["sync_checked"]:
            raise AssertionError(f"{name}: no chunk ran under the sync check")
        evals = rec["steps"] + (rec["calls"] if per_eval else 0)
        per = {k: rec[k] / max(evals, 1) for k in ("soap_coeff_fwd",
                                                    "soap_coeff_bwd")}
        for k, v in per.items():
            if rec[k] == 0:
                raise AssertionError(f"{name}: {k} never launched in a chunk")
        return per

    def profile(name, run, steps, wall_per_step):
        kps, us = db.profile_window(run, steps)
        if kps is None:
            log(f"{name} profile: no device time seen (not measured)")
            return None
        busy = us / (wall_per_step * 1e6)
        log(f"{name} profile over {steps} steps [{card}]: {kps:.0f} device "
            f"kernels per step, {us:.1f} us of device time per step, step "
            f"{wall_per_step * 1e6:.1f} us -> device busy {100 * busy:.1f}%")
        return dict(kernels_per_step=kps, device_us_per_step=us,
                    busy_share=busy)

    def close(name):
        got = db.launches()
        for k, c in got.items():
            if c == 0:
                raise AssertionError(f"{name}: {k} never launched")
        paths[name] = got

    # 7.1 NVT with the Nose-Hoover chain
    db.reset_launches()
    calc = db.serving_calc()
    s = sb.bench_system()
    s.calc = calc
    maxwell_boltzmann_velocities(s, 300, seed=3)
    dyn = dmd.DeviceMD(s, calc, 2 * fs, temperature_K=300, tdamp=50 * fs,
                       chunk=100, check_beta=False, thermostat="nhc")
    with db.chunk_probe(dmd, "md_chunk", 5) as rec:
        dyn.run(300)  # warm-up
    per = check_probe("nvt_nhc", rec)
    torch.cuda.synchronize()
    temps = []
    t0 = time.time()
    for _ in range(3):
        dyn.run(50)
        temps.append(s.get_temperature())
    rate = 150 / (time.time() - t0)
    close("nvt_nhc")
    t_mean = float(np.mean(temps))
    log(f"NVT-NHC [{card}]: {len(s)} atoms, {rate:.1f} steps/s over 150 steps "
        f"(chunk 100), mean T {t_mean:.1f} K (bar 300 +- 15%); kernel launches "
        f"per step {per}")
    if not abs(t_mean / 300 - 1) <= 0.15:
        raise AssertionError("NHC: mean temperature off by more than 15 %")
    prof = profile("NVT-NHC", lambda: dyn.run(20), 20, 1.0 / rate)
    # the chain half-step alone (two per NHC step, the particle and cell
    # chains stacked in NPT) and the flexible cell's batched expm_sym
    dev = calc.cfg.positions.device
    chain = (torch.full((), 3.0, device=dev), torch.zeros(3, device=dev),
             torch.zeros(3, device=dev), torch.ones(3, device=dev))
    strain = torch.zeros((2, 3, 3), device=dev)
    parts = {}
    for name, fn in (
            ("nhc_half", lambda: dmd._nhc_half(*chain, 0.0259, 3.0, 0.2)),
            ("expm_sym", lambda: dnpt.expm_sym(strain))):
        ms = sb.cuda_ms(fn, 200)
        kernels, _ = db.profile_window(fn, 1)
        parts[name] = dict(ms=ms, kernels=kernels)
        log(f"{name} [{card}]: {ms * 1e3:.1f} us per call (elapsed, "
            f"back to back), {kernels} device kernels per call")
    numbers["nvt_nhc"] = dict(steps_per_s=rate, mean_T=t_mean,
                              launches_per_step=per, profile=prof,
                              parts=parts)

    # 7.2 NPT: bench.py npt_1k (0 GPa) for the rate; the bench model's own
    # pressure on the snapshot is ~127 GPa (the JAX package gives the same:
    # its data hold no volume change), so at 0 GPa the barostat expands the
    # box, and the physical checks run at the snapshot's own pressure:
    # isotropic, then the flexible cell with a mask
    db.reset_launches()
    calc = db.serving_calc()
    s = sb.bench_system()
    s.calc = calc
    maxwell_boltzmann_velocities(s, 300, seed=3)
    p_model = float(-np.mean(s.get_stress()[:3]) / units.GPa)
    vol0 = s.volume
    kw = dict(temperature_K=300, tdamp=50 * fs, pdamp=500 * fs, chunk=100,
              check_beta=False)
    dyn = dnpt.DeviceNPT(s, calc, 2 * fs, pressure_GPa=0.0, isotropic=True,
                         **kw)
    with db.chunk_probe(dnpt, "md_chunk_npt", 6) as rec:
        dyn.run(150)  # warm-up
    per = check_probe("npt", rec)
    torch.cuda.synchronize()
    t0 = time.time()
    dyn.run(150)
    rate = 150 / (time.time() - t0)
    prof = profile("NPT", lambda: dyn.run(20), 20, 1.0 / rate)
    dvol_0 = s.volume / vol0 - 1
    ok_0 = np.isfinite(s.positions).all() and np.isfinite(s.cell).all()
    s = sb.bench_system()
    s.calc = calc
    maxwell_boltzmann_velocities(s, 300, seed=3)
    held = dnpt.DeviceNPT(s, calc, 2 * fs, pressure_GPa=p_model,
                          isotropic=True, **kw)
    held.run(50)  # warm-up
    torch.cuda.synchronize()
    before = db.launches()["soap_coeff_fwd"]
    t0 = time.time()
    held.run(100)
    rate_held = 100 / (time.time() - t0)
    held_per = (db.launches()["soap_coeff_fwd"] - before) / 100
    dvol_iso = s.volume / vol0 - 1
    cell_iso = np.asarray(s.cell).copy()
    flex = dnpt.DeviceNPT(s, calc, 2 * fs, pressure_GPa=p_model,
                          isotropic=False, mask=(1, 1, 0), **kw)
    t0 = time.time()
    flex.run(100)
    rate_flex = 100 / (time.time() - t0)
    close("npt")
    cell = np.asarray(s.cell)
    dvol = s.volume / vol0 - 1
    moved = float(np.abs(cell[2] - cell_iso[2]).max()
                  + np.abs(cell[:, 2] - cell_iso[:, 2]).max())
    log(f"NPT [{card}]: npt_1k (0 GPa) {rate:.1f} steps/s over 150 steps, "
        f"volume {100 * dvol_0:+.2f} % after 320 steps (the model's pressure "
        f"on the snapshot is {p_model:.2f} GPa: at 0 GPa the box expands and "
        f"rebuilds its tables in the loop, {per['soap_coeff_fwd']:.3f} forward "
        f"launches per warm-up step); at that pressure: isotropic "
        f"{rate_held:.1f} steps/s over steps 50-150 ({held_per:.3f} forward "
        f"launches per step), volume {100 * dvol_iso:+.3f} %, then flexible (mask "
        f"1,1,0) {rate_flex:.1f} steps/s over 100 steps, volume "
        f"{100 * dvol:+.3f} % of the start (bar 5 %), masked strain moved "
        f"{moved:.2e} A; kernel launches per step {per}")
    if not (ok_0 and np.isfinite(s.positions).all()
            and np.isfinite(cell).all()):
        raise AssertionError("NPT produced a non-finite state")
    if not (abs(dvol_iso) <= 0.05 and abs(dvol) <= 0.05):
        raise AssertionError("NPT: volume moved by more than 5 %")
    if not moved <= 1e-6:
        raise AssertionError("NPT: a masked strain component moved")
    numbers["npt"] = dict(steps_per_s=rate, held_steps_per_s=rate_held,
                          held_fwd_launches_per_step=held_per,
                          flex_steps_per_s=rate_flex,
                          volume_change_0GPa=dvol_0, model_pressure=p_model,
                          volume_change=dvol, launches_per_step=per,
                          profile=prof)

    # 7.3 the strain gradient in float32 (kernels) against float64 (plain)
    err, scale, d64 = db.stress_rel_err(db.serving_calc(), sb.bench_system())
    log(f"stress: dE/deps float32 (kernels) vs float64 (plain) on the "
        f"snapshot: max abs err {err:.3e} eV, largest |dE/deps| {scale:.3e} "
        f"eV, relative {err / scale:.3e} (tol {db.STRESS_REL_TOL:g}); "
        f"float64 dE/deps diagonal {np.diag(d64)}")
    if not err <= db.STRESS_REL_TOL * scale:
        raise AssertionError("float32 strain gradient off its tolerance")
    numbers["stress_rel_err"] = err / scale

    # 7.4 FIRE (bench.py relax_fire_1k), then the variable cell
    db.reset_launches()
    calc = db.serving_calc()
    s = sb.bench_system()
    s.calc = calc
    opt = dfire.DeviceFIRE(s, calc, dt=0.05, chunk=150, check_beta=False)
    with db.chunk_probe(dfire, "fire_chunk", 9) as rec:
        opt.run(fmax=1e-12, steps=150)  # warm-up
    per = check_probe("fire", rec)
    torch.cuda.synchronize()
    t0 = time.time()
    opt.run(fmax=1e-12, steps=150)
    rate = 150 / (time.time() - t0)
    prof = profile("FIRE", lambda: opt.run(fmax=1e-12, steps=20), 20,
                   1.0 / rate)
    close("fire")
    db.reset_launches()
    s = bulk_fcc("Cu", 3.65).repeat(sb.REPS_MD)
    s.rattle(0.05, seed=1)
    s.calc = calc
    e0 = s.get_potential_energy()
    copt = dfire.DeviceFIRE(s, calc, chunk=150, check_beta=False, cell=True)
    t0 = time.time()
    with db.chunk_probe(dfire, "fire_cell_chunk", 11) as crec:
        conv = copt.run(fmax=0.05, steps=500)
    wall = time.time() - t0
    check_probe("fire_cell", crec)
    close("fire_cell")
    e1 = s.get_potential_energy()
    a_final = float(np.cbrt(s.volume / np.prod(sb.REPS_MD)))
    log(f"FIRE [{card}]: {rate:.1f} iterations/s over 150 (chunk 150), "
        f"kernel launches per iteration {per}; variable cell from a = 3.65 "
        f"A: {copt.nsteps} iterations in {wall:.2f} s, converged {conv}, "
        f"final fmax {copt.fmax:.4f} eV/A, final a {a_final:.5f} A, energy "
        f"{e0:.4f} -> {e1:.4f} eV")
    if not e1 < e0:
        raise AssertionError("variable-cell FIRE: the energy did not drop")
    numbers["fire"] = dict(iters_per_s=rate, launches_per_iter=per,
                           profile=prof, cell_iters=copt.nsteps,
                           cell_fmax=copt.fmax, cell_a=a_final,
                           cell_e=(e0, e1))

    # 7.5 NEB: a vacancy hop, relaxed end points (counted as a path of
    # their own), five interior images
    db.reset_launches()
    calc = db.serving_calc()
    ends = db.vacancy_hop()
    for im in ends:
        im.calc = calc
        dfire.DeviceFIRE(im, calc, chunk=150, check_beta=False).run(
            fmax=0.05, steps=1000)
    close("neb_ends")
    images = interpolate_images(ends[0], ends[1], 7)
    for im in images:
        im.calc = calc
    band = dneb.DeviceNEB(images, calc, k=0.1, climb=True, dt=0.05,
                          maxstep=0.1, chunk=50, check_beta=False)
    torch.cuda.synchronize()
    db.reset_launches()
    t0 = time.time()
    with db.chunk_probe(dneb, "neb_chunk", 9) as rec:
        conv = band.run(fmax=0.05, steps=300)
    wall = time.time() - t0
    per = check_probe("neb", rec, per_eval=True)
    close("neb")
    barrier = band.barrier()
    evals = rec["steps"] + rec["calls"]
    log(f"NEB [{card}]: {len(images[0])} atoms x {len(images) - 2} moving "
        f"images, {band.nsteps} iterations ({evals} band evaluations) in "
        f"{wall:.2f} s: {evals / wall:.1f} band evaluations/s ("
        f"{evals / rec['wall']:.1f} inside the chunks, {rec['calls']} "
        f"chunks), converged {conv}, final fmax {band.fmax:.4f} eV/A, "
        f"barrier {barrier:.4f} eV; kernel launches per band evaluation "
        f"{per}")
    if not (np.isfinite(barrier) and barrier > 0):
        raise AssertionError("NEB: the barrier is not finite and positive")
    if any(v != 1 for v in per.values()):
        raise AssertionError("NEB: not one launch of each kernel per band "
                             "evaluation")
    # the band as the chunks stack it: float32 through the kernels against
    # each image alone in float64 through the plain versions
    de, e_scale, df, f_scale, f_net, band_rows = db.band_rel_err(band)
    log(f"NEB band, {band_rows[0].shape[0]} stacked rows, K = "
        f"{band_rows[0].shape[1]}: float32 (kernels) vs each image alone in "
        f"float64 (plain): energy max abs err {de:.3e} eV, relative to the "
        f"largest |E| {e_scale:.3e} eV: {de / e_scale:.3e} (tol "
        f"{db.BAND_E_TOL:g}); forces max abs err {df:.3e} eV/A, relative to "
        f"the largest slot term {f_scale:.3e} eV/A: {df / f_scale:.3e} (tol "
        f"{db.BAND_F_TOL:g}; relative to the largest net |f| {f_net:.3e} "
        f"eV/A: {df / f_net:.3e}, not held)")
    if not (de <= db.BAND_E_TOL * e_scale and df <= db.BAND_F_TOL * f_scale):
        raise AssertionError("NEB band: float32 stacked evaluation disagrees "
                             "with float64 per image")
    numbers["neb"] = dict(evals_per_s=evals / wall,
                          evals_per_s_in_chunks=evals / rec["wall"],
                          iterations=band.nsteps,
                          fmax=band.fmax, barrier=barrier,
                          launches_per_eval=per, band_e_rel_err=de / e_scale,
                          band_f_rel_err=df / f_scale,
                          band_f_rel_err_net=df / f_net)

    # 7.6 NEB with a cell per image: the relaxed hop with the last end
    # point's cell stretched by 1 % along x, the images' cells and
    # fractional coordinates interpolated between the ends
    t0 = time.time()
    images = db.strained_band(ends[0], ends[1], 7)
    for im in images:
        im.calc = calc
    cband = dneb.DeviceNEB(images, calc, k=0.1, climb=True, dt=0.05,
                           maxstep=0.1, chunk=50, check_beta=False)
    torch.cuda.synchronize()
    db.reset_launches()
    with db.evaluation_probe(dneb, "band_forces") as ev, \
            db.chunk_probe(dneb, "neb_chunk", 9) as rec:
        conv = cband.run(fmax=0.05, steps=50)
    check_probe("neb_cell", rec, per_eval=True)
    close("neb_cell")
    es = np.array([im.get_potential_energy() for im in images])
    evals = ev["calls"]
    log(f"NEB, a cell per image [{card}]: cell x from "
        f"{images[0].cell[0, 0]:.4f} to {images[-1].cell[0, 0]:.4f} A, "
        f"{cband.nsteps} iterations ({evals} band evaluations) in "
        f"{time.time() - t0:.2f} s, converged {conv}, final fmax "
        f"{cband.fmax:.4f} eV/A, energies {es[0]:.4f} .. {es.max():.4f} eV; "
        f"band evaluations without one launch of each kernel: {ev['off']}")
    if not np.isfinite(es).all():
        raise AssertionError("NEB with a cell per image: non-finite energies")
    if ev["off"]:
        raise AssertionError("NEB with a cell per image: not one launch of "
                             "each kernel per band evaluation")
    de, e_scale, df, f_scale, f_net, _ = db.band_rel_err(cband)
    log(f"NEB band with a cell per image: float32 (kernels) vs each image "
        f"alone in float64 (plain): energy {de / e_scale:.3e} of the largest "
        f"|E| (tol {db.BAND_E_TOL:g}), forces {df / f_scale:.3e} of the "
        f"largest slot term {f_scale:.4g} eV/A (tol {db.BAND_F_TOL:g}; "
        f"{df / f_net:.3e} of the largest net |f| {f_net:.4g} eV/A, not held)")
    if not (de <= db.BAND_E_TOL * e_scale and df <= db.BAND_F_TOL * f_scale):
        raise AssertionError("NEB band with a cell per image: float32 stacked "
                             "evaluation disagrees with float64 per image")
    numbers["neb_cell"] = dict(iterations=cband.nsteps, fmax=cband.fmax,
                               wall_s=time.time() - t0, evaluations=evals,
                               band_e_rel_err=de / e_scale,
                               band_f_rel_err=df / f_scale,
                               band_f_rel_err_net=df / f_net)
    log(f"phase 7 took {time.time() - t_phase:.1f} s")
    print(json.dumps({"drivers": numbers}))
    return paths, (calc.engine.params, band_rows)


def _launch_counts():
    from autoforce_tpu_torch.descriptor import soap_kernels as sk

    return {"soap_coeff_fwd": sk.soap_coeff_fwd.launches,
            "soap_coeff_bwd": sk.soap_coeff_bwd.launches}


def _reset_launches():
    from autoforce_tpu_torch.descriptor import soap_kernels as sk

    sk.soap_coeff_fwd.launches = 0
    sk.soap_coeff_bwd.launches = 0


def phase_otf(card):
    """The OTF learning path with the launch counters read around each
    stage, and a host profile (cProfile) of the growth stage; the run's
    active.log is kept as ``OTF_LOG``.  Returns (numbers, calculator,
    launches while learning)."""
    import cProfile
    import io
    import pstats

    import torch

    from autoforce_tpu_torch.tools import otf_bench as ob

    by_stage = {}
    current = []
    prof = cProfile.Profile()

    def on_stage(name):
        if current:
            by_stage[current[-1]] = _launch_counts()
        if name == "grow":
            prof.enable()
        elif current and current[-1] == "grow":
            prof.disable()
        current.append(name)
        _reset_launches()

    out, calc = ob.measure_otf(device="cuda", dtype=torch.float32,
                               on_stage=on_stage, keep_log=OTF_LOG,
                               **OTF_CAPS)
    torch.cuda.synchronize()
    by_stage[current[-1]] = _launch_counts()
    learning = {k: by_stage["grow"][k] + by_stage["prod"][k]
                for k in by_stage["grow"]}
    g = out["grow"]
    log(f"OTF [{card}]: {out['natoms']} atoms, {out['nspecies']} species; "
        f"growth {g['steps']} steps in {g['wall_s']:.1f} s, ended by "
        f"{g['exit']} at m = {g['m_at_exit']} ({g['fp_calls']} oracle calls, "
        f"{g['updates']} updates); production {out['prod_steps']} steps in "
        f"{out['prod_wall_s']:.1f} s, ended by {out['prod_exit']}, adding "
        f"{out['prod_added_inducing']} inducing environments")
    log(f"OTF [{card}]: steps/s including learning "
        f"{out['steps_per_sec_incl_learning']:.4f}, frozen "
        f"{out['frozen_steps_per_sec']:.4f} (over {out['frozen_steps']} steps), "
        f"ratio "
        f"{out['learning_overhead_x']:.2f}; fp_calls {out['fp_calls']}, "
        f"updates {out['updates']} (production: {out['prod_fp_calls']}, "
        f"{out['prod_updates']}); final (ndata, m) = ({out['final_ndata']}, "
        f"{out['final_m']}); mcap growths {out['mcap_growth']}, kpad growths "
        f"{out['kpad_growth']}")
    fr = out["prod_wall_fracs"]
    log("OTF production wall by phase_wall: " + ", ".join(
        f"{k} {v:.4f}" for k, v in fr.items()))
    text = io.StringIO()
    pstats.Stats(prof, stream=text).sort_stats("tottime").print_stats(14)
    log("OTF growth stage, host profile (cProfile, self time):")
    for line in text.getvalue().splitlines():
        if line.strip() and not line.startswith(("   Ordered", "   List")):
            log("  " + line.rstrip()[:150])
    log(f"OTF accuracy: force MAE vs the oracle {out['f_mae_vs_oracle']:.5f} "
        f"eV/A (bar 0.15), energy error {out['e_err_per_atom_vs_oracle']:.3e} "
        f"eV/atom; launches by stage {by_stage}")
    if not out["positions_finite"]:
        raise AssertionError("OTF MD produced non-finite positions")
    if not out["f_mae_vs_oracle"] <= ob.OTF_F_MAE_BOUND:
        raise AssertionError("OTF force MAE above the 0.15 eV/A bar")
    log(f"OTF production added {out['prod_added_inducing']} inducing "
        f"environments (floor {OTF_PROD_FLOOR}, OTF_PROD_FLOOR) [{card}]")
    if not out["prod_added_inducing"] >= OTF_PROD_FLOOR:
        raise AssertionError("OTF production added fewer inducing "
                             f"environments than {OTF_PROD_FLOOR}")
    for name, c in learning.items():
        if c == 0:
            raise AssertionError(f"{name} never launched while learning")
    print(json.dumps({"otf": out}))
    return out, calc, learning


def phase_otf_columns(calc, card):
    """On the learned model: kernel_block float32 (kernels) against float64
    (plain versions), and the device time per call of kernel_block and
    kernel_cols_multi at the flagship shapes.  Returns the kernel inputs of
    the learning path (staging rows, a data record's rows)."""
    import torch

    from autoforce_tpu_torch.engine import _env_rvec, kernel_block_fn
    from autoforce_tpu_torch.tools import driver_bench as db
    from autoforce_tpu_torch.tools import soap_bench as sb

    model, eng = calc.model, calc.engine
    ma = model.full_model_arrays()
    rec = model.data[-1]
    cfg = rec.cfg
    n = rec.natoms
    ke, kf, kv = eng.kernel_block(cfg, ma, method="vjp")
    f64 = torch.float64
    cfg64 = cfg._replace(positions=cfg.positions.to(f64), cell=cfg.cell.to(f64))
    with db.plain_kernels():
        ke64, kf64, kv64 = kernel_block_fn(cfg64, ma, eng.radii_table().to(f64),
                                           eng.params, eng.exponent)
    torch.cuda.synchronize()
    errs = {}
    for name, a, b, tol in (("Ke", ke, ke64, KB_KE_TOL), ("Kf", kf[:n], kf64[:n], KB_KF_TOL),
                            ("Kv", kv, kv64, KB_KF_TOL)):
        scale = b.abs().max().item()
        err = (a.to(f64) - b).abs().max().item()
        errs[name] = err / scale
        log(f"kernel_block float32 (kernels) vs float64 (plain), record of "
            f"{n} atoms, m = {model.m}: {name} max abs err {err:.3e}, relative "
            f"to the largest |{name}| {scale:.3e}: {err / scale:.3e} (tol {tol:g})")
        if not err <= tol * scale:
            raise AssertionError(f"kernel_block {name}: float32 disagrees")

    # device time per call at the flagship shapes
    same = [r.cfg for r in model.data
            if r.cfg.positions.shape == cfg.positions.shape
            and r.cfg.nbr_idx.shape == cfg.nbr_idx.shape][:4]
    xs = ma.X_desc[:8]
    nums = ma.X_num[:8].cpu().numpy()
    lones = ma.X_lone[:8]

    def block():
        return eng.kernel_block(cfg, ma, method="vjp")

    def cols():
        return eng.kernel_cols_multi(same, xs, nums, lones)

    timings = {}
    for name, fn, shape in (
            ("kernel_block", block, f"N={cfg.npad} K={cfg.nbr_idx.shape[1]} "
                                    f"m={model.m} (64 columns per backward launch)"),
            ("kernel_cols_multi", cols, f"8 envs x {len(same)} records of "
                                        f"N={cfg.npad} K={cfg.nbr_idx.shape[1]}")):
        _reset_launches()
        fn()
        torch.cuda.synchronize()
        per_call = _launch_counts()
        dev = sb.device_ms(fn, 5)
        soap = sb.device_ms(fn, 5, "soap_")
        wall = sb.cuda_ms(fn, 5)
        timings[name] = {"shape": shape, "device_ms": dev, "soap_kernels_ms": soap,
                         "call_ms": wall, "launches_per_call": per_call}
        log(f"{name} [{card}]: {shape}: device {dev} ms per call, of which "
            f"the two SOAP kernels {soap} ms; elapsed {wall:.3f} ms per call; "
            f"kernel launches per call {per_call}")

    envs = eng.make_envs([(x.rvec, x.numbers) for x in model.X[:256]],
                         dtype=eng.model_dtype)
    staging = (envs.rvec.contiguous(), envs.sidx, envs.mask,
               eng.radii_table().to(eng.model_dtype))
    with torch.no_grad():
        rvec = _env_rvec(cfg.positions, cfg.cell, cfg).contiguous()
    record = (rvec, cfg.nbr_sidx, cfg.nbr_mask & cfg.atom_mask[:, None],
              eng.radii_table())
    return errs, timings, {"otf_staging": (eng.params, staging),
                           "otf_record": (eng.params, record)}


def phase_jacobian(calc, card):
    """8a. The Jacobian route of kernel_block on the learned flagship
    model: against the column route and float64 plain, device time per
    call of both routes, launches per Jacobian call.  Returns (errors,
    timings, launches of one Jacobian call, the one-hot launch's rows)."""
    import numpy as np
    import torch

    from autoforce_tpu_torch.engine import _env_rvec, kernel_block_fn
    from autoforce_tpu_torch.tools import driver_bench as db
    from autoforce_tpu_torch.tools import soap_bench as sb

    model, eng = calc.model, calc.engine
    ma = model.full_model_arrays()
    rec = model.data[-1]
    cfg, n = rec.cfg, rec.natoms
    _reset_launches()
    jac = eng.kernel_block(cfg, ma, method="jac")
    torch.cuda.synchronize()
    per_call = _launch_counts()
    if per_call != {"soap_coeff_fwd": 1, "soap_coeff_bwd": 1}:
        raise AssertionError(f"Jacobian route launches {per_call}, not 1 + 1")
    vjp = eng.kernel_block(cfg, ma, method="vjp")
    f64 = torch.float64
    cfg64 = cfg._replace(positions=cfg.positions.to(f64), cell=cfg.cell.to(f64))
    with db.plain_kernels():
        ref = kernel_block_fn(cfg64, ma, eng.radii_table().to(f64), eng.params,
                              eng.exponent)
    torch.cuda.synchronize()
    errs = {}
    for name, a, b, c, tol in (
            ("Ke", jac[0], vjp[0], ref[0], JAC_KE_TOL),
            ("Kf", jac[1][:n], vjp[1][:n], ref[1][:n], JAC_KF_TOL),
            ("Kv", jac[2], vjp[2], ref[2], JAC_KF_TOL)):
        scale = c.abs().max().item()
        e_ref = (a.to(f64) - c).abs().max().item() / scale
        e_col = (a.to(f64) - b.to(f64)).abs().max().item() / scale
        errs[name] = {"vs_float64_plain": e_ref, "vs_column_route": e_col}
        log(f"kernel_block Jacobian route float32, record of {n} atoms, m = "
            f"{model.m}: {name} relative to the largest |{name}| {scale:.3e}: "
            f"vs float64 plain {e_ref:.3e}, vs the float32 column route "
            f"{e_col:.3e} (tol {tol:g})")
        if not (e_ref <= tol and e_col <= tol):
            raise AssertionError(f"kernel_block Jacobian route {name} disagrees")
    # device time per call of the Jacobian route on the learned model (the
    # column route's is phase 5's), and of both routes at m = 1024 (the
    # flagship's max_inducing): the learned inducing rows repeated up to
    # 1024 live columns (the time depends on their count)
    X = model.X
    idx = np.arange(1024) % len(X)
    ma1024 = eng.model_arrays(np.stack([X[i].desc for i in idx]),
                              np.array([X[i].number for i in idx], np.int32),
                              np.array([X[i].lone for i in idx]),
                              np.zeros(1024), np.zeros((1024, 1024)), mcap=1024)
    timings = {}
    for name, m_label, mas in (("jac", model.m, ma), ("jac", 1024, ma1024),
                               ("vjp", 1024, ma1024)):
        def fn(name=name, mas=mas):
            return eng.kernel_block(cfg, mas, method=name)

        t = {"device_ms": sb.device_ms(fn, 5),
             "soap_kernels_ms": sb.device_ms(fn, 5, "soap_"),
             "call_ms": sb.cuda_ms(fn, 5)}
        timings[f"{name}_m{m_label}"] = t
        log(f"kernel_block {'Jacobian' if name == 'jac' else 'column'} "
            f"route at m = {m_label}, N = {cfg.npad}, K = "
            f"{cfg.nbr_idx.shape[1]} [{card}]: device {t['device_ms']} ms "
            f"per call (SOAP kernels {t['soap_kernels_ms']} ms), elapsed "
            f"{t['call_ms']:.3f} ms")
    L = eng.params.lmax + 1
    reps = 2 * (eng.params.nmax + 1) * L * L
    with torch.no_grad():
        rvec = _env_rvec(cfg.positions, cfg.cell, cfg)
    mask = cfg.nbr_mask & cfg.atom_mask[:, None]
    rows = (rvec.repeat(reps, 1, 1).contiguous(), cfg.nbr_sidx.repeat(reps, 1),
            mask.repeat(reps, 1), eng.radii_table())
    return errs, timings, per_call, (eng.params, rows)


def phase_kernel_space(card):
    """8b-d. Learning with a trainable kernel expression and kernel HPO,
    the force-aware LML on the card against the CPU, and the alchemical
    mixing with a pair term through growth and frozen MD.  Returns
    ({path: launches}, numbers)."""
    import numpy as np
    import torch

    from autoforce_tpu_torch.kernelalgebra import from_state, softplus
    from autoforce_tpu_torch.pairkernels import PairTerm
    from autoforce_tpu_torch.tools import kernelspace_bench as ksb

    t_phase = time.time()
    paths, numbers = {}, {}

    def close(name):
        got = _launch_counts()
        for k, c in got.items():
            if c == 0:
                raise AssertionError(f"{name}: {k} never launched")
        paths[name] = got

    # (b) learning with kernel HPO, the energy objective (3,073-row records
    # exceed the force-aware LML's ef_row_cap = 400)
    cap = ksb.lml_record_cap(1024)
    from autoforce_tpu_torch.regression.hpo import energy_lml_bytes

    log(f"kernel HPO record cap: {cap} records of 1024 atoms "
        f"({energy_lml_bytes(cap, 1024) / 1e9:.2f} GB of energy-LML tensors, "
        f"cap {ksb.LML_BYTES_CAP / 1e9:.0f} GB)")
    eng = ksb.flagship_engine(dtype=torch.float32,
                              kernel=from_state(ksb.GAMMA_EXPR))
    out, calc, s = ksb.learn(eng, wall_cap=KS_CAPS["hpo_wall_cap"],
                             record_cap=cap, kernel_hpo=1,
                             on_start=_reset_launches)
    torch.cuda.synchronize()
    close("expr_hpo")
    g = float(softplus(np.asarray(eng.kernel_kind.params())[0], np))
    log(f"kernel HPO learning [{card}]: {out['steps']} steps in "
        f"{out['wall_s']:.1f} s, ended by {out['exit']}; (ndata, m) = "
        f"({out['ndata']}, {out['m']}); HPO runs {out['kernel_hpo_runs']}, "
        f"moved {out['kernel_hpo_moved']}; g 0.5 -> {g:.6g} "
        f"({eng.kernel_kind.state}); force MAE vs the oracle "
        f"{out['f_mae_vs_oracle']:.5f} eV/A (not held to the dot kernel's "
        f"0.15 bar); launches {paths['expr_hpo']}")
    if out["kernel_hpo_runs"] < 1:
        raise AssertionError("kernel HPO never ran")
    if not (out["forces_finite"] and out["positions_finite"]):
        raise AssertionError("kernel HPO learning produced non-finite forces")
    numbers["expr_hpo"] = dict(out, g=g, record_cap=cap)
    del calc, s

    # (c) the force-aware LML, card (kernels) against CPU (plain versions)
    _reset_launches()
    eng_c, recs = ksb.ef_lml_records("cuda")
    t0 = time.time()
    v, grad, rows = ksb.ef_lml_value(eng_c, recs)
    torch.cuda.synchronize()
    t_card = time.time() - t0
    close("ef_lml")
    eng_h, recs_h = ksb.ef_lml_records("cpu")
    t0 = time.time()
    v0, grad0, _ = ksb.ef_lml_value(eng_h, recs_h)
    t_cpu = time.time() - t0
    e_v = abs(v - v0) / abs(v0)
    e_g = float(np.abs(grad - grad0).max() / np.abs(grad0).max())
    log(f"force-aware LML, {len(recs)} records, {rows} rows [{card}]: value "
        f"{v:.12g} (CPU {v0:.12g}), relative error {e_v:.3e}; gradient "
        f"relative error {e_g:.3e} (tol 1e-9); {t_card:.2f} s on the card, "
        f"{t_cpu:.2f} s on the CPU; launches {paths['ef_lml']}")
    if not (e_v <= 1e-9 and e_g <= 1e-9):
        raise AssertionError("force-aware LML disagrees between card and CPU")
    numbers["ef_lml"] = dict(rows=rows, value_rel_err=e_v, grad_rel_err=e_g,
                             card_s=t_card, cpu_s=t_cpu)

    # (d) alchemical mixing and a Li-S pair term
    eng_d = ksb.flagship_engine(dtype=torch.float32, chemical="rbf",
                                pair_terms=(PairTerm(a=3, b=16, rc=6.0),))
    out_d, calc_d, s_d = ksb.learn(eng_d, wall_cap=KS_CAPS["chem_wall_cap"],
                                   on_start=_reset_launches)
    torch.cuda.synchronize()
    learn_l = _launch_counts()
    if not (out_d["forces_finite"] and out_d["positions_finite"]):
        raise AssertionError("chemical + pair learning produced non-finite forces")
    if out_d["m"] < 100:
        raise AssertionError("chemical + pair growth ended below m = 100")
    # float32 through the kernels against float64 through the plain
    # versions, held to the chip-independent bars of bench.py:412 (energy
    # 2e-4 eV/atom, forces 1e-2 eV/A) as phase 3 holds the dot kernel
    e_err, e_abs, f_err, f_abs, _ = ksb.predict_rel_err(calc_d, s_d)
    nat = len(s_d)
    log(f"chemical + pair learning [{card}]: {out_d['steps']} steps in "
        f"{out_d['wall_s']:.1f} s, ended by {out_d['exit']}; (ndata, m) = "
        f"({out_d['ndata']}, {out_d['m']}), pair bucket {eng_d.pair_kx}; "
        f"{out_d['updates']} updates, the last {out_d['last_update_s']:.1f} "
        f"s, {out_d['updates_refused']} refused at the cap; force "
        f"MAE vs the oracle {out_d['f_mae_vs_oracle']:.5f} eV/A; float32 vs "
        f"float64 plain predict: energy {e_err / nat:.3e} eV/atom (|E| "
        f"{e_abs:.4g}, bar 2e-4), largest force error {f_err:.3e} eV/A "
        f"(largest |f| {f_abs:.4g}, bar 1e-2)")
    if not (e_err / nat < 2e-4 and f_err < 1e-2):
        raise AssertionError("chemical + pair predict misses the float32 bars")
    _reset_launches()
    rate, rec = ksb.frozen_rate(calc_d, s_d, steps=KS_CAPS["frozen_steps"],
                                warmup=KS_CAPS["frozen_warmup"])
    if not rec["sync_checked"]:
        raise AssertionError("chemical + pair MD: no chunk ran under the sync check")
    md_l = _launch_counts()
    paths["chem_pair"] = {k: learn_l[k] + md_l[k] for k in learn_l}
    for k, c in paths["chem_pair"].items():
        if learn_l[k] == 0 or md_l[k] == 0:
            raise AssertionError(f"chem_pair: {k} never launched")
    log(f"chemical + pair frozen DeviceMD [{card}]: {rate:.2f} steps/s over "
        f"{KS_CAPS['frozen_steps']} steps (first chunk sync-checked); "
        f"launches learning {learn_l}, MD {md_l}")
    numbers["chem_pair"] = dict(out_d, frozen_steps_per_sec=rate,
                                e_err_per_atom=e_err / nat, f_err_max=f_err)
    log(f"phase 8 (b-d) took {time.time() - t_phase:.1f} s")
    return paths, numbers


def phase_committee(folder, card):
    """9. A Bayesian committee on phase 5's learned flagship model, found
    as ``bcm_1.pckl`` in ``folder`` by ``BCMActiveCalculator``'s restart:
    (a) growth under DeviceMD (the first update freezes the flagship
    model as expert 1); (b) frozen committee MD; (c) the device committee
    in float32 against the host committee in float64 through the plain
    versions; (d) NPT, (e) FIRE and (f) NEB on the committee.  Every
    check prints its name, value and bound before it asserts.  Returns
    ({path: launches}, numbers, the NEB band's stacked kernel inputs)."""
    import numpy as np
    import torch

    from autoforce_tpu_torch import units
    from autoforce_tpu_torch.md import device_md as dmd
    from autoforce_tpu_torch.md import device_npt as dnpt
    from autoforce_tpu_torch.opt import device_fire as dfire
    from autoforce_tpu_torch.opt import device_neb as dneb
    from autoforce_tpu_torch.opt.neb import interpolate_images
    from autoforce_tpu_torch.system import maxwell_boltzmann_velocities
    from autoforce_tpu_torch.tools import bcm_bench as bb
    from autoforce_tpu_torch.tools import driver_bench as db
    from autoforce_tpu_torch.tools.otf_bench import make_lgps_system

    t_phase = time.time()
    fs = units.fs
    T = bb.TEMPERATURE_K
    paths, numbers = {}, {}

    def check(name, value, bound, ok):
        log(f"check {name}: {value} (bound {bound})")
        if not ok:
            raise AssertionError(f"committee: {name} = {value} misses {bound}")

    def close(name):
        got = db.launches()
        check(f"{name} launched both kernels", got, "each > 0",
              all(c > 0 for c in got.values()))
        paths[name] = got
        return got

    # (a) restart and spawn, then growth
    cap = BCM_CAPS["max_inducing"]
    calc = bb.committee(folder, max_inducing=cap,
                        max_data=BCM_CAPS["max_data"], dtype=torch.float32)
    check("restart: the live model is phase 5's, (ndata, m)", calc.size,
          f"m > {cap}, no expert yet", calc.size[1] > cap and not calc.experts)
    s = make_lgps_system()
    db.reset_launches()
    g = bb.grow(calc, s, wall_cap=BCM_CAPS["grow_wall_cap"])
    torch.cuda.synchronize()
    close("bcm_grow")
    log(f"committee growth [{card}]: {g['steps']} steps in "
        f"{g['wall_s']:.1f} s; "
        f"{g['experts']} frozen experts, {g['served']} models served; sizes "
        f"(ndata, m) of the experts and the live model {g['sizes']}; "
        f"fp_calls {g['fp_calls']}, updates {g['updates']}")
    check("experts frozen during the growth stage", g["frozen_in_stage"],
          ">= 1", g["frozen_in_stage"] >= 1)
    check("models the committee serves", g["served"], ">= 2",
          g["served"] >= 2)
    check("positions finite after growth", g["positions_finite"], "True",
          g["positions_finite"])
    forces_ok = bool(np.isfinite(calc.results["forces"]).all())
    check("forces finite after growth", forces_ok, "True", forces_ok)
    numbers["grow"] = g

    # (b) frozen committee MD
    calc._calc = None
    s2 = s.copy()
    s2.calc = calc
    maxwell_boltzmann_velocities(s2, T, seed=15)
    dyn = dmd.DeviceMD(s2, calc, dt=2 * fs, temperature_K=T, friction=0.05,
                       chunk=bb.CHUNK, check_beta=False)
    steps = BCM_CAPS["md_steps"]
    db.reset_launches()
    with db.evaluation_probe(dmd, "_sgpr_forces") as ev, \
            db.chunk_probe(dmd, "md_chunk", 5) as rec:
        dyn.run(bb.CHUNK)  # its first chunk sync-checked
        torch.cuda.synchronize()
        t0 = time.time()
        dyn.run(steps - bb.CHUNK)
        torch.cuda.synchronize()
        rate = (steps - bb.CHUNK) / (time.time() - t0)
    got = close("bcm_md")
    check("committee MD: a chunk ran under the sync check",
          rec["sync_checked"], "True", rec["sync_checked"])
    nexp = len(dmd.committee_models(calc))
    log(f"committee MD [{card}]: {nexp} models, {rec['steps']} steps in "
        f"{rec['calls']} chunks, {rate:.2f} steps/s over the last "
        f"{steps - bb.CHUNK}; {ev['calls']} committee evaluations (one per "
        f"step, chunk start and in-loop rebuild, and the steps issued ahead "
        f"of a chunk's stop); launches {got}")
    check("committee MD steps", rec["steps"], f"== {steps}",
          rec["steps"] == steps)
    check("committee MD evaluations that did not launch each kernel once",
          f"{ev['off']} of {ev['calls']}", "0", ev["off"] == 0)
    prof = db.profile_window(lambda: dyn.run(20), 20)
    busy = None if prof[0] is None else prof[1] / (1e6 / rate)
    log(f"committee MD profile over 20 steps [{card}]: "
        + ("not measured (no device time seen)" if prof[0] is None else
           f"{prof[0]:.0f} device kernels per step, {prof[1]:.1f} us of "
           f"device time per step, device busy {100 * busy:.1f}%"))
    numbers["md"] = dict(models=nexp, steps_per_s=rate,
                         evaluations=ev["calls"],
                         steps=rec["steps"], chunks=rec["calls"],
                         kernels_per_step=prof[0], device_us_per_step=prof[1],
                         busy_share=busy)

    # (c) float32 device committee against the float64 plain host committee
    e_err, e_abs, f_err, f_mae, f_abs, w_dev, w_host = bb.committee_rel_err(
        calc, s2)
    nat = len(s2)
    log(f"committee weights: device (float32) {np.round(w_dev, 6).tolist()}, "
        f"host (float64 plain) {np.round(w_host, 6).tolist()}; |E| "
        f"{e_abs:.4g} eV, largest |f| {f_abs:.4g} eV/A, largest force error "
        f"{f_err:.3e} eV/A")
    check("committee energy error, float32 kernels vs float64 plain",
          f"{e_err / nat:.3e} eV/atom", "< 2e-4", e_err / nat < 2e-4)
    check("committee force MAE, float32 kernels vs float64 plain",
          f"{f_mae:.3e} eV/A", "< 1e-2", f_mae < 1e-2)
    numbers["accuracy"] = dict(e_err_per_atom=e_err / nat, f_mae=f_mae,
                               f_err_max=f_err, weights_device=w_dev.tolist(),
                               weights_host=w_host.tolist())

    # (d) isotropic NPT at the committee's own starting pressure, the
    # barostat's (the potential and the kinetic term), from the crystal
    # scaled to where the potential pressure vanishes (at its NVT lattice
    # constant the crystal sits near -9 GPa, where a barostat expands it
    # without bound under the oracle's single model and committee alike)
    # and thermalized by 50 Langevin steps, so that the barostat does not
    # start from the lattice's equipartition transient
    p_crystal = bb.pressure_GPa(calc, make_lgps_system())
    s3 = bb.at_zero_pressure(calc, make_lgps_system())
    s3.calc = calc
    maxwell_boltzmann_velocities(s3, T, seed=3)
    dmd.DeviceMD(s3, calc, dt=2 * fs, temperature_K=T, friction=0.05,
                 chunk=bb.CHUNK, check_beta=False).run(50)
    p0 = bb.pressure_GPa(calc, s3, kinetic=True)
    vol0 = s3.volume
    db.reset_launches()
    npt = dnpt.DeviceNPT(s3, calc, 2 * fs, temperature_K=T, pressure_GPa=p0,
                         isotropic=True, tdamp=50 * fs, pdamp=500 * fs,
                         chunk=bb.CHUNK, check_beta=False)
    t0 = time.time()
    npt.run(BCM_CAPS["npt_steps"])
    torch.cuda.synchronize()
    rate_npt = BCM_CAPS["npt_steps"] / (time.time() - t0)
    close("bcm_npt")
    dvol = s3.volume / vol0 - 1
    finite = bool(np.isfinite(s3.positions).all()
                  and np.isfinite(s3.cell).all())
    log(f"committee NPT [{card}]: the crystal at {p_crystal:.3f} GPa, scaled "
        f"to {vol0 / make_lgps_system().volume:.4f} of its volume; "
        f"{BCM_CAPS['npt_steps']} isotropic steps at {p0:.3f} GPa in "
        f"{BCM_CAPS['npt_steps'] / rate_npt:.2f} s ({rate_npt:.2f} steps/s, "
        f"first call included)")
    check("committee NPT state finite", finite, "True", finite)
    check("committee NPT volume change", f"{100 * dvol:+.3f} %", "within 5 %",
          abs(dvol) <= 0.05)
    numbers["npt"] = dict(pressure_GPa=p0, crystal_pressure_GPa=p_crystal,
                          volume_change=dvol, steps_per_s=rate_npt)

    # (e) FIRE
    s4 = make_lgps_system()
    s4.calc = calc
    e0 = s4.get_potential_energy()
    db.reset_launches()
    opt = dfire.DeviceFIRE(s4, calc, dt=0.05, chunk=bb.CHUNK, check_beta=False)
    t0 = time.time()
    opt.run(fmax=1e-12, steps=BCM_CAPS["fire_steps"])
    torch.cuda.synchronize()
    wall = time.time() - t0
    close("bcm_fire")
    e1 = s4.get_potential_energy()
    log(f"committee FIRE [{card}]: {opt.nsteps} iterations in {wall:.2f} s, "
        f"fmax {opt.fmax:.4f} eV/A")
    check("committee FIRE energy drop", f"{e0:.4f} -> {e1:.4f} eV", "drops",
          e1 < e0)
    numbers["fire"] = dict(iterations=opt.nsteps, wall_s=wall, e0=e0, e1=e1,
                           fmax=opt.fmax)

    # (f) NEB: a Li vacancy hop, relaxed end points, five interior images
    ends = bb.lgps_vacancy_hop(make_lgps_system())
    db.reset_launches()
    for im in ends:
        im.calc = calc
        dfire.DeviceFIRE(im, calc, chunk=bb.CHUNK, check_beta=False).run(
            fmax=0.05, steps=BCM_CAPS["neb_end_steps"])
    close("bcm_neb_ends")
    images = interpolate_images(ends[0], ends[1], 7)
    for im in images:
        im.calc = calc
    band = dneb.DeviceNEB(images, calc, k=0.1, climb=True, dt=0.05,
                          maxstep=0.1, chunk=bb.CHUNK, check_beta=False)
    torch.cuda.synchronize()
    db.reset_launches()
    t0 = time.time()
    with db.evaluation_probe(dneb, "band_forces") as ev:
        conv = band.run(fmax=0.05, steps=BCM_CAPS["neb_steps"])
    wall = time.time() - t0
    close("bcm_neb")
    evals = ev["calls"]
    barrier = band.barrier()
    log(f"committee NEB [{card}]: {len(images[0])} atoms x {len(images) - 2} "
        f"moving images, {band.nsteps} iterations ({evals} band evaluations) "
        f"in {wall:.2f} s, converged {conv}, final fmax {band.fmax:.4f} eV/A, "
        f"barrier {barrier:+.4f} eV "
        f"({'positive' if barrier > 0 else 'not positive'})")
    check("committee NEB barrier finite", f"{barrier:+.4f} eV", "finite",
          np.isfinite(barrier))
    check("committee NEB band evaluations", evals, "> 0", evals > 0)
    check("committee NEB band evaluations that did not launch each kernel "
          "once", f"{ev['off']} of {evals}", "0", ev["off"] == 0)
    de, e_scale, df, f_scale, f_net, rows = db.band_rel_err(band)
    check("committee NEB band energy, float32 stacked vs float64 per image",
          f"{de / e_scale:.3e} of the largest |E| {e_scale:.4g}",
          f"<= {db.BAND_E_TOL:g}", de <= db.BAND_E_TOL * e_scale)
    check("committee NEB band forces, float32 stacked vs float64 per image",
          f"{df / f_scale:.3e} of the largest slot term {f_scale:.4g} eV/A "
          f"({df / f_net:.3e} of the largest net |f| {f_net:.4g} eV/A, not "
          "held)", f"<= {db.BAND_F_TOL:g}", df <= db.BAND_F_TOL * f_scale)
    numbers["neb"] = dict(iterations=band.nsteps, evaluations=evals,
                          wall_s=wall, fmax=band.fmax, barrier=barrier,
                          band_e_rel_err=de / e_scale,
                          band_f_rel_err=df / f_scale,
                          band_f_rel_err_net=df / f_net, rows=rows[0].shape[0])
    numbers["wall_s"] = time.time() - t_phase
    log(f"phase 9 (a-f) took {numbers['wall_s']:.1f} s (budget 150 s)")
    return paths, numbers, (calc.engine.params, rows), calc


def phase_ensembles(committee, committee_system, learned, single_rate, card):
    """10. Replica ensembles, metadynamics, multi-task learning and the
    parametric potential (``ENS_CAPS``; the workloads of
    ``autoforce_tpu_torch.tools.ensemble_bench``): (a) R = 16 walkers of
    the bench snapshot under ``ReplicaMD``; (b) ``ActiveMeta`` fused into
    ``DeviceMD``, the committee's floor bias on phase 9's committee, and
    ``SoapMeta`` / ``Meta(Posvar)`` under the host Langevin driver; (c) a
    ``MultiTaskCalculator`` learning two Lennard-Jones tasks, then serving
    static weights and a weight switch; (d) ``ParametricCalculator``.
    ``committee_system()`` makes the configuration of the committee and
    of ``learned``, phase 5's model folder, which the fused bias is checked
    on (the bench model's covloss c exceeds 1 on every environment, its M
    being singular to rounding, so its beta sits at the clip floor).
    Every check prints its name, value and bound before it asserts.
    Returns ({path: launches}, numbers, the new timing shapes)."""
    import numpy as np
    import torch

    from autoforce_tpu_torch import units
    from autoforce_tpu_torch.calculator.active import ActiveCalculator
    from autoforce_tpu_torch.calculator.meta import ActiveMeta, Meta, Posvar, SoapMeta
    from autoforce_tpu_torch.md import Langevin
    from autoforce_tpu_torch.md import device_md as dmd
    from autoforce_tpu_torch.md import replica_md as rmd
    from autoforce_tpu_torch.system import maxwell_boltzmann_velocities
    from autoforce_tpu_torch.tools import driver_bench as db
    from autoforce_tpu_torch.tools import ensemble_bench as eb
    from autoforce_tpu_torch.tools import soap_bench as sb

    t_phase = time.time()
    fs = units.fs
    caps = ENS_CAPS
    paths, numbers = {}, {}

    def check(name, value, bound, ok):
        log(f"check {name}: {value} (bound {bound})")
        if not ok:
            raise AssertionError(f"phase 10: {name} = {value} misses {bound}")

    def close(name):
        got = db.launches()
        check(f"{name} launched both kernels", got, "each > 0",
              all(c > 0 for c in got.values()))
        paths[name] = got
        return got

    def per_step(name, ev, rec, steps):
        check(f"{name}: a chunk ran under the sync check",
              rec["sync_checked"], "True", rec["sync_checked"])
        check(f"{name} steps", rec["steps"], f"== {steps}",
              rec["steps"] == steps)
        check(f"{name} evaluations that did not launch each kernel once",
              f"{ev['off']} of {ev['calls']}", "0",
              ev["off"] == 0 and ev["calls"] >= steps)

    def busy(run, steps, rate):
        kps, us = db.profile_window(run, steps)
        if kps is None:
            return dict(kernels_per_step=None, device_us_per_step=None,
                        busy_share=None)
        return dict(kernels_per_step=kps, device_us_per_step=us,
                    busy_share=us / (1e6 / rate))

    # (a) the replica ensemble: one launch of each kernel per ensemble step
    R = caps["replicas"]
    calc = db.serving_calc()
    dyn = rmd.ReplicaMD(eb.replica_systems(R), calc, dt=2 * fs,
                        temperature_K=eb.TEMPERATURE_K, friction=0.02,
                        chunk=caps["rep_chunk"], check_beta=False)
    steps = caps["rep_warmup"] + caps["rep_steps"]
    db.reset_launches()
    reads = [0]
    host_read = dmd.host_read

    @contextlib.contextmanager
    def counted_read():  # the in-loop rebuilds' breach reads
        reads[0] += 1
        with host_read():
            yield

    with db.evaluation_probe(dmd, "_sgpr_forces") as ev, \
            db.chunk_probe(rmd, "md_chunk", 5) as rec:
        dyn.run(caps["rep_warmup"])  # its first chunk sync-checked
        torch.cuda.synchronize()
        dmd.host_read = counted_read
        try:
            t0 = time.time()
            dyn.run(caps["rep_steps"])
            torch.cuda.synchronize()
            rate = caps["rep_steps"] / (time.time() - t0)
        finally:
            dmd.host_read = host_read
    got = close("replicas")
    per_step("replica ensemble", ev, rec, steps)
    prof = busy(lambda: dyn.run(20), 20, rate)
    finite = all(np.isfinite(w.positions).all() for w in dyn.systems)
    check("replica positions finite", finite, "True", finite)
    de, e_scale, df, f_scale, f_net, rep_rows = eb.replica_rel_err(dyn)
    log(f"replica ensemble [{card}]: {R} walkers x {len(dyn.systems[0])} atoms "
        f"= {rep_rows[0].shape[0]} stacked rows, K = {rep_rows[0].shape[1]}; "
        f"{rate:.2f} ensemble steps/s, {R * rate:.1f} walker-steps/s over "
        f"{caps['rep_steps']} steps (one walker alone, phase 4: "
        f"{single_rate:.1f} steps/s); {prof['kernels_per_step']} device "
        f"kernels and {prof['device_us_per_step']} us of device time per "
        f"ensemble step, busy {prof['busy_share']}; {reads[0]} breach reads "
        f"(in-loop rebuilds) in the timed steps; launches {got}")
    check("replica energies, float32 stacked vs float64 per walker",
          f"{de / e_scale:.3e} of the largest |E| {e_scale:.4g}",
          f"<= {db.BAND_E_TOL:g}", de <= db.BAND_E_TOL * e_scale)
    check("replica forces, float32 stacked vs float64 per walker",
          f"{df / f_scale:.3e} of the largest slot term {f_scale:.4g} eV/A "
          f"({df / f_net:.3e} of the largest net |f| {f_net:.4g} eV/A, not "
          "held)", f"<= {db.BAND_F_TOL:g}", df <= db.BAND_F_TOL * f_scale)
    numbers["replicas"] = dict(
        walkers=R, rows=rep_rows[0].shape[0], ensemble_steps_per_s=rate,
        walker_steps_per_s=R * rate, single_walker_steps_per_s=single_rate,
        evaluations=ev["calls"], chunks=rec["calls"], breach_reads=reads[0],
        e_rel_err=de / e_scale, f_rel_err=df / f_scale,
        f_rel_err_net=df / f_net, **prof)
    rep_params = dyn.calc.engine.params
    del dyn

    # (b) ActiveMeta fused into DeviceMD
    scale = caps["meta_scale"]
    calc = db.serving_calc()
    calc.meta = ActiveMeta(scale=scale)
    s = sb.bench_system()
    s.calc = calc
    maxwell_boltzmann_velocities(s, eb.TEMPERATURE_K, seed=3)
    md = dmd.DeviceMD(s, calc, dt=2 * fs, temperature_K=eb.TEMPERATURE_K,
                      friction=0.02, chunk=100, check_beta=False)
    steps = 100 + caps["meta_steps"]
    db.reset_launches()
    with db.evaluation_probe(dmd, "_sgpr_forces") as ev, \
            db.chunk_probe(dmd, "md_chunk", 5) as rec:
        md.run(100)  # its first chunk sync-checked
        torch.cuda.synchronize()
        t0 = time.time()
        md.run(caps["meta_steps"])
        torch.cuda.synchronize()
        rate = caps["meta_steps"] / (time.time() - t0)
    got = close("meta_md")
    per_step("ActiveMeta DeviceMD", ev, rec, steps)
    finite = bool(np.isfinite(s.positions).all())
    check("ActiveMeta positions finite", finite, "True", finite)
    prof = busy(lambda: md.run(20), 20, rate)
    log(f"ActiveMeta DeviceMD [{card}]: {rate:.2f} steps/s over "
        f"{caps['meta_steps']} steps (without the bias, phase 4: "
        f"{single_rate:.1f}); {prof['kernels_per_step']} device kernels and "
        f"{prof['device_us_per_step']} us of device time per step, busy "
        f"{prof['busy_share']}; launches {got}")
    # the bias alone, with phase 5's learned model on its crystal rattled
    # 0.15 A (tests/test_bcm_meta.py), so that beta sits well above its
    # clip floor
    s2 = committee_system()
    s2.rattle(0.15, seed=33)
    lcalc = ActiveCalculator(covariance=learned, calculator=None, skin=SKIN,
                             logfile=None, pckl=None, tape=None,
                             dtype=torch.float32)
    lcalc.meta = ActiveMeta(scale=scale)
    m = eb.meta_rel_err(lcalc, s2, scale)
    log(f"ActiveMeta bias on the rattled crystal: float32 {m['e32']:.8g} eV, "
        f"float64 plain {m['e64']:.8g} eV; beta min {m['beta_min']:.4g}, "
        f"median {m['beta_median']:.4g}; largest bias force "
        f"{m['f_scale']:.4g} eV/A")
    check("beta of the bias check's configuration well above the clip "
          "floor (1e-6)", f"median {m['beta_median']:.4g}", ">= 1e-3",
          m["beta_median"] >= 1e-3)
    check("ActiveMeta bias energy, float32 fused vs float64 plain",
          f"{m['e_err']:.3e} eV", f"<= {m['e_tol']:.3e} eV (scale sum "
          "sqrt(vs) min(1e-5 / beta, sqrt(2e-5)))", m["e_err"] <= m["e_tol"])
    check("ActiveMeta bias forces, float32 fused vs float64 plain",
          f"{m['f_err'] / m['f_scale']:.3e} of the largest bias force",
          f"<= {eb.META_F_TOL:g}", m["f_err"] <= eb.META_F_TOL * m["f_scale"])
    numbers["meta_md"] = dict(steps_per_s=rate, plain_steps_per_s=single_rate,
                              evaluations=ev["calls"], **prof, **m)
    del md
    # the committee's floor bias: one evaluation against the host formula
    s3 = committee_system()
    s3.rattle(0.15, seed=33)
    e_dev, e_host, got, nat = eb.committee_floor_err(committee, s3, scale)
    paths["bcm_meta"] = got
    tol = 1e-3 * abs(e_host) + 2e-5 * nat / 32
    check("committee floor bias launches", got, "one of each",
          got == {"soap_coeff_fwd": 1, "soap_coeff_bwd": 1})
    check("committee floor bias, fused (float32) vs host formula",
          f"{e_dev:.8g} vs {e_host:.8g} eV", f"within {tol:.3e} eV "
          "(tests/test_bcm_meta.py's 1e-3 relative, 2e-5 eV per 32 atoms)",
          abs(e_dev - e_host) <= tol and e_host < 0)
    numbers["bcm_meta"] = dict(fused=e_dev, host=e_host,
                               models=len(dmd.committee_models(committee)))
    # SoapMeta and Meta(Posvar) under the host Langevin driver
    for name, bias in (("soap_meta", SoapMeta(scale=scale)),
                       ("posvar_meta", Meta(Posvar(0), sigma=0.2, w=0.05,
                                            hist=None))):
        calc.meta = bias
        h = sb.bench_system()
        h.calc = calc
        maxwell_boltzmann_velocities(h, eb.TEMPERATURE_K, seed=5)
        drv = Langevin(h, 2 * fs, eb.TEMPERATURE_K, friction=0.02, seed=6)
        drv.attach(bias.update)
        db.reset_launches()
        t0 = time.time()
        drv.run(caps["host_meta_steps"])
        torch.cuda.synchronize()
        wall = time.time() - t0
        got = close(name)
        ok = bool(np.isfinite(calc.results["energy"])
                  and np.isfinite(calc.results["forces"]).all()
                  and np.isfinite(h.positions).all())
        log(f"{name}: {caps['host_meta_steps']} host Langevin steps in "
            f"{wall:.2f} s [{card}], last energy {calc.results['energy']:.6g} "
            f"eV; launches {got}")
        check(f"{name} energies, forces and positions finite", ok, "True", ok)
        numbers[name] = dict(steps=caps["host_meta_steps"], wall_s=wall)
    calc.meta = None

    # (c) multi-task learning, then static weights and a weight switch
    mt = eb.multitask_calc(logfile=os.path.join(os.getcwd(), "mt_active.log"))
    g = eb.multitask_system()
    db.reset_launches()
    with db.chunk_probe(dmd, "md_chunk", 5) as rec:
        grow = eb.multitask_learn(mt, g, wall_cap=caps["mt_wall_cap"])
    close("mt_grow")
    mt_rows = sb.kernel_inputs(mt.engine, g, kpad=mt.cfg.nbr_idx.shape[1],
                               cutoff=mt.engine.params.rc + SKIN)
    log(f"multi-task growth [{card}]: {grow['steps']} steps in "
        f"{grow['wall_s']:.1f} s, (ndata, m) {grow['seed_size']} at the seed, "
        f"{grow['size']} at the end")
    check("multi-task growth: a chunk ran under the sync check",
          rec["sync_checked"], "True", rec["sync_checked"])
    check("multi-task samples taken after the seed",
          f"{grow['seed_size']} -> {grow['size']}", "grew",
          grow["size"] != grow["seed_size"])
    ok = grow["positions_finite"] and grow["forces_finite"]
    check("multi-task growth: forces and positions finite", ok, "True", ok)
    s4 = sb.bench_system()
    s4.calc = mt
    mt._calc = None
    maxwell_boltzmann_velocities(s4, eb.TEMPERATURE_K, seed=7)
    md = dmd.DeviceMD(s4, mt, dt=2 * fs, temperature_K=eb.TEMPERATURE_K,
                      friction=0.02, chunk=100, check_beta=False)
    nat = len(s4)
    mt_numbers = dict(grow=grow)
    served = dict.fromkeys(db.launches(), 0)
    forces = []
    for weights, steps in (((0.7, 0.3), caps["mt_steps"]),
                           ((0.0, 1.0), caps["mt_steps_switched"])):
        mt.set_weights(list(weights))
        db.reset_launches()
        with db.evaluation_probe(dmd, "_sgpr_forces") as ev, \
                db.chunk_probe(dmd, "md_chunk", 5) as rec:
            t0 = time.time()
            md.run(steps)
            torch.cuda.synchronize()
            rate = steps / (time.time() - t0)
        for k, c in db.launches().items():
            served[k] += c
        per_step(f"multi-task MD at weights {weights}", ev, rec, steps)
        fixed = sb.bench_system()
        fixed.rattle(0.02, seed=8)
        e_err, f_mae, f_max, task_e, f_dev = eb.multitask_rel_err(mt, fixed)
        forces.append(f_dev)
        log(f"multi-task MD at weights {weights} [{card}]: {rate:.2f} steps/s "
            f"over {steps} steps (first call included); task energies "
            f"{task_e.tolist()}")
        check(f"multi-task energy at {weights}, float32 device vs float64 "
              "host plain", f"{e_err / nat:.3e} eV/atom", "< 2e-4",
              e_err / nat < 2e-4)
        check(f"multi-task force MAE at {weights}, float32 device vs "
              "float64 host plain", f"{f_mae:.3e} eV/A", "< 1e-2",
              f_mae < 1e-2)
        ok = bool(np.isfinite(task_e).all())
        check(f"multi-task task energies finite at {weights}", ok, "True", ok)
        mt_numbers[str(weights)] = dict(steps_per_s=rate,
                                        e_err_per_atom=e_err / nat,
                                        f_mae=f_mae, f_err_max=f_max,
                                        task_energies=task_e.tolist())
    check("mt_md launched both kernels", served, "each > 0",
          all(c > 0 for c in served.values()))
    paths["mt_md"] = served
    dforce = float(np.abs(forces[0] - forces[1]).max())
    check("multi-task forces under the two weightings differ (the new mu "
          "reached the card)", f"{dforce:.4g} eV/A", "> 1e-3", dforce > 1e-3)
    numbers["multitask"] = mt_numbers

    # (d) the parametric potential against the oracle of its form
    de, e_abs, df, f_abs = eb.parametric_err(sb.bench_system())
    check("parametric LJ energy on the card vs the oracle",
          f"{de / e_abs:.3e} of |E| {e_abs:.6g} eV", f"<= {eb.PARAM_TOL:g}",
          de <= eb.PARAM_TOL * e_abs)
    check("parametric LJ forces on the card vs the oracle",
          f"{df / f_abs:.3e} of the largest |f| {f_abs:.4g} eV/A",
          f"<= {eb.PARAM_TOL:g}", df <= eb.PARAM_TOL * f_abs)
    numbers["parametric"] = dict(e_rel_err=de / e_abs, f_rel_err=df / f_abs)
    numbers["wall_s"] = time.time() - t_phase
    log(f"phase 10 (a-d) took {numbers['wall_s']:.1f} s (budget 100 s)")
    return paths, numbers, {"replica_rows": (rep_params, rep_rows),
                            "mt_growth": (mt.engine.params, mt_rows)}


def phase_offline(learned, lgps, card, device="cuda"):
    """11. The offline workflow and the out-of-process oracle (``OFF_CAPS``;
    the pieces of ``autoforce_tpu_torch.tools.offline_bench``), in a
    directory of its own: the oracle served by a calculation server
    process, learning and labelling through the socket, ``cl.train`` /
    ``cl.test`` / ``scores`` / ``cl.build`` / ``cl.shrink`` on the labelled
    frames, and ``cl.lmp``'s callback.  ``learned``: phase 5's model
    folder; ``lgps()``: the flagship's crystal; ``device``: where the
    models run (the card; the CPU only to rehearse).  Every check prints
    its name, value and bound before it asserts.  Returns ({path:
    launches}, numbers)."""
    import numpy as np

    from autoforce_tpu_torch import cl
    from autoforce_tpu_torch.calculator.oracles import MixtureLennardJones
    from autoforce_tpu_torch.calculator.socket import SocketCalculator
    from autoforce_tpu_torch.cl import build as cl_build
    from autoforce_tpu_torch.cl import init_model as cl_init
    from autoforce_tpu_torch.cl import lmp as cl_lmp
    from autoforce_tpu_torch.cl import shrink as cl_shrink
    from autoforce_tpu_torch.cl import singlepoint as cl_single
    from autoforce_tpu_torch.io.xyz import read_xyz, write_xyz
    from autoforce_tpu_torch.tools import driver_bench as db
    from autoforce_tpu_torch.tools import kernelspace_bench as ksb
    from autoforce_tpu_torch.tools import offline_bench as ob
    from autoforce_tpu_torch.tools import otf_bench as otf
    from autoforce_tpu_torch.tools import soap_bench as sb

    t_phase = time.time()
    caps = OFF_CAPS
    paths, numbers = {}, {}

    def check(name, value, bound, ok):
        log(f"check {name}: {value} (bound {bound})")
        if not ok:
            raise AssertionError(f"phase 11: {name} = {value} misses {bound}")

    def close(name):
        got = db.launches()
        check(f"{name} launched both kernels", got, "each > 0",
              all(c > 0 for c in got.values()))
        paths[name] = got
        return got

    def rel(a, b):  # largest |a - b| over the largest |b|
        a, b = np.asarray(a, dtype=float), np.asarray(b, dtype=float)
        return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))

    work = os.path.join(os.getcwd(), "offline")
    os.makedirs(work)
    cwd = os.getcwd()
    os.chdir(work)
    oracle = MixtureLennardJones(otf.EPS, otf.SIG, rc=otf.RC)
    script = ob.oracle_script(os.path.join(work, "lgps_oracle.py"))
    proc = None
    try:
        # (a) the oracle in a server process, held against this process's
        t0 = time.time()
        proc, port = ob.start_server(script, os.path.join(work, "server.log"))
        up = time.time() - t0
        sc = SocketCalculator(port=port)
        worst = 0.0
        for k in range(caps["socket_checks"]):
            s = lgps()
            s.rattle(0.05, seed=40 + k)
            got, ref = sc.calculate(s), oracle.calculate(s)
            worst = max(worst, rel(got["energy"], ref["energy"]),
                        rel(got["forces"], ref["forces"]))
        log(f"oracle server up in {up:.2f} s on port {port}; "
            f"{caps['socket_checks']} requests of {len(s)} atoms")
        check("socket oracle vs in-process oracle, energy and forces",
              f"{worst:.3e} of the largest value", "<= 1e-10",
              worst <= 1e-10)
        numbers["socket"] = dict(server_up_s=up, rel_err=worst)

        # (b) learning through the socket: cl.init_model, inprocess False
        ob.write_args(work, calculator=script, inprocess=False,
                      socket_port=port, pckl=os.path.join(work, "socket.pckl"),
                      tape=os.path.join(work, "socket.sgpr"),
                      **ob.learn_args(device))
        cl.refresh()
        sock = cl.ARGS["calculator"]
        check("the ARGS oracle is a SocketCalculator", type(sock).__name__,
              "SocketCalculator", isinstance(sock, SocketCalculator))
        db.reset_launches()
        t0 = time.time()
        calc = cl_init.init_model(lgps(), samples=caps["init_samples"])
        wall = time.time() - t0
        got = close("socket_init")
        fp = calc.event_counts["fp_calls"]
        log(f"cl.init_model through the socket [{card}]: "
            f"{caps['init_samples']} samples in {wall:.2f} s, (ndata, m) "
            f"{calc.size}, {fp} oracle calls, {sock.calls} requests "
            f"answered; launches {got}")
        check("socket model (ndata, m)", calc.size, ">= (1, 1)",
              calc.size[0] >= 1 and calc.size[1] >= 1)
        check("oracle calls == requests the server answered",
              f"{fp} vs {sock.calls}", "equal", fp == sock.calls > 0)
        numbers["socket_init"] = dict(size=list(calc.size), wall_s=wall,
                                      fp_calls=fp, answered=sock.calls)
        del calc

        # (c) frames of a frozen run of phase 5's model, labelled through
        # the socket; one cl.singlepoint through it
        t0 = time.time()
        frames = ob.md_frames(learned, lgps(), n=caps["frames"],
                              every=caps["every"], device=device)
        md_wall = time.time() - t0
        t0 = time.time()
        n0 = sock.calls
        ob.label(frames, sock)
        label_wall = time.time() - t0
        labels = sock.calls - n0
        ntr = len(frames) - 2
        write_xyz("data.extxyz", frames[:ntr])
        write_xyz("heldout.extxyz", frames[ntr:])
        one = frames[-1].copy()
        res = cl_single.singlepoint(one, output="singlepoint.extxyz")
        sp = read_xyz("singlepoint.extxyz", index=0)
        ref = oracle.calculate(frames[-1])
        err = max(rel(res["energy"], ref["energy"]),
                  rel(res["forces"], ref["forces"]))
        # the written frame carries forces to 8 decimals
        ferr = float(np.abs(sp.get_forces() - ref["forces"]).max())
        check("cl.singlepoint's file vs in-process oracle forces",
              f"{ferr:.3e} eV/A", "<= 1e-8 (8 decimals)", ferr <= 1e-8)
        log(f"{len(frames)} frames of frozen DeviceMD at 400 K (every "
            f"{caps['every']} steps) in {md_wall:.2f} s, labelled through "
            f"the socket in {label_wall:.2f} s ({labels} requests)")
        check("cl.singlepoint through the socket vs in-process oracle",
              f"{err:.3e} of the largest value", "<= 1e-10", err <= 1e-10)
        check("label requests answered", labels, f"== {len(frames)}",
              labels == len(frames))
        numbers["frames"] = dict(n=len(frames), md_wall_s=md_wall,
                                 label_wall_s=label_wall,
                                 requests=sock.calls)
    finally:
        # stopped whatever happened above: sent 'end' and joined
        rc = ob.stop_server(proc, port) if proc is not None else None
        cl.ARGS.clear()
    check("oracle server exit code after 'end'", rc, "0", rc == 0)

    # (d) cl.train on the first frames, from seed; cl.test and scores on
    # the held-out frames for it and for phase 5's model
    db.reset_launches()
    size, train_wall = ob.train(work, device)
    got = close("train")
    log(f"cl.train on {ntr} frames of {len(frames[0])} atoms from seed "
        f"[{card}]: (ndata, m) {size} in {train_wall:.2f} s; launches {got}")
    db.reset_launches()
    t0 = time.time()
    sc_train = ob.held_out(work, "train", device, pckl="train.pckl")
    sc_p5 = ob.held_out(work, "phase5", device, covariance=learned, pckl=None)
    test_wall = time.time() - t0
    close("test")
    log(f"cl.test on {len(frames) - ntr} held-out frames [{card}] in "
        f"{test_wall:.2f} s: trained model forces {sc_train['forces']}, "
        f"energy {sc_train['energy']}; phase 5's model forces "
        f"{sc_p5['forces']}")
    check("trained model's held-out force R2", f"{sc_train['forces']['r2']:.4f}",
          f">= {ob.TRAIN_R2_BAR} (tests/test_cl.py)",
          sc_train["forces"]["r2"] >= ob.TRAIN_R2_BAR)
    check("phase 5's model held-out force MAE",
          f"{sc_p5['forces']['mae']:.4f} eV/A",
          f"<= {otf.OTF_F_MAE_BOUND} (OTF_F_MAE_BOUND)",
          sc_p5["forces"]["mae"] <= otf.OTF_F_MAE_BOUND)
    numbers["train"] = dict(frames=ntr, size=list(size), wall_s=train_wall,
                            test_wall_s=test_wall, scores=sc_train,
                            phase5_scores=sc_p5)

    # (e) cl.build from (d)'s tape into a fresh folder
    ob.write_args(work, pckl="build.pckl", tape="train.sgpr",
                  **ob.learn_args(device, **ob.TRAIN))
    db.reset_launches()
    t0 = time.time()
    bcalc = cl_build.main()
    build_wall = time.time() - t0
    got = close("build")
    e_err, _, _, _, f_mae = ksb.predict_rel_err(bcalc, frames[-1])
    e_err /= len(frames[-1])
    log(f"cl.build from the tape [{card}]: (ndata, m) {bcalc.size} in "
        f"{build_wall:.2f} s; launches {got}; float32 (kernels) vs float64 "
        f"(plain) {e_err:.3e} eV/atom, force MAE {f_mae:.3e} eV/A")
    check("rebuilt (ndata, m) == trained", f"{bcalc.size} vs {size}",
          "equal", tuple(bcalc.size) == tuple(size))
    check("rebuilt model float32 vs float64 energy", f"{e_err:.3e} eV/atom",
          "< 2e-4", e_err < 2e-4)
    check("rebuilt model float32 vs float64 force MAE", f"{f_mae:.3e} eV/A",
          "< 1e-2", f_mae < 1e-2)
    numbers["build"] = dict(size=list(bcalc.size), wall_s=build_wall,
                            e_err_per_atom=e_err, f_mae=f_mae)
    del bcalc

    # (f) cl.shrink -m (m - 2) -c 8 on (d)'s model, then one prediction of
    # the shrunk model, which restages it on the card: the path's launches
    # are those of these two steps alone
    target = size[1] - caps["shrink_by"]
    ob.write_args(work, pckl="train.pckl", **ob.serve_args(device))
    db.reset_launches()
    t0 = time.time()
    scalc = cl_shrink.main(["-m", str(target), "-c",
                            str(caps["shrink_candidates"])])
    shrink_wall = time.time() - t0
    scalc._calc = None
    scalc.calculate(frames[-1].copy())
    got = close("shrink")
    staged = int(scalc.model.full_model_arrays().m_mask.sum().item())
    e_err, _, _, _, f_mae = ksb.predict_rel_err(scalc, frames[-1])
    e_err /= len(frames[-1])
    # the shrunk model's cl.test is the test path's too
    db.reset_launches()
    sc_shrunk = ob.held_out(work, "shrunk", device, pckl="train.pckl")
    paths["test"] = {k: c + paths["test"][k] for k, c in db.launches().items()}
    log(f"cl.shrink -m {target} -c {caps['shrink_candidates']} [{card}]: "
        f"m {size[1]} -> {scalc.model.m} in {shrink_wall:.2f} s, {staged} "
        f"inducing rows restaged; float32 vs float64 {e_err:.3e} eV/atom, "
        f"force MAE {f_mae:.3e} eV/A; held-out force R2 "
        f"{sc_train['forces']['r2']:.4f} -> {sc_shrunk['forces']['r2']:.4f}; "
        f"launches of the shrink and one prediction {got}, cl.test of "
        f"both models {paths['test']}")
    check("shrunk m", scalc.model.m, f"== {target}", scalc.model.m == target)
    check("restaged inducing rows", staged, f"== {target}", staged == target)
    check("shrunk model float32 vs float64 energy", f"{e_err:.3e} eV/atom",
          "< 2e-4", e_err < 2e-4)
    check("shrunk model float32 vs float64 force MAE", f"{f_mae:.3e} eV/A",
          "< 1e-2", f_mae < 1e-2)
    numbers["shrink"] = dict(m_before=size[1], m_after=scalc.model.m,
                             wall_s=shrink_wall, e_err_per_atom=e_err,
                             f_mae=f_mae, r2_before=sc_train["forces"]["r2"],
                             r2_after=sc_shrunk["forces"]["r2"])
    del scalc
    cl.ARGS.clear()
    os.chdir(cwd)

    # (g) the LAMMPS callback on the bench snapshot, phase 4's calculator
    calc = db.serving_calc(device=device)
    s = sb.bench_system()
    fake = ob.FakeLammps(s)
    driver = cl_lmp.LammpsDriver(fake, calc, "metal", {1: 29}, "AutoForce")
    n = len(s)
    tag = np.arange(1, n + 1)
    rng = np.random.default_rng(50)
    per, e_worst, f_worst = [], 0.0, 0.0
    summed = dict.fromkeys(db.launches(), 0)
    t0 = time.time()
    for step in range(caps["lmp_callbacks"]):
        s.positions += rng.normal(0.0, 0.005, s.positions.shape)
        fext = np.zeros((n, 3))
        db.reset_launches()
        driver(None, step, n, tag, None, fext)
        got = db.launches()
        per.append(got)
        for k, c in got.items():
            summed[k] += c
        ref_sys = s.copy()
        ref = calc.calculate(ref_sys)
        e_worst = max(e_worst, rel(fake.pushed["energy"][1], ref["energy"]))
        f_worst = max(f_worst, rel(fext, ref["forces"]))
    lmp_wall = time.time() - t0
    paths["lmp"] = summed
    off = sum(1 for g in per if any(c != 1 for c in g.values()))
    log(f"LAMMPS callbacks [{card}]: {caps['lmp_callbacks']} on {n} atoms in "
        f"{lmp_wall:.2f} s (with the reference evaluations); launches "
        f"{summed}")
    check("callbacks that did not launch each kernel once",
          f"{off} of {len(per)}", "0", off == 0)
    check("pushed energy vs ActiveCalculator.calculate",
          f"{e_worst:.3e} of |E|", "<= 1e-6", e_worst <= 1e-6)
    check("pushed forces vs ActiveCalculator.calculate",
          f"{f_worst:.3e} of the largest |f|", "<= 1e-6", f_worst <= 1e-6)
    numbers["lmp"] = dict(callbacks=len(per), wall_s=lmp_wall,
                          e_rel_err=e_worst, f_rel_err=f_worst)
    numbers["wall_s"] = time.time() - t_phase
    log(f"phase 11 (a-g) took {numbers['wall_s']:.1f} s (budget 75 s)")
    return paths, numbers


def phase_mesh(committee, learned, card, device="cuda"):
    """12. The device mesh (the workloads of
    ``autoforce_tpu_torch.tools.mesh_checks``): a 2x2 ('data', 'model')
    mesh over the visible cards in turn.  (a) ``Engine.predict`` under the
    mesh against without it (both float32 through the kernels) and
    against the float64 reference at the bench.py:412 bars; (b)
    ``kernel_block`` on both routes against the unsharded call; (c)
    ``DeviceMD`` under the mesh: its first evaluation against the
    unsharded one, steps/s, busy share and kernels per step beside the
    unsharded driver's, every evaluation launching each SOAP kernel once
    per data shard, the first chunk sync-checked and the breach reads
    counted; (d) ``DeviceNPT``, ``DeviceFIRE`` (both cells) and
    ``DeviceNEB``: the first evaluation against the unsharded one, finite,
    launches per evaluation; (e) phase 9's committee and the fused
    ActiveMeta bias under the mesh; (f) ``ActiveCalculator(mesh=...)``
    learning on the flagship (wall-capped), its model's predict under the
    mesh against without; (g) ``cl.md`` with ``mesh = make_mesh(...)`` in
    ARGS; (h) ``mesh_bench``: the sharded step against ``md_chunk``; (i)
    a 3 x 1 mesh, whose data axis adds rows to the 1024-atom flagship,
    serving ``learned`` (phase 5's model folder): DeviceMD (Langevin, then
    NHC) for one chunk with in-loop breaches against the unsharded driver
    (``mesh_checks.padded_md``).  ``committee``: phase 9's committee
    calculator.  Returns (launches by path, numbers, the kernels' inputs
    at one data shard's rows)."""
    import numpy as np
    import torch

    from autoforce_tpu_torch import units
    from autoforce_tpu_torch.calculator.active import ActiveCalculator
    from autoforce_tpu_torch.calculator.meta import ActiveMeta
    from autoforce_tpu_torch.io.model_io import load_model
    from autoforce_tpu_torch.md import device_md as dmd
    from autoforce_tpu_torch.md import device_npt as dnpt
    from autoforce_tpu_torch.opt import device_fire as dfire
    from autoforce_tpu_torch.opt import device_neb as dneb
    from autoforce_tpu_torch.opt.neb import interpolate_images
    from autoforce_tpu_torch.parallel import mesh_bench as mb
    from autoforce_tpu_torch.system import bulk_fcc, maxwell_boltzmann_velocities
    from autoforce_tpu_torch.tools import driver_bench as db
    from autoforce_tpu_torch.tools import mesh_checks as mc
    from autoforce_tpu_torch.tools import soap_bench as sb
    from autoforce_tpu_torch.tools.otf_bench import make_lgps_system

    t_phase = time.time()
    fs = units.fs
    mesh = mc.card_mesh(device=device)
    nd = mesh.shape["data"]
    devs = [str(d) for d in mesh.devices.ravel()]
    paths, numbers = {}, dict(mesh=mesh.shape, devices=devs)

    def check(name, value, bound, ok):
        log(f"mesh {name}: {value} (bound {bound}) [{card}]")
        if not ok:
            raise AssertionError(f"phase 12: {name} = {value} misses {bound}")

    def held(name, errs):
        check(name, ", ".join(f"{k} {v:.3e}" for k, v in errs.items()),
              f"e {mc.MESH_E_TOL:g} eV/atom, f {mc.MESH_F_TOL:g} of the "
              f"largest slot term (f_net: of the largest |f|, not held), "
              f"virial {mc.MESH_V_TOL:g}, cov {mc.MESH_COV_TOL:g}, beta "
              f"{mc.MESH_BETA_TOL:g}", not mc.within(errs))

    def close(name):
        got = db.launches()
        for k, c in got.items():
            if c == 0:
                raise AssertionError(f"phase 12 {name}: {k} never launched")
        paths[name] = got
        db.reset_launches()
        return got

    def evaluations(name, ev):
        check(f"{name}: sharded evaluations not launching each kernel "
              f"{nd} times", f"{ev['off']} of {ev['calls']}", "0 of > 0",
              ev["off"] == 0 and ev["calls"] > 0)

    def mesh_calc():
        return ActiveCalculator(covariance=db.MODEL, calculator=None,
                                skin=db.SKIN, logfile=None, pckl=None,
                                tape=None, device=device, mesh=mesh)

    # (a) predict under the mesh, against without and against float64
    plain = db.serving_calc(device)
    s = sb.bench_system()
    s.calc = plain
    s.get_potential_energy()
    eng, cfg = plain.engine, plain.cfg
    ma = plain.model.full_model_arrays()
    ones = np.ones(cfg.npad)
    errs = mc.predict_diff(eng, cfg, ma, ones, mesh)
    held("(a) predict vs unsharded", errs)
    slot = db.slot_scale(cfg, ma, eng.radii_table(), None, eng,
                         eng.kernel_space())
    db.reset_launches()
    eng.mesh = mesh
    try:
        e, f, *_ = eng.predict(cfg, ma, ones)
        torch.cuda.synchronize()
    finally:
        eng.mesh = None
    got = close("mesh_predict")
    check("(a) launches of one sharded predict", got,
          f"{nd} of each", all(v == nd for v in got.values()))
    ref = np.load(ACC_REF)
    n = len(s)
    e_err = abs(float(e) - float(ref["e"])) / n
    f_mae = float(np.abs(f.cpu().numpy()[:n] - ref["f"]).mean())
    check("(a) predict vs float64 reference", f"energy {e_err:.3e} eV/atom, "
          f"force MAE {f_mae:.3e} eV/A", "2e-4, 1e-2 (bench.py:412)",
          e_err < 2e-4 and f_mae < 1e-2)
    numbers["predict"] = dict(errs, e_vs_f64=e_err, f_mae_vs_f64=f_mae)

    # (b) kernel_block on both routes
    kb = {}
    for method, (te, tf) in (("vjp", (KB_KE_TOL, KB_KF_TOL)),
                             ("jac", (JAC_KE_TOL, JAC_KF_TOL))):
        ke, kf, kv = mc.kernel_block_diff(eng, cfg, ma, mesh, method)
        kb[method] = dict(ke=ke, kf=kf, kv=kv)
        check(f"(b) kernel_block {method} vs unsharded",
              f"ke {ke:.3e}, kf {kf:.3e}, kv {kv:.3e}", f"{te:g}, {tf:g}",
              ke <= te and kf <= tf and kv <= tf)
    close("mesh_kb")
    numbers["kernel_block"] = kb

    # (c) DeviceMD: first evaluation, the first chunk's forces, then rates
    # beside the unsharded driver
    reads = [0]
    host_read = dmd.host_read

    @contextlib.contextmanager
    def counted_read():  # the in-loop rebuilds' breach reads
        reads[0] += 1
        with host_read():
            yield

    rates, profs, first = {}, {}, {}
    for label, calc in (("unsharded", plain), ("sharded", mesh_calc())):
        s = sb.bench_system()
        s.calc = calc
        maxwell_boltzmann_velocities(s, 300, seed=3)
        dyn = dmd.DeviceMD(s, calc, 2 * fs, temperature_K=300, friction=0.02,
                           chunk=100, check_beta=False)
        if label == "unsharded":
            s.get_potential_energy()
            errs = mc.eval_diff(dyn._new_chain(), mesh, eng)
            held("(c) DeviceMD first evaluation vs unsharded", errs)
            numbers["md_first_eval"] = errs
        # the first chunk, of MESH_CHUNK_STEPS steps from the same state
        # and noise: the forces it returns
        with mc.chunk_outputs() as out:
            dyn.run(mc.MESH_CHUNK_STEPS)
        first[label] = out[0]
        db.reset_launches()
        if label == "unsharded":
            dyn.run(100)
            torch.cuda.synchronize()
            t0 = time.time()
            dyn.run(200)
            torch.cuda.synchronize()
            rates[label] = 200 / (time.time() - t0)
            db.reset_launches()
        else:
            dmd.host_read = counted_read
            try:
                with mc.evaluation_counter(nd) as ev, \
                        db.chunk_probe(dmd, "md_chunk", 5) as rec:
                    dyn.run(100)  # its first chunk sync-checked
                    torch.cuda.synchronize()
                    t0 = time.time()
                    dyn.run(200)
                    torch.cuda.synchronize()
                    rates[label] = 200 / (time.time() - t0)
            finally:
                dmd.host_read = host_read
            check("(c) DeviceMD first chunk under the sync check",
                  rec["sync_checked"], "True", rec["sync_checked"])
            n = len(s)
            (p0, f0), (p1, f1) = first["unsharded"], first["sharded"]
            errs = mc.force_errs(f1[:n], f0[:n], slot)
            dpos = (p1[:n] - p0[:n]).abs().max().item()
            held(f"(c) DeviceMD first chunk's forces ({mc.MESH_CHUNK_STEPS} "
                 f"steps, |dpos| {dpos:.2e} A) vs unsharded", errs)
            numbers["md_first_chunk"] = dict(errs, dpos=dpos)
            evaluations("(c) DeviceMD", ev)
            got = close("mesh_md")
            per = {k: v / rec["steps"] for k, v in got.items()}
            log(f"mesh DeviceMD [{card}]: {rec['steps']} steps in "
                f"{rec['calls']} chunks, {ev['calls']} evaluations, "
                f"{reads[0]} breach reads (one host read per chunk and per "
                f"breach), launches {got}: {per} per step")
            numbers["md"] = dict(steps=rec["steps"], chunks=rec["calls"],
                                 evaluations=ev["calls"], breach_reads=reads[0],
                                 launches_per_step=per)
        kps, us = db.profile_window(lambda: dyn.run(20), 20)
        profs[label] = (None if kps is None else dict(
            kernels_per_step=kps, device_us_per_step=us,
            busy_share=us / (1e6 / rates[label])))
        db.reset_launches()
    log(f"mesh DeviceMD vs unsharded [{card}]: {rates['sharded']:.1f} vs "
        f"{rates['unsharded']:.1f} steps/s over 200 steps (1008 atoms, chunk "
        f"100); profile {profs}")
    numbers["md"].update(steps_per_s=rates["sharded"],
                         unsharded_steps_per_s=rates["unsharded"],
                         profile=profs["sharded"],
                         unsharded_profile=profs["unsharded"])

    # (d) NPT, FIRE (both cells), NEB: first evaluation, finite, launches
    def driver(name, make, run, virial, chain_of=None):
        s = make()
        s.calc = plain
        s.get_potential_energy()
        d0 = run(s, plain, None)
        errs = mc.eval_diff((chain_of or (lambda d: d._new_chain()))(d0),
                            mesh, eng, virial=virial)
        held(f"(d) {name} first evaluation vs unsharded", errs)
        calc = mesh_calc()
        s = make()
        s.calc = calc
        db.reset_launches()
        with mc.evaluation_counter(nd) as ev:
            d1 = run(s, calc, 1)
            torch.cuda.synchronize()
        evaluations(f"(d) {name}", ev)
        close(f"mesh_{name}")
        finite = bool(np.isfinite(s.positions).all()
                      and np.isfinite(np.asarray(s.cell)).all())
        check(f"(d) {name} finite", finite, "True", finite)
        numbers[name] = dict(first_eval=errs, evaluations=ev["calls"],
                             steps=d1.nsteps)

    def hot():
        s = sb.bench_system()
        maxwell_boltzmann_velocities(s, 300, seed=3)
        return s

    def npt(s, calc, go):
        d = dnpt.DeviceNPT(s, calc, 2 * fs, temperature_K=300,
                           pressure_GPa=100.0, tdamp=50 * fs, pdamp=500 * fs,
                           chunk=25, check_beta=False, isotropic=False)
        if go:
            d.run(50)
        return d

    def fire(s, calc, go):
        d = dfire.DeviceFIRE(s, calc, dt=0.05, chunk=25, check_beta=False)
        if go:
            d.run(fmax=1e-12, steps=50)
        return d

    def strained():
        s = bulk_fcc("Cu", 3.65).repeat(sb.REPS_MD)
        s.rattle(0.05, seed=1)
        return s

    def fire_cell(s, calc, go):
        d = dfire.DeviceFIRE(s, calc, chunk=25, check_beta=False, cell=True)
        if go:
            d.run(fmax=1e-12, steps=50)
        return d

    driver("npt", hot, npt, True)
    driver("fire", sb.bench_system, fire, False)
    driver("fire_cell", strained, fire_cell, True)
    # the band: the snapshot to a rattled copy, three moving images
    last = sb.bench_system()
    last.rattle(0.05, seed=2)
    bands = {}
    for label, calc in (("plain", plain), ("mesh", mesh_calc())):
        images = interpolate_images(sb.bench_system(), last.copy(), 5)
        for im in images:
            im.calc = calc
        bands[label] = dneb.DeviceNEB(images, calc, k=0.1, dt=0.05, chunk=10,
                                      check_beta=False)
    c0, c1 = bands["plain"]._build_chain(), bands["mesh"]._build_chain()
    p_int = c1["pos"][1:-1]
    with torch.no_grad():
        e0, f0, _ = dneb.band_forces(c0["pos"][1:-1], c0["cfg"], c0["ma"],
                                     c0["radii"], c0["vs"], eng.params,
                                     eng.exponent, False, c0["ks"])
        e1, f1, _ = dneb.band_forces(p_int, c1["cfg"], c1["ma"],
                                     c1["radii"], c1["vs"], eng.params,
                                     eng.exponent, False, c1["ks"],
                                     mesh=mesh, own_idx=c1["oidx"])
    n = len(last)
    slot = db.slot_scale(c0["cfg"], c0["ma"], c0["radii"], c0["vs"], eng,
                         c0["ks"], nimg=p_int.shape[0])
    errs = dict(e=(e1 - e0).abs().max().item() / n,
                **mc.force_errs(f1[:, :n], f0[:, :n], slot))
    held("(d) NEB first band evaluation vs unsharded", errs)
    db.reset_launches()
    band = bands["mesh"]
    with mc.evaluation_counter(nd) as ev:
        band.run(fmax=1e-9, steps=20)
        torch.cuda.synchronize()
    evaluations("(d) NEB", ev)
    close("mesh_neb")
    finite = all(np.isfinite(im.positions).all() for im in band.images)
    check("(d) NEB finite", finite, "True", finite)
    numbers["neb"] = dict(first_eval=errs, evaluations=ev["calls"],
                          iterations=band.nsteps, fmax=band.fmax)

    # (e) phase 9's committee and the fused ActiveMeta bias under the mesh
    committee._calc = None
    ceng = committee.engine
    s = make_lgps_system()
    s.calc = committee
    s.get_potential_energy()
    chain = dmd.new_chain(committee, s, True)
    check("(e) the committee serves experts", len(dmd.committee_models(
        committee)), ">= 2", chain["mean_e"] is not None)
    errs = mc.eval_diff(chain, mesh, ceng)
    held("(e) committee first evaluation vs unsharded", errs)
    ceng.mesh = mesh
    try:
        maxwell_boltzmann_velocities(s, 400, seed=5)
        dyn = dmd.DeviceMD(s, committee, 2 * fs, temperature_K=400,
                           friction=0.05, chunk=25, check_beta=False)
        db.reset_launches()
        with mc.evaluation_counter(nd) as ev:
            t0 = time.time()
            dyn.run(50)
            torch.cuda.synchronize()
            wall = time.time() - t0
    finally:
        ceng.mesh = None
    evaluations("(e) committee DeviceMD", ev)
    close("mesh_bcm")
    finite = bool(np.isfinite(s.positions).all())
    check("(e) committee MD finite", finite, "True", finite)
    numbers["committee"] = dict(first_eval=errs, experts=len(
        dmd.committee_models(committee)), evaluations=ev["calls"],
        steps_per_s=50 / wall)
    scale = ENS_CAPS["meta_scale"]
    s = hot()
    plain.meta = ActiveMeta(scale=scale)
    try:
        s.calc = plain
        s.get_potential_energy()
        chain = dmd.new_chain(plain, s, True, meta=True)
    finally:
        plain.meta = None
    errs = mc.eval_diff(chain, mesh, eng, meta_scale=scale)
    held("(e) ActiveMeta first evaluation vs unsharded", errs)
    calc = mesh_calc()
    calc.meta = ActiveMeta(scale=scale)
    s = hot()
    s.calc = calc
    db.reset_launches()
    dyn = dmd.DeviceMD(s, calc, 2 * fs, temperature_K=300, friction=0.02,
                       chunk=25, check_beta=False)
    with mc.evaluation_counter(nd) as ev:
        t0 = time.time()
        dyn.run(50)
        torch.cuda.synchronize()
        wall = time.time() - t0
    evaluations("(e) ActiveMeta DeviceMD", ev)
    close("mesh_meta")
    numbers["meta"] = dict(first_eval=errs, evaluations=ev["calls"],
                           steps_per_s=50 / wall)

    # (f) learning under the mesh, wall-capped
    db.reset_launches()
    out, lcalc, ls = mc.learn(mesh, wall_cap=MESH_CAPS["learn_wall_cap"])
    torch.cuda.synchronize()
    close("mesh_otf")
    check("(f) learning under the mesh grew, finite",
          f"{out['steps']} steps in {out['wall_s']:.1f} s, (ndata, m) = "
          f"({out['ndata']}, {out['m']}), {out['fp_calls']} oracle calls, "
          f"finite {out['finite']}", "m > 0, oracle called, finite",
          out["m"] > 0 and out["fp_calls"] > 0 and out["finite"])
    leng = lcalc.engine
    lcfg = leng.make_config(ls)
    errs = mc.predict_diff(leng, lcfg, lcalc.model.full_model_arrays(),
                           np.ones(lcfg.npad), mesh)
    held("(f) the learned model's predict vs unsharded", errs)
    numbers["learn"] = dict(out, predict=errs)
    del lcalc

    # (g) cl.md with a mesh in ARGS
    cwd = os.getcwd()
    os.makedirs("mesh_cl", exist_ok=True)
    os.chdir("mesh_cl")
    try:
        db.reset_launches()
        frames = mc.cl_md(db.MODEL, f"make_mesh(data={nd}, model="
                          f"{mesh.shape['model']}, devices={devs!r})",
                          steps=MESH_CAPS["cl_steps"], device=device)
        torch.cuda.synchronize()
    finally:
        os.chdir(cwd)
    close("mesh_cl")
    finite = len(frames) >= 1 and all(np.isfinite(a.positions).all()
                                      for a in frames)
    check("(g) cl.md under an ARGS mesh: frames, finite", len(frames),
          ">= 1, finite", finite)
    numbers["cl_md"] = dict(frames=len(frames))

    # (h) mesh_bench at 1008 atoms: the sharded step against md_chunk
    model = load_model(db.MODEL, device=device, dtype=torch.float32)
    res = mb.measure(model=model, system=sb.bench_system(), n_data=nd,
                     n_model=mesh.shape["model"],
                     steps=MESH_CAPS["bench_steps"], device=device,
                     devices=devs)
    mb.report(res)
    close("mesh_bench")
    bound = mc.traj_bound(slot, res["mass_min"], res["duration"],
                          res["pos_ulp"])
    check("(h) mesh_bench trajectory |dpos|max vs md_chunk",
          f"{res['dpos_max']:.3e} A", f"{bound:.3e} A (1/2 MESH_F_TOL slot "
          f"{slot:.3f} eV/A / {res['mass_min']:.2f} amu T^2 + 4 ulp "
          f"{res['pos_ulp']:.2e} A)", res["dpos_max"] <= bound)
    numbers["mesh_bench"] = dict(res, dpos_bound=bound)

    # (i) a mesh whose data axis adds rows: 3 x 1 on the 1024-atom
    # flagship (1024 rows pad to 1026), phase 5's model served frozen,
    # DeviceMD Langevin then NHC for one chunk with in-loop breaches,
    # against the unsharded driver from the same state and noise
    pad_mesh = mc.card_mesh(mc.PAD_SHAPE, device=device)
    db.reset_launches()
    pads = {}
    for thermostat in ("langevin", "nhc"):
        r = mc.padded_md(learned, pad_mesh, thermostat, device=device)
        pads[thermostat] = r
        log(f"mesh (i) {thermostat} on the {r['mesh']} mesh [{card}]: "
            f"{r['natoms']} atoms, {r['rows']} rows unsharded, "
            f"{r['mesh_rows']} on the mesh; {r['steps']} steps in "
            f"{r['chunks']} chunks, breach reads {r['breach_reads']}")
        check(f"(i) {thermostat}: the mesh added rows",
              f"{r['rows']} -> {r['mesh_rows']}",
              f"more, a multiple of {mc.PAD_SHAPE[0]}",
              r["mesh_rows"] > r["rows"]
              and r["mesh_rows"] % mc.PAD_SHAPE[0] == 0)
        check(f"(i) {thermostat}: steps, chunks and breach reads as "
              f"unsharded", f"{r['steps']}, {r['chunks']}, "
              f"{r['breach_reads']}", "equal, breached",
              r["steps"][0] == r["steps"][1] == mc.PAD_STEPS
              and r["chunks"][0] == r["chunks"][1]
              and r["breach_reads"][0] == r["breach_reads"][1] > 0)
        held(f"(i) {thermostat}: the chunk's forces vs unsharded",
             dict(f=r["f"], f_net=r["f_net"]))
        check(f"(i) {thermostat}: |dpos|max vs unsharded",
              f"{r['dpos']:.3e} A", f"{r['dpos_bound']:.3e} A "
              f"(mesh_checks.traj_bound)", r["dpos"] <= r["dpos_bound"])
    close("mesh_pad")
    numbers["padded"] = pads
    # both kernels at one data shard's rows of the MD bucket
    shard = (eng.params, _shard_rows(cfg, nd, eng))
    numbers["wall_s"] = time.time() - t_phase
    log(f"phase 12 (a-i) took {numbers['wall_s']:.1f} s (budget 50 s)")
    return paths, numbers, shard


def _shard_rows(cfg, n_data, eng):
    """The SOAP kernels' inputs at data shard 0's rows of ``cfg`` (the
    rows a sharded step launches each kernel on)."""
    import torch

    from autoforce_tpu_torch.engine import _env_rvec

    nb = -(-cfg.npad // n_data)
    oidx = torch.arange(nb, device=cfg.positions.device)
    rows = cfg._replace(nbr_idx=cfg.nbr_idx[:nb], nbr_off=cfg.nbr_off[:nb],
                        nbr_sidx=cfg.nbr_sidx[:nb], nbr_mask=cfg.nbr_mask[:nb],
                        atom_mask=cfg.atom_mask[:nb], numbers=cfg.numbers[:nb])
    with torch.no_grad():
        rvec = _env_rvec(cfg.positions, cfg.cell, rows, oidx=oidx).contiguous()
    return (rvec, rows.nbr_sidx, rows.nbr_mask & rows.atom_mask[:, None],
            eng.radii_table())


# the twin run's driver script: phase 5's model served on the card and the
# flagship's oracle reached through the socket, both on the configurations
# that the parent wrote (extxyz, exact floats); its last line carries its
# numbers for the parent
TWIN_DRIVER = '''import json, sys, time
t0 = time.time()
import numpy as np
import torch
from autoforce_tpu_torch.calculator.active import ActiveCalculator
from autoforce_tpu_torch.calculator.socket import SocketCalculator
from autoforce_tpu_torch.descriptor import soap_kernels as sk
from autoforce_tpu_torch.io.xyz import read_xyz
folder, port, device, configs = sys.argv[1], int(sys.argv[2]), sys.argv[3], sys.argv[4]
oracle = SocketCalculator(ip="localhost", port=port)
calc = ActiveCalculator(covariance=folder, calculator=None, logfile=None,
                        pckl=None, tape=None, device=device)
t_ready = time.time() - t0
sk.soap_coeff_fwd.launches = sk.soap_coeff_bwd.launches = 0
rows = []
for s in read_xyz(configs):
    s.calc = calc
    e, f = s.get_potential_energy(), s.get_forces()
    t = s.copy()
    t.calc = oracle
    ef, ff = t.get_potential_energy(), t.get_forces()
    rows.append(dict(e_ml=float(e), e_fp=float(ef),
                     f_mae=float(np.abs(f - ff).mean())))
if device.startswith("cuda"):
    torch.cuda.synchronize()
print("TWIN " + json.dumps(dict(
    launches={"soap_coeff_fwd": sk.soap_coeff_fwd.launches,
              "soap_coeff_bwd": sk.soap_coeff_bwd.launches},
    size=list(calc.size), natoms=len(s), rows=rows, ready_s=t_ready,
    wall_s=time.time() - t0)), flush=True)
'''


def phase_periphery(learned, lgps, serving, otf, card, device="cuda"):
    """13. The periphery on the card (``PERI_CAPS``, a budget of 30 s), in
    a directory of its own.  (a) ``graft_entry.entry()``: the fused SGPR
    step in float32 through the kernels against the same step in float64
    through the plain versions (bench.py:412's bars), one launch of each
    kernel.  (b) ``graft_entry.dryrun_multichip(3)`` on the card repeated
    (3 x 1: the data axis adds rows), and ``(4)`` (2 x 2) while the
    budget allows.  (c) ``StructureSearch`` on phase 5's model, served
    frozen, over the unrattled flagship crystal: one epoch of swaps of
    one species pair; every energy on the card in float32 against float64
    through the plain versions (2e-4 eV/atom), the structure restored
    after every probe, one launch of each kernel per energy, a second
    search reading the cache back with equal energies.  (d)
    ``remote.twinrun``: a ``calc_server`` process serving the flagship's
    oracle on a free port and a driver process serving phase 5's model on
    the card; the oracle through the socket against this process's
    (1e-10 of the largest value), the driver's launches and sizes, the
    port free afterwards where ``lsof`` exists.  (e)
    ``analysis.logs.parse_logfile`` of phase 5's active.log (its last
    sizes phase 5's (ndata, m)), ``log_to_figure`` to a PNG where
    matplotlib is installed, and
    ``TrajAnalyser`` and ``rdf`` on frames of phase 4's serving MD.
    ``learned``: phase 5's model folder; ``lgps(rattle=)``: the flagship's
    crystal; ``serving``: phase 4's DeviceMD; ``otf``: phase 5's numbers.
    Returns ({path: launches}, numbers)."""
    import numpy as np
    import torch

    from autoforce_tpu_torch import graft_entry as ge
    from autoforce_tpu_torch import remote
    from autoforce_tpu_torch.analysis import TrajAnalyser, rdf
    from autoforce_tpu_torch.analysis.logs import log_to_figure, parse_logfile
    from autoforce_tpu_torch.analysis.structgen import StructureSearch
    from autoforce_tpu_torch.calculator.active import ActiveCalculator
    from autoforce_tpu_torch.calculator.oracles import MixtureLennardJones
    from autoforce_tpu_torch.io.xyz import write_xyz
    from autoforce_tpu_torch.tools import driver_bench as db
    from autoforce_tpu_torch.tools import offline_bench as ob
    from autoforce_tpu_torch.tools import otf_bench as otf_mod

    t_phase = time.time()
    caps = PERI_CAPS
    paths, numbers = {}, {}
    cuda = torch.device(device).type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def check(name, value, bound, ok):
        log(f"periphery {name}: {value} (bound {bound}) [{card}]")
        if not ok:
            raise AssertionError(f"phase 13: {name} = {value} misses {bound}")

    def close(name):
        got = db.launches()
        check(f"{name} launched both kernels", got, "each > 0",
              all(c > 0 for c in got.values()))
        paths[name] = got
        db.reset_launches()
        return got

    work = os.path.join(os.getcwd(), "periphery")
    os.makedirs(work)
    cwd = os.getcwd()
    os.chdir(work)
    try:
        # (a) the fused step of the driver entry, float32 on the card
        # against float64 through the plain versions
        t0 = time.time()
        fn, args = ge.entry(device=device)
        db.reset_launches()
        e, f, _, _, beta = fn(*args)
        sync()
        got = close("graft_entry")
        check("(a) graft_entry launches of one fused step", got,
              "one of each", all(v == 1 for v in got.values()))
        with db.plain_kernels():
            fn64, args64 = ge.entry(device=device, dtype=torch.float64)
            e64, f64, _, _, beta64 = fn64(*args64)
        n = int(args[0].atom_mask.sum())
        e_err = abs(float(e) - float(e64)) / n
        f_mae = float((f[:n].double() - f64[:n]).abs().mean())
        check("(a) graft_entry float32 vs float64 plain",
              f"energy {e_err:.3e} eV/atom, force MAE {f_mae:.3e} eV/A",
              "2e-4, 1e-2 (bench.py:412)", e_err < 2e-4 and f_mae < 1e-2)
        numbers["entry"] = dict(natoms=n, e_err_per_atom=e_err, f_mae=f_mae,
                                beta_finite=bool(torch.isfinite(
                                    beta[:n]).all()),
                                wall_s=time.time() - t0)

        # (b) the dry run over a mesh of the card repeated: 3 x 1 adds rows
        # (2 x 2 after (e), while the budget allows)
        dry = {}

        def dryrun(nd):
            t0 = time.time()
            out = ge.dryrun_multichip(nd, device=device)
            sync()
            out["wall_s"] = time.time() - t0
            dry[nd] = out
            log(f"periphery (b) dryrun_multichip({nd}) [{card}]: mesh "
                f"{out['mesh']} on {out['devices']}, {out['natoms']} atoms, "
                f"{out['npad']} rows -> {out['padded_rows']} on the mesh, "
                f"{out['wall_s']:.1f} s")

        dryrun(3)
        check("(b) dryrun_multichip(3): the data axis added rows",
              f"{dry[3]['npad']} -> {dry[3]['padded_rows']}", "more rows",
              dry[3]["padded_rows"] > dry[3]["npad"])
        close("dryrun")
        numbers["dryrun"] = dry

        # (c) StructureSearch on phase 5's model, frozen, on the card
        t0 = time.time()
        calc = ActiveCalculator(covariance=learned, calculator=None,
                                logfile=None, pckl=None, tape=None,
                                device=device)
        s = lgps(rattle=0.0)
        warm = s.copy()
        warm.calc = calc
        warm.get_potential_energy()  # stages the model on the card
        numbers0 = s.numbers.copy()
        search = StructureSearch(s, calc=calc, sim=1.0 - 1e-6,
                                 prefix="search", rng=0)
        per, restored = [], []
        energy = search.energy

        def probe(g):
            fresh = tuple(g) not in search.cached
            before = db.launches()
            out = energy(g)
            if fresh:
                after = db.launches()
                per.append({k: after[k] - before[k] for k in after})
            restored.append(bool(np.array_equal(s.numbers, numbers0)))
            return out

        search.energy = probe
        db.reset_launches()
        t1 = time.time()
        search.energy(())
        parents = search.search_swaps([()], [caps["swap"]], epochs=1,
                                      max_child=caps["max_child"],
                                      max_parents=caps["max_parents"])
        sync()
        t_search = time.time() - t1
        close("structgen")
        check("(c) StructureSearch launches per energy", per,
              "one of each per energy",
              bool(per) and all(set(p.values()) == {1} for p in per))
        check("(c) the structure restored after every probe",
              f"{sum(restored)} of {len(restored)}", "all",
              all(restored))
        calc64 = ActiveCalculator(covariance=learned, calculator=None,
                                  logfile=None, pckl=None, tape=None,
                                  device=device, dtype=torch.float64)
        worst = 0.0
        with db.plain_kernels():
            for g, e32 in search.cached.items():
                t = s.copy()
                for idx, _, z in g:
                    t.numbers[idx] = z
                t.calc = calc64
                worst = max(worst, abs(e32 - t.get_potential_energy()) / len(s))
        check(f"(c) {len(search.cached)} StructureSearch energies float32 vs "
              f"float64 plain", f"{worst:.3e} eV/atom", "2e-4 (bench.py:412)",
              worst < 2e-4)
        again = StructureSearch(s, calc=None, prefix="search", rng=0)
        check("(c) a second search reads the cache back",
              f"{len(again.cached)} energies, equal "
              f"{again.cached == search.cached}", "all, equal",
              again.cached == search.cached and len(again.cached) > 0)
        numbers["structgen"] = dict(
            natoms=len(s), swap=list(caps["swap"]), energies=len(per),
            cached=len(search.cached), parents=[list(map(list, p))
                                                for p in parents],
            e_err_per_atom_vs_f64=worst, search_s=t_search,
            s_per_energy=t_search / max(len(per), 1), wall_s=time.time() - t0)
        del calc, calc64

        # (d) the twin run: an oracle server and a driver, two processes
        t0 = time.time()
        port = ob.free_port()
        script = ob.oracle_script(os.path.join(work, "lgps_oracle.py"))
        driver = os.path.join(work, "twin_driver.py")
        with open(driver, "w") as fh:
            fh.write(TWIN_DRIVER)
        configs = []
        for k in range(caps["twin_configs"]):
            c = lgps()
            c.rattle(0.05, seed=60 + k)
            configs.append(c)
        write_xyz(os.path.join(work, "twin_configs.extxyz"), configs,
                  forces=False, exact=True)
        captured = os.path.join(work, "twin.out")
        sys.stdout.flush()
        saved = os.dup(1)
        with open(captured, "w") as fh:
            os.dup2(fh.fileno(), 1)
            try:
                rc = remote.twinrun(driver, ip="localhost", port=port,
                                    calculator=script, device=device,
                                    args=(learned, str(port), device,
                                          "twin_configs.extxyz"))
            finally:
                sys.stdout.flush()
                os.dup2(saved, 1)
                os.close(saved)
        wall = time.time() - t0
        text = open(captured).read()
        for line in text.splitlines():
            log(f"  twin: {line[:300]}")
        check("(d) twinrun's exit code", rc, "0", rc == 0)
        lines = [ln for ln in text.splitlines() if ln.startswith("TWIN ")]
        check("(d) the driver's numbers line", len(lines), "1",
              len(lines) == 1)
        twin = json.loads(lines[0][5:])
        oracle = MixtureLennardJones(otf_mod.EPS, otf_mod.SIG, rc=otf_mod.RC)
        ref = [oracle.calculate(c)["energy"] for c in configs]
        got_e = np.array([r["e_fp"] for r in twin["rows"]])
        rel = float(np.abs(got_e - np.array(ref)).max()
                    / np.abs(np.array(ref)).max())
        check("(d) the oracle through the socket vs in-process", f"{rel:.3e} "
              "of the largest value", "<= 1e-10", rel <= 1e-10)
        nconf = caps["twin_configs"]
        check("(d) the driver's launches on the card", twin["launches"],
              f"{nconf} of each (one per evaluation)",
              all(v == nconf for v in twin["launches"].values()))
        served = (otf["served_ndata"], otf["served_m"])
        check("(d) the driver served phase 5's model: (ndata, m)",
              tuple(twin["size"]), f"{served}", tuple(twin["size"]) == served)
        paths["twin"] = twin["launches"]
        pids = remote.port_pids(port)
        lsof = shutil.which("lsof") is not None
        if lsof:
            check("(d) the port is free after the twin run", pids, "[]",
                  pids == [])
        numbers["twin"] = dict(twin, rel_err=rel, wall_s=wall,
                               lsof=lsof, port_pids=pids)
        log(f"periphery (d) twinrun [{card}]: {wall:.1f} s for the two "
            f"processes (the driver ready after {twin['ready_s']:.1f} s, "
            f"done after {twin['wall_s']:.1f} s of its own)")

        # (e) phase 5's active.log, a figure, and frames of phase 4's MD
        t0 = time.time()
        d = parse_logfile(os.path.join(cwd, OTF_LOG))
        sizes = (int(d["data"][-1, 1]), int(d["inducing"][-1, 1]))
        check("(e) the last parsed (ndata, m) of phase 5's active.log",
              sizes, f"{served} (phase 5's served model)", sizes == served)
        if importlib.util.find_spec("matplotlib") is None:
            # the figure is host-only; the CPU tests draw it
            png = None
            log("periphery (e) log_to_figure left out: matplotlib is not "
                "installed where this runs")
        else:
            log_to_figure(os.path.join(cwd, OTF_LOG), save="otf_dash.png")
            png = os.path.getsize("otf_dash.png") if os.path.isfile(
                "otf_dash.png") else 0
            check("(e) log_to_figure wrote a PNG", f"{png} bytes", "> 0",
                  png > 0)
        frames = []
        for _ in range(4):
            serving.run(10)
            frames.append(serving.system.copy())
        ta = TrajAnalyser(frames)
        msd = ta.msd()
        r, g = rdf(frames, rmax=5.0, bins=100)
        finite = bool(np.isfinite(msd).all() and all(
            np.isfinite(v).all() for v in g.values()))
        check("(e) TrajAnalyser and rdf on phase 4's MD frames finite",
              f"msd {msd[-1]:.3e} A^2, g(r) peak at "
              f"{r[np.argmax(g[(29, 29)])]:.3f} A", "finite", finite)
        numbers["logs"] = dict(
            rows={k: len(v) for k, v in d.items()}, last_sizes=sizes,
            png_bytes=png, msd=float(msd[-1]),
            rdf_peak=float(r[np.argmax(g[(29, 29)])]),
            wall_s=time.time() - t0)

        # (b) the 2 x 2 dry run, while the budget allows
        left = caps["budget"] - (time.time() - t_phase)
        if left >= caps["dryrun4_before"]:
            db.reset_launches()
            dryrun(4)
            paths["dryrun"] = {k: v + paths["dryrun"][k]
                               for k, v in db.launches().items()}
            db.reset_launches()
        else:
            log(f"periphery (b) dryrun_multichip(4) left out: {left:.1f} s "
                f"of the budget left (needs {caps['dryrun4_before']:g})")
    finally:
        os.chdir(cwd)
    numbers["wall_s"] = time.time() - t_phase
    log(f"phase 13 (a-e) took {numbers['wall_s']:.1f} s (budget "
        f"{caps['budget']:.0f} s)")
    return paths, numbers


def phase_profile(dyn, ms_per_step, card):
    """Device time by kernel over 50 MD steps (torch.profiler), and the
    device's busy share of an unprofiled step ('not measured' when the
    profiler sees no device time)."""
    import collections

    import torch
    from torch.profiler import ProfilerActivity, profile

    steps = 50
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        dyn.run(steps)
        torch.cuda.synchronize()
    by_name = collections.defaultdict(lambda: [0.0, 0])
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            row = by_name[ev.name]
            row[0] += ev.time_range.elapsed_us()
            row[1] += 1
    if not by_name:
        log("profile: no device time seen (not measured)")
        return
    busy_us = sum(r[0] for r in by_name.values()) / steps
    launches = sum(r[1] for r in by_name.values()) / steps
    log(f"profile over {steps} MD steps [{card}]: {launches:.0f} device kernels "
        f"per step, {busy_us:.1f} us of device time per step; unprofiled step "
        f"{ms_per_step * 1e3:.1f} us -> device busy {100 * busy_us / (ms_per_step * 1e3):.1f}%")
    rows = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    for name, (us, count) in rows[:12]:
        log(f"  {us / steps:8.2f} us/step  x{count / steps:5.1f}/step  {name[:100]}")
    # where the host's time goes (the device is idle most of the step)
    import cProfile
    import io
    import pstats

    pr = cProfile.Profile()
    pr.enable()
    dyn.run(steps)
    torch.cuda.synchronize()
    pr.disable()
    out = io.StringIO()
    pstats.Stats(pr, stream=out).sort_stats("tottime").print_stats(18)
    log(f"host profile over {steps} MD steps (cProfile, self time):")
    for line in out.getvalue().splitlines():
        if line.strip() and not line.startswith(("   Ordered", "   List")):
            log("  " + line.rstrip()[:150])


def phase_timings(cases, worst, launches, card):
    """Each kernel's device time beside its plain version's and its bound
    at every timing shape; the MD bucket's numbers are the row's own.
    ``launches``: path -> kernel -> launches on that path's run."""
    import torch

    from autoforce_tpu_torch.descriptor import soap_kernels as sk
    from autoforce_tpu_torch.tools import soap_bench as sb

    rows = {"soap_coeff_fwd": [], "soap_coeff_bwd": []}
    for shape, (params, (rvec, sidx, mask, radii)) in cases.items():
        N, K, _ = rvec.shape
        S = radii.shape[0]
        CH = sk.channels(S, params)
        g = torch.Generator(device="cuda").manual_seed(11)
        crb = torch.randn((N, CH), generator=g, device="cuda", dtype=rvec.dtype)
        cib = torch.randn((N, CH), generator=g, device="cuda", dtype=rvec.dtype)
        (fb, fo), (bb, bo), (n_valid, n_live) = sb.soap_work(rvec, sidx, mask,
                                                             radii, params)
        dname = str(rvec.dtype).replace("torch.", "")
        specs = (
            ("soap_coeff_fwd", "soap_fwd_kernel",
             lambda: sk.soap_coeff_fwd(rvec, sidx, mask, radii, params),
             lambda: sk.soap_coeff_fwd_plain(rvec, sidx, mask, radii, params), fb, fo),
            ("soap_coeff_bwd", "soap_bwd_kernel",
             lambda: sk.soap_coeff_bwd(rvec, sidx, mask, radii, crb, cib, params),
             lambda: sk.soap_coeff_bwd_plain(rvec, sidx, mask, radii, crb, cib, params),
             bb, bo),
        )
        for name, kname, kern, plain, nbytes, ops in specs:
            # device time of the kernel and of the plain version's kernels;
            # the elapsed time per call (CUDA events over back-to-back calls)
            # is bounded by the host when the device time is shorter
            ms = sb.device_ms(kern, 200, kname)
            call_ms = sb.cuda_ms(kern, 200)
            # the plain version once: its device and elapsed times from one
            # traced window of three calls after one warm-up call
            plain_ms, plain_call_ms = sb.device_ms(plain, 3, warmup=1,
                                                   elapsed=True)
            if ms is None or plain_ms is None:
                log("profiler saw no device kernels: times are elapsed per call")
                ms, plain_ms = call_ms, plain_call_ms
            b_ms, b_by = sb.bound(nbytes, ops, dname)
            log(f"{name} {shape} {dname} N={N} K={K} S={S} ({n_valid} valid, "
                f"{n_live} live slots): device {ms * 1e3:.2f} us (plain "
                f"{plain_ms * 1e3:.1f} us), per call {call_ms * 1e3:.1f} us (plain "
                f"{plain_call_ms * 1e3:.1f} us), bound {b_ms * 1e3:.2f} us ({b_by}: "
                f"{nbytes / 1e6:.2f} MB, {ops / 1e6:.1f} Mop), {100 * b_ms / ms:.0f} % "
                f"of the bound [{card}]")
            rows[name].append({
                "shape": shape, "N": N, "K": K, "S": S, "valid": n_valid,
                "live": n_live, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                "bound_by": b_by,
            })
    out = []
    for w, (name, line) in enumerate((("soap_coeff_fwd", 104), ("soap_coeff_bwd", 146))):
        md = rows[name][0]
        out.append({
            "name": name, "route": "cuda",
            "source": "autoforce_tpu_torch/csrc/soap_coeff.cu",
            "replaces": f"autoforce_tpu/descriptor/pallas_soap.py:{line}",
            "launches": sum(by[name] for by in launches.values()),
            "launches_by_path": {path: by[name] for path, by in launches.items()},
            "max_abs_err": worst["md_bucket"][w],
            "ms": md["ms"], "plain_ms": md["plain_ms"], "bound_ms": md["bound_ms"],
            "bound_by": md["bound_by"], "library_ms": None, "shapes": rows[name],
        })
    return out


def main():
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "autoforce_tpu_torch")):
        print("chip_smoke: run it from a checkout of the repository "
              "(autoforce_tpu_torch/ not found)", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    # side files of the calculators (logs, uncertain frames) land in a
    # scratch directory, not in the checkout, and go with it
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        os.chdir(tmp)
        try:
            return run_phases(torch)
        finally:
            os.chdir(cwd)


def run_phases(torch):
    from autoforce_tpu_torch.io.model_io import load_model
    from autoforce_tpu_torch.tools import soap_bench as sb

    card = sb.card_line()
    kind = torch.cuda.get_device_name(0)
    log(f"card: {card}; torch {torch.__version__} CUDA {torch.version.cuda}; "
        f"device 0: {kind}")
    t_all = time.time()
    clock = [time.time()]

    def took(phase):
        log(f"phase {phase} took {time.time() - clock[0]:.1f} s "
            f"({time.time() - t_all:.1f} s in all)")
        clock[0] = time.time()

    phase_build()
    took(1)
    model = load_model(MODEL, device="cuda", dtype=torch.float32)
    model_ms = load_model(MODEL_MS, device="cuda", dtype=torch.float32)
    eng, eng_ms = model.engine, model_ms.engine
    # the MD bucket (what ActiveCalculator gives at rc + skin), the
    # 10,192-atom snapshot at the same rule, and the 4-species snapshot
    timing = sb.timing_cases(eng, eng_ms)
    both = (torch.float64, torch.float32)
    cases = {
        "md_bucket": timing["md_bucket"] + (both,),
        "snapshot_rc": (eng.params, sb.kernel_inputs(eng, sb.bench_system()), both),
        "multispecies": timing["multispecies"] + (both,),
        "scale_10k": timing["scale_10k"] + ((torch.float32,),),
    }
    worst = phase_kernels(cases)
    del cases
    took(2)
    phase_accuracy(model)
    took(3)
    rates, launches, drift, md_inputs, dyn = phase_md(model, card)
    took(4)
    driver_launches, neb_band = phase_drivers(card)
    # both kernels at the NEB band's shape: the interior images stacked
    worst.update(phase_kernels({"neb_band": neb_band + (both,)}))
    timing["neb_band"] = neb_band
    took("7 with its kernel checks")
    k_md = timing["md_bucket"][1][0].shape[1]
    if md_inputs[0].shape[1] != k_md:
        log(f"note: MD bucket K={md_inputs[0].shape[1]} (phase 2 used {k_md})")
    timing["md_bucket"] = (eng.params, md_inputs)
    otf, calc, otf_launches = phase_otf(card)
    kb_errs, col_times, otf_inputs = phase_otf_columns(calc, card)
    took(5)
    t8 = time.time()
    jac_errs, jac_times, jac_launches, onehot = phase_jacobian(calc, card)
    worst.update(phase_kernels({
        "otf_staging": otf_inputs["otf_staging"] + ((torch.float64,),),
        "otf_record": otf_inputs["otf_record"] + ((torch.float32,),),
        "onehot_rows": onehot + ((torch.float32,),),
    }))
    timing["onehot_rows"] = onehot
    params, (rvec, sidx, mask, radii) = otf_inputs["otf_record"]
    timing.update(otf_inputs)
    # the rows of one backward launch of kernel_block (64 columns)
    timing["otf_block_rows"] = (params, (rvec.repeat(64, 1, 1), sidx.repeat(64, 1),
                                         mask.repeat(64, 1), radii))
    # phase 9 starts its committee from this learned model, saved as the
    # committee's first model folder
    from autoforce_tpu_torch.io.model_io import save_model

    bcm_dir = os.path.join(os.getcwd(), "committee")
    os.makedirs(bcm_dir)
    save_model(calc.model, os.path.join(bcm_dir, "bcm_1.pckl"))
    del calc
    ks_launches, ks_numbers = phase_kernel_space(card)
    log(f"phase 8 took {time.time() - t8:.1f} s")
    clock[0] = time.time()
    bcm_launches, bcm_numbers, bcm_band, bcm_calc = phase_committee(bcm_dir,
                                                                     card)
    # (g) both kernels at the committee band's stacked shape
    worst.update(phase_kernels({"bcm_neb_band": bcm_band + (both,)}))
    timing["bcm_neb_band"] = bcm_band
    took("9 with its kernel checks")
    from autoforce_tpu_torch.tools.otf_bench import make_lgps_system

    ens_launches, ens_numbers, ens_shapes = phase_ensembles(
        bcm_calc, make_lgps_system, os.path.join(bcm_dir, "bcm_1.pckl"),
        sorted(rates)[1], card)
    # both kernels at the replica ensemble's stacked rows and the
    # multi-task growth's rows
    worst.update(phase_kernels({k: v + (both,) for k, v in ens_shapes.items()}))
    timing.update(ens_shapes)
    took("10 with its kernel checks")
    off_launches, off_numbers = phase_offline(
        os.path.join(bcm_dir, "bcm_1.pckl"), make_lgps_system, card)
    took(11)
    mesh_launches, mesh_numbers, mesh_shard = phase_mesh(
        bcm_calc, os.path.join(bcm_dir, "bcm_1.pckl"), card)
    del bcm_calc
    # both kernels at one data shard's rows of the MD bucket
    worst.update(phase_kernels({"mesh_shard": mesh_shard + (both,)}))
    timing["mesh_shard"] = mesh_shard
    took("12 with its kernel checks")
    peri_launches, peri_numbers = phase_periphery(
        os.path.join(bcm_dir, "bcm_1.pckl"), make_lgps_system, dyn, otf, card)
    took(13)
    rows = phase_timings(timing, worst, {"md": launches, "otf": otf_launches,
                                         **driver_launches,
                                         "kb_jac": jac_launches,
                                         **ks_launches, **bcm_launches,
                                         **ens_launches, **off_launches,
                                         **mesh_launches, **peri_launches},
                         card)
    rates.sort()
    phase_profile(dyn, 1.0 / rates[1] * 1e3, card)
    took(6)
    log(f"summary: {len(md_inputs[0])}-atom Cu Langevin MD median "
        f"{rates[1]:.1f} steps/s [{card}]; OTF {otf['natoms']}-atom "
        f"{otf['steps_per_sec_incl_learning']:.4f} steps/s including learning, "
        f"force MAE {otf['f_mae_vs_oracle']:.4f} eV/A; kernel_block float32 "
        f"relative errors {kb_errs}; column timings {json.dumps(col_times)}; "
        f"Jacobian route errors {jac_errs}, timings {json.dumps(jac_times)}")
    print(json.dumps({"kernel_space": ks_numbers}))
    print(json.dumps({"committee": bcm_numbers}))
    print(json.dumps({"replicas_meta_multitask_parametric": ens_numbers}))
    print(json.dumps({"offline_oracle": off_numbers}))
    print(json.dumps({"mesh": mesh_numbers}, default=str))
    print(json.dumps({"periphery": peri_numbers}, default=str))
    log(f"chip_smoke took {time.time() - t_all:.1f} s after the card check "
        f"(ceiling 1000 s)")
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    except Exception:
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        rc = 1
    sys.stdout.flush()
    os._exit(rc)
