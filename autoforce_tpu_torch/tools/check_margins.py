"""The margins of the checks in ``chip_smoke.py`` that read a learned
model, over more than one reading in one call on a CUDA card:

* phase 11 (d): the held-out force R2 of ``cl.train`` from seed (bar
  ``offline_bench.TRAIN_R2_BAR``) and phase 5's model's held-out force MAE
  (bar ``otf_bench.OTF_F_MAE_BOUND``), over frame seeds (the first is
  phase 11's own): ``offline_bench.TRAIN``'s thresholds on four frames
  (phase 11's count) and on six, and the flagship's on six;
* phase 9 (f): the committee NEB band's float32 force error against both
  scales of ``driver_bench.band_rel_err`` (the largest slot term, which
  ``BAND_F_TOL`` holds, and the largest net |f|), after each stage of 100
  iterations as the band relaxes past phase 9's one stage.

Run from the root of a checkout on a machine with one card:

    python -m autoforce_tpu_torch.tools.check_margins [--seeds 4] [--stages 4]

(``--seeds 0`` skips phase 11's readings, ``--stages 0`` the band's.)

It builds the kernels, learns the flagship model as phase 5 does
(``otf_bench.measure_otf`` at :data:`PHASE5`, chip_smoke.py's
``OTF_CAPS``; about 7 min), reads phase 11's margins on it, then grows
phase 9's committee from it (45 s) and relaxes its band.  Prints one JSON
line per reading, then ``{"ok": true}``.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

from . import driver_bench as db
from . import offline_bench as ob
from . import otf_bench as otf

# chip_smoke.py's OTF_CAPS and BCM_CAPS (phases 5 and 9)
PHASE5 = dict(grow_cap=400, prod_steps=400, chunk=50, grow_wall_cap=150.0,
              prod_wall_cap=360.0)
PHASE9 = dict(max_inducing=256, max_data=8, grow_wall_cap=45.0,
              neb_end_steps=150, neb_steps=100)
FLAGSHIP = dict(ediff_kcal_mol=2.0)  # fdiff 1.5 times ediff


def emit(**row):
    print(json.dumps(row), flush=True)


def offline_margins(folder, seeds, work, system=otf.make_lgps_system,
                    device="cuda"):
    """Phase 11 (d) on the model folder ``folder`` for each frame seed:
    eight frames of its frozen run labelled by the oracle, then
    ``cl.train`` on the first six (``TRAIN``, then the flagship's
    thresholds) or four (``TRAIN``) and ``cl.test`` + ``scores`` on the
    next two, for the trained model and for ``folder``'s."""
    from ..calculator.oracles import MixtureLennardJones
    from ..io.xyz import write_xyz

    oracle = MixtureLennardJones(otf.EPS, otf.SIG, rc=otf.RC)
    for seed in seeds:
        frames = ob.label(ob.md_frames(folder, system(), n=8, every=25,
                                       device=device, seed=seed), oracle)
        cases = [("train_6", 6, ob.TRAIN), ("flagship_6", 6, FLAGSHIP),
                 ("train_4", 4, ob.TRAIN)]
        for name, n, thresholds in cases:
            d = os.path.join(work, f"seed{seed}_{name}")
            os.makedirs(d)
            os.chdir(d)
            write_xyz("data.extxyz", frames[:n])
            write_xyz("heldout.extxyz", frames[n:n + 2])
            size, wall = ob.train(d, device, **thresholds)
            sc = ob.held_out(d, "train", device, pckl="train.pckl")
            p5 = ob.held_out(d, "phase5", device, covariance=folder,
                             pckl=None)
            emit(offline=name, seed=seed, train_frames=n, size=list(size),
                 train_s=wall, r2=sc["forces"]["r2"],
                 r2_bar=ob.TRAIN_R2_BAR, phase5_mae=p5["forces"]["mae"],
                 mae_bound=otf.OTF_F_MAE_BOUND, **thresholds)


def band_margins(folder, stages, system=otf.make_lgps_system,
                 device="cuda"):
    """Phase 9's committee grown from ``folder``'s ``bcm_1.pckl`` and its
    Li vacancy hop band, as phase 9 (a) and (f) make them; after each of
    ``stages`` runs of 100 iterations (the first to fmax 0.05, as phase
    9, the later ones to 0.01), the band's float32 force error against
    both scales."""
    import torch

    from ..opt import device_fire as dfire
    from ..opt import device_neb as dneb
    from ..opt.neb import interpolate_images
    from . import bcm_bench as bb

    calc = bb.committee(folder, max_inducing=PHASE9["max_inducing"],
                        max_data=PHASE9["max_data"], device=device,
                        dtype=torch.float32)
    g = bb.grow(calc, system(), wall_cap=PHASE9["grow_wall_cap"])
    emit(committee=g["sizes"], experts=g["experts"], grow_s=g["wall_s"])
    calc._calc = None  # frozen, as phase 9 (b) leaves it for (c)-(f)
    ends = bb.lgps_vacancy_hop(system())
    for im in ends:
        im.calc = calc
        dfire.DeviceFIRE(im, calc, chunk=bb.CHUNK, check_beta=False).run(
            fmax=0.05, steps=PHASE9["neb_end_steps"])
    images = interpolate_images(ends[0], ends[1], 7)
    for im in images:
        im.calc = calc
    band = dneb.DeviceNEB(images, calc, k=0.1, climb=True, dt=0.05,
                          maxstep=0.1, chunk=bb.CHUNK, check_beta=False)
    for stage in range(stages):
        band.run(fmax=0.05 if stage == 0 else 0.01,
                 steps=PHASE9["neb_steps"])
        de, e_scale, df, f_scale, f_net, _ = db.band_rel_err(band)
        emit(band_stage=stage + 1, iterations=band.nsteps, fmax=band.fmax,
             barrier=band.barrier(), f_err=df, slot_scale=f_scale,
             net_f=f_net, rel_slot=df / f_scale, rel_net=df / f_net,
             tol=db.BAND_F_TOL, e_rel=de / e_scale)


def main(argv=None):
    import torch

    from ..descriptor import soap_kernels as sk
    from ..io.model_io import save_model
    from .soap_bench import card_line

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seeds", type=int, default=4)
    parser.add_argument("--stages", type=int, default=4)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("check_margins needs a CUDA card")
    emit(card=card_line())
    t0 = time.time()
    sk.build_library(force=True)
    work = tempfile.mkdtemp(prefix="check_margins_")
    out, calc = otf.measure_otf(device="cuda", dtype=torch.float32, **PHASE5)
    folder = os.path.join(work, "committee")
    os.makedirs(folder)
    learned = os.path.join(folder, "bcm_1.pckl")
    save_model(calc.model, learned)
    del calc
    emit(phase5={k: out[k] for k in ("final_m", "final_ndata",
                                     "f_mae_vs_oracle")},
         wall_s=time.time() - t0)
    offline_margins(learned, [21 + 10 * k for k in range(args.seeds)],
                    work)
    emit(offline_wall_s=time.time() - t0)
    if args.stages:
        band_margins(folder, args.stages)
    emit(ok=True, wall_s=time.time() - t0)


if __name__ == "__main__":
    main()
