"""Times and work counts of the SOAP-coefficient kernels on a CUDA card.

``chip_smoke.py`` uses the helpers (systems, kernel inputs, the bound's
byte and operation counts, device timers).  Run as a script, this module
times the kernels of this tree against those built from other sources of
``csrc/soap_coeff.cu`` (for example the previous commit's, or variants
with a phase cut out), in turns inside one process (the others, the tree
twice, the others in reverse), at the three timing shapes:

    git show HEAD~1:autoforce_tpu_torch/csrc/soap_coeff.cu > scratch_checkout/parent.cu
    python -m autoforce_tpu_torch.tools.soap_bench --other scratch_checkout/parent.cu

Each other source must keep the plain C entry points ``soap_coeff_fwd`` and
``soap_coeff_bwd``; all are compiled at once, with ``build_library``'s
flags, into the git-ignored build directory.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
MODEL = os.path.join(ROOT, "baselines", "bench_model.pckl")
MODEL_MS = os.path.join(ROOT, "baselines", "bench_model_ms.pckl")
REPS_MD = (6, 6, 7)  # 4 * 252 = 1008 atoms
REPS_10K = (13, 14, 14)  # 4 * 2548 = 10192 atoms
SKIN = 1.2
# published H100 SXM peaks (NVIDIA data sheet), the bound's denominators
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}
# a valid slot at or beyond rc costs only its distance test: scale by the
# radius (3), squared distance (5), sqrt, times the radius, compare
TEST_OPS = 11


# ---------------------------------------------------------------- systems


def bench_system(reps=REPS_MD):
    """``bench.make_system(reps)``: fcc Cu, a = 3.6, rattled 0.05, seed 1."""
    from ..system import bulk_fcc

    s = bulk_fcc("Cu", 3.6).repeat(reps)
    s.rattle(0.05, seed=1)
    return s


def ms_system():
    """``bench.make_ms_system((6, 6, 7))``: 4 species on an fcc host."""
    import numpy as np

    from ..system import bulk_fcc

    s = bulk_fcc("Cu", 3.7).repeat(REPS_MD)
    rng = np.random.default_rng(0)
    s.numbers[:] = rng.choice([3, 32, 15, 16], size=len(s),
                              p=[0.4, 0.04, 0.08, 0.48])
    s.rattle(0.02, seed=1)
    return s


def md_bucket(system, rc):
    """The neighbor bucket K that ``ActiveCalculator`` gives at rc + skin."""
    from ..neighbors import neighbor_table, round_up

    kmax = neighbor_table(system.positions, system.cell, system.pbc, rc + SKIN).kmax
    return round_up(int(kmax * 1.2) + 4, 16)


def kernel_inputs(eng, system, kpad=None, cutoff=None):
    """(rvec, sidx, mask, radii) of the descriptor call of ``predict`` on
    ``system``: the kernels' inputs on the main path."""
    from ..engine import _env_rvec
    from ..neighbors import neighbor_table

    table = None
    if cutoff is not None:
        table = neighbor_table(system.positions, system.cell, system.pbc, cutoff)
    cfg = eng.make_config(system, kpad=kpad, table=table)
    with torch.no_grad():
        rvec = _env_rvec(cfg.positions, cfg.cell, cfg).contiguous()
    mask = cfg.nbr_mask & cfg.atom_mask[:, None]
    return rvec, cfg.nbr_sidx, mask, eng.radii_table()


def timing_cases(eng, eng_ms, md_inputs=None):
    """name -> (params, kernel inputs) at the three timing shapes: the MD
    bucket of the 1008-atom snapshot, the 10,192-atom snapshot at the same
    bucket rule, and the 4-species snapshot at rc."""
    rc = eng.params.rc
    if md_inputs is None:
        s = bench_system()
        md_inputs = kernel_inputs(eng, s, kpad=md_bucket(s, rc), cutoff=rc + SKIN)
    big = bench_system(REPS_10K)
    return {
        "md_bucket": (eng.params, md_inputs),
        "scale_10k": (eng.params, kernel_inputs(eng, big, kpad=md_bucket(big, rc),
                                                cutoff=rc + SKIN)),
        "multispecies": (eng_ms.params, kernel_inputs(eng_ms, ms_system())),
    }


# ------------------------------------------------------------ work counts


def slot_counts(rvec, sidx, mask, radii, rc):
    """(valid, known, live): slots the mask keeps, those of them whose
    species is in the table, and those of these whose distance is below
    rc."""
    S = radii.shape[0]
    keep = mask.bool()
    known = keep & (sidx >= 0) & (sidx < S)
    live = known & (rvec.norm(dim=-1) < rc)
    return tuple(int(t.sum().item()) for t in (keep, known, live))


def soap_work(rvec, sidx, mask, radii, params):
    """((bytes, operations) of one forward call, the same of one backward
    call, (valid, live) slot counts).

    Bytes: what the function must read, once, and write, once: the mask
    byte of every slot, the species of each kept slot, the coordinates of
    each kept slot whose species is in the table (a masked slot is the
    dummy at 2 rc whatever its row holds), the radii, and the outputs (the
    backward reads only the live m <= l cotangent channels and writes every
    slot's gradient).  Operations: the least the function needs for the
    slots these inputs hold: the full count for each live slot (d < rc),
    the distance test for each other valid slot, nothing for a masked
    one."""
    N, K, _ = rvec.shape
    S = radii.shape[0]
    esize = rvec.element_size()
    n_valid, n_known, n_live = slot_counts(rvec, sidx, mask, radii, params.rc)
    L = params.lmax + 1
    nf = params.nmax + 1
    CH = S * nf * L * L
    lm = L * (L + 1) // 2  # (l, m <= l) pairs
    # harmonics: P recursion (5 per m < l-1, 2 + 1 for m = l-1, l), C/S
    p_ops = sum(5 * max(l - 1, 0) + 3 for l in range(1, L)) + 6 * (L - 1)
    setup = 25 + nf
    fwd_slot = setup + p_ops + 2 * lm + 4 * nf * lm
    dp_ops = sum(24 * max(l - 1, 0) + 11 for l in range(1, L))
    # backward with the n-sum factored out of the angular work: per (l, m)
    # the four sums over n of cotangent x (f_n, d f_n) (8 nf), then once
    # Yr, Yi (2), the radial weight (4) and the three angular partials
    # (10 + 10 + 6); per slot the radial terms (6 nf), dC/dS (4 per m > 0)
    # and the radial weight times (x, y, z) (6)
    bwd_slot = (setup + 10 + p_ops + dp_ops + 6 * nf + lm * (8 * nf + 32)
                + 4 * (L - 1) + 6 + 3)
    tested = (n_valid - n_live) * TEST_OPS
    slot_in = N * K + n_valid * 4 + n_known * 3 * esize  # mask, sidx, rvec
    fwd_bytes = slot_in + S * esize + 2 * N * CH * esize
    bwd_bytes = slot_in + S * esize + 2 * N * S * nf * lm * esize + N * K * 3 * esize
    return ((fwd_bytes, n_live * fwd_slot + tested),
            (bwd_bytes, n_live * bwd_slot + tested), (n_valid, n_live))


def bound(nbytes, ops, dtype_name):
    """(least time in ms, "bytes" or "operations")."""
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_o = ops / PEAK_FLOPS[dtype_name] * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


# ----------------------------------------------------------------- timers


def device_ms(fn, n, match=None, warmup=3, elapsed=False):
    """Device time per call of ``fn`` (ms): the summed durations of the
    CUDA kernels it launches (those whose name holds ``match``), traced
    with torch.profiler over ``n`` calls after ``warmup`` calls; None when
    the profiler records no device kernel.  With ``elapsed``, also the
    elapsed time per call of the traced window (CUDA events), for calls
    long enough that the tracing's own cost does not count."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        a.record()
        for _ in range(n):
            fn()
        b.record()
        torch.cuda.synchronize()
    us = [ev.time_range.elapsed_us() for ev in prof.events()
          if ev.device_type == torch.autograd.DeviceType.CUDA
          and (match is None or match in ev.name)]
    ms = sum(us) / n / 1e3 if us else None
    return (ms, a.elapsed_time(b) / n) if elapsed else ms


def cuda_ms(fn, n):
    """Elapsed time per call (ms) of ``n`` back-to-back warmed calls, by
    CUDA events."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / n


# ---------------------------------------------------------------- A/B run


def card_line():
    import subprocess

    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unknown"


def print_build_report(build_log):
    """nvcc's -Xptxas -v lines: each kernel's registers, spills, barriers."""
    for line in build_log.splitlines():
        if any(w in line for w in ("registers", "spill", "Compiling entry")):
            print("  " + line.strip(), flush=True)


def build_others(srcs):
    """Start one nvcc per source, with the flags of ``build_library``, into
    the git-ignored build directory; returns a function that waits for them
    and gives the loaded libraries."""
    import subprocess

    from .. import BUILD_DIR
    from ..descriptor import soap_kernels as sk

    os.makedirs(os.path.join(BUILD_DIR, "other"), exist_ok=True)
    jobs = []
    for i, src in enumerate(srcs):
        out = os.path.join(BUILD_DIR, "other", f"libsoapcoeff_{i}.so")
        jobs.append((src, out, subprocess.Popen(
            [sk.nvcc_path(), *sk.NVCC_FLAGS, "-o", out, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))

    def wait():
        libs = []
        for src, out, proc in jobs:
            log = proc.communicate()[0]
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src}:\n{log}")
            libs.append(sk.bind_entry_points(ctypes.CDLL(out)))
        return libs

    return wait


def compare(others):
    """Device times of this tree's kernels and of each library in
    ``others`` (name -> library), in turns (the others, the tree twice, the
    others in reverse), 200 launches each, at each timing shape; returns the
    rows."""
    from ..descriptor import soap_kernels as sk
    from ..io.model_io import load_model

    libs = dict(others, tree=sk._load())
    order = [*others, "tree", "tree", *reversed(list(others))]
    eng = load_model(MODEL, device="cuda", dtype=torch.float32).engine
    eng_ms = load_model(MODEL_MS, device="cuda", dtype=torch.float32).engine
    rows = []
    for name, (params, inputs) in timing_cases(eng, eng_ms).items():
        rvec, sidx, mask, radii = sk._kernel_args(*inputs)
        N, K, _ = rvec.shape
        CH = sk.channels(radii.shape[0], params)
        g = torch.Generator(device="cuda").manual_seed(11)
        crb = torch.randn((N, CH), generator=g, device="cuda", dtype=rvec.dtype)
        cib = torch.randn((N, CH), generator=g, device="cuda", dtype=rvec.dtype)
        outs = {}
        for lname, lib in libs.items():
            cr = torch.empty_like(crb)
            ci = torch.empty_like(crb)
            rb = torch.empty_like(rvec)

            def fwd(lib=lib, cr=cr, ci=ci):
                sk._raise_if_failed(sk.launch_fwd(lib, rvec, sidx, mask, radii,
                                                  params, cr, ci), "fwd")

            def bwd(lib=lib, rb=rb):
                sk._raise_if_failed(sk.launch_bwd(lib, rvec, sidx, mask, radii,
                                                  crb, cib, params, rb), "bwd")

            fwd()
            bwd()
            outs[lname] = (fwd, bwd, cr, ci, rb)
        torch.cuda.synchronize()
        (fb, fo), (bb, bo), (n_valid, n_live) = soap_work(rvec, sidx, mask, radii,
                                                          params)
        dname = str(rvec.dtype).replace("torch.", "")
        t = outs["tree"]
        for k, (kname, nbytes, ops) in enumerate((("soap_fwd_kernel", fb, fo),
                                                   ("soap_bwd_kernel", bb, bo))):
            times = {lname: [] for lname in libs}
            for lname in order:
                times[lname].append(device_ms(outs[lname][k], 200, kname))
            diff = {}
            for lname, o in outs.items():
                if k == 0:
                    diff[lname] = max((o[2] - t[2]).abs().max().item(),
                                      (o[3] - t[3]).abs().max().item())
                else:
                    diff[lname] = (o[4] - t[4]).abs().max().item()
            b_ms, b_by = bound(nbytes, ops, dname)
            rows.append({"shape": name, "kernel": kname, "N": N, "K": K,
                         "S": radii.shape[0], "valid": n_valid, "live": n_live,
                         "ms": times, "bound_ms": b_ms, "bound_by": b_by,
                         "bytes": nbytes, "ops": ops, "max_abs_diff": diff})
            print(f"{name} {kname} N={N} K={K} S={radii.shape[0]}: bound "
                  f"{b_ms * 1e3:.2f} us ({b_by}: {nbytes / 1e6:.2f} MB, "
                  f"{ops / 1e6:.1f} Mop)", flush=True)
            for lname in libs:
                print(f"  {lname:24s} "
                      f"{', '.join(f'{x * 1e3:.2f}' for x in times[lname])} us; "
                      f"|{lname} - tree| {diff[lname]:.2e}", flush=True)
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True, nargs="+",
                    help="other soap_coeff.cu sources to time against this tree's")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("soap_bench: no CUDA device", file=sys.stderr)
        return 2
    from ..descriptor import soap_kernels as sk

    card = card_line()
    print(f"card: {card}; device 0: {torch.cuda.get_device_name(0)}", flush=True)
    srcs = [os.path.abspath(p) for p in args.other]
    wait = build_others(srcs)
    sk.build_library(force=True)
    print_build_report(sk.build_log)
    names = [os.path.splitext(os.path.basename(p))[0] for p in srcs]
    if len(set(names)) != len(names) or "tree" in names:
        raise SystemExit("soap_bench: give the other sources distinct names, none 'tree'")
    rows = compare(dict(zip(names, wait())))
    print(json.dumps({"card": card, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
