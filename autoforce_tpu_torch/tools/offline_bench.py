"""The offline workflow and the out-of-process oracle on a CUDA card
(phase 11 of ``chip_smoke.py``): the pieces its steps share.

* :func:`oracle_script` writes the flagship's oracle, ``MixtureLennardJones
  (EPS, SIG, rc=RC)`` of :mod:`.otf_bench`, as a script that a calculation
  server loads;
* :func:`start_server` / :func:`stop_server` run ``python -m
  autoforce_tpu_torch.calculator.calc_server`` on a free localhost port
  chosen by the OS, as a process of its own;
* :func:`write_args` writes an ARGS file for the command line,
  :func:`learn_args` the flagship's model and thresholds in it;
* :func:`md_frames` takes frames of a frozen ``DeviceMD`` run of a model
  folder at 400 K, :func:`label` labels them with the flagship's oracle;
* :func:`train` runs ``cl.train`` on ``data.extxyz`` and :func:`held_out`
  ``cl.test`` with ``scores`` on ``heldout.extxyz``, at :data:`TRAIN`'s
  thresholds by default (phase 11 (d));
* :class:`FakeLammps` stands in for the four methods of the ``lammps``
  handle that ``cl/lmp.py`` calls, as tests/test_lmp.py builds one.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import time

import numpy as np

from .. import units
from .otf_bench import EPS, LMAX, NMAX, RC, SIG, SKIN

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
ORACLE = (
    "from autoforce_tpu_torch.calculator.oracles import MixtureLennardJones\n"
    "from autoforce_tpu_torch.tools.otf_bench import EPS, RC, SIG\n"
    "\n"
    "calc = MixtureLennardJones(EPS, SIG, rc=RC)\n"
)
# the held-out force R2 that a model trained offline must reach
# (tests/test_cl.py's bar for cl.train + cl.test), and the sampling
# thresholds of that training (ediff in kcal/mol, fdiff in eV/A).  On six
# 1024-atom frames of phase 5's model's MD, the flagship's thresholds
# (ediff 2 kcal/mol, fdiff 1.5 times that) sample (2-3, 267-327) and
# reach R2 0.738-0.763 over six frame sets; these reach 0.882-0.883 on
# two, and 0.852-0.888 on four frames over six (tools/check_margins.py on
# an H100, PERF.md)
TRAIN_R2_BAR = 0.8
TRAIN = dict(ediff_kcal_mol=1.0, fdiff=0.05)


def oracle_script(path):
    """Write the flagship's oracle as a server script; returns ``path``."""
    with open(path, "w") as f:
        f.write(ORACLE)
    return path


def free_port():
    """A localhost port that the OS reports free."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def start_server(script, log_path, device="cuda", timeout=20.0):
    """Start a calculation server serving ``script`` on a free localhost
    port, its output to ``log_path``; returns (process, port) once it
    answers a ping, or raises after ``timeout`` seconds."""
    from ..calculator.socket import SocketCalculator

    port = free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (ROOT, env.get("PYTHONPATH")) if p)
    with open(log_path, "w") as log:
        proc = subprocess.Popen(
            [sys.executable, "-m", "autoforce_tpu_torch.calculator.calc_server",
             "-ip", "localhost", "-port", str(port), "-calc", script,
             "--device", device],
            stdout=log, stderr=subprocess.STDOUT, env=env)
    t0 = time.time()
    while True:
        try:
            if SocketCalculator(port=port).ping() == "!":
                return proc, port
        except OSError:
            pass
        if proc.poll() is not None or time.time() - t0 > timeout:
            proc.kill()
            proc.wait()
            raise RuntimeError(f"the calculation server did not answer on "
                               f"port {port} within {timeout:g} s")
        time.sleep(0.2)


def stop_server(proc, port, timeout=10.0):
    """Send ``end`` and wait for the server; returns its exit code (killed
    after ``timeout`` seconds: then not 0)."""
    from ..calculator.socket import SocketCalculator

    if proc.poll() is None:
        try:
            SocketCalculator(port=port).close()
        except OSError:
            pass
    try:
        return proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        return -9


def write_args(path, **kw):
    """An ARGS file of ``key = repr(value)`` lines."""
    with open(os.path.join(path, "ARGS"), "w") as f:
        for k, v in kw.items():
            f.write(f"{k} = {v!r}\n")


def learn_args(device, ediff_kcal_mol=2.0, fdiff=None):
    """ARGS of the flagship's model and learning (otf_bench.measure_otf):
    its kernel, ``ediff_tot`` and noise, at the sampling thresholds given
    (the flagship's by default: ediff 2 kcal/mol, fdiff 1.5 times that)."""
    ediff = ediff_kcal_mol * units.kcal_mol
    flagship = 2 * units.kcal_mol
    return dict(kernel_kw=dict(cutoff=RC, lmax=LMAX, nmax=NMAX),
                ediff=ediff, ediff_tot=2 * flagship,
                fdiff=1.5 * ediff if fdiff is None else fdiff, noise_f=0.01,
                max_inducing=1024, skin=SKIN, logfile="active.log",
                calc_device=device)


def serve_args(device):
    """ARGS of a calculator that only predicts."""
    return dict(skin=SKIN, logfile=None, tape=None, calc_device=device)


def md_frames(folder, system, n=8, every=25, temperature_K=400, skin=1.2,
              device="cuda", seed=21):
    """``n`` frames of a frozen ``DeviceMD`` run (2 fs, friction 0.05, the
    trip off) of the model folder ``folder`` from ``system``, one every
    ``every`` steps; velocities from ``seed``, the thermostat's noise from
    ``seed + 1``."""
    from .. import units
    from ..calculator.active import ActiveCalculator
    from ..md.device_md import DeviceMD
    from ..system import maxwell_boltzmann_velocities

    calc = ActiveCalculator(covariance=folder, calculator=None, skin=skin,
                            logfile=None, pckl=None, tape=None, device=device)
    s = system.copy()
    s.calc = calc
    maxwell_boltzmann_velocities(s, temperature_K, seed=seed)
    dyn = DeviceMD(s, calc, dt=2 * units.fs, temperature_K=temperature_K,
                   friction=0.05, chunk=every, check_beta=False, seed=seed + 1)
    frames = []
    for _ in range(n):
        dyn.run(every)
        f = s.copy()
        f.calc = None
        frames.append(f)
    return frames


def label(frames, oracle):
    """Each frame with the oracle's energy and forces attached."""
    from ..system import SinglePointCalculator

    for f in frames:
        f.calc = SinglePointCalculator(f, **oracle.calculate(f))
    return frames


def train(work, device, **thresholds):
    """``cl.train`` from seed on ``work``'s ``data.extxyz`` at ``thresholds``
    (:data:`TRAIN` by default), into ``train.pckl`` and ``train.sgpr``;
    returns ((ndata, m), wall seconds)."""
    from .. import cl
    from ..cl import train as cl_train

    write_args(work, pckl="train.pckl", tape="train.sgpr",
               **learn_args(device, **(thresholds or TRAIN)))
    cl.refresh()
    t0 = time.time()
    calc = cl_train.train(["data.extxyz"])
    return tuple(calc.size), time.time() - t0


def held_out(work, name, device, **args):
    """``cl.test`` on ``work``'s ``heldout.extxyz`` with the model that
    ``args`` name (``pckl``, or ``covariance``), then ``scores`` of its
    ``{name}_ML`` / ``{name}_FP.extxyz``."""
    from .. import cl
    from ..cl import test as cl_test
    from ..regression.scores import compare_trajectories

    write_args(work, **serve_args(device), **args)
    cl.refresh()
    cl_test.test("heldout.extxyz", out_ml=f"{name}_ML.extxyz",
                 out_fp=f"{name}_FP.extxyz")
    return compare_trajectories(f"{name}_ML.extxyz", f"{name}_FP.extxyz")


class FakeLammps:
    """The ``lammps`` handle's four methods that ``cl/lmp.py`` calls, on a
    system held here (tests/test_lmp.py's stand-in): the box, the gathered
    positions and types, and the pushed energy and virial."""

    def __init__(self, system):
        self.system = system
        self.pushed = {}

    def extract_box(self):
        c = np.asarray(self.system.cell)
        if not np.allclose(c, np.triu(c)):
            raise ValueError("the stand-in box needs an upper-triangular cell")
        return ((0.0, 0.0, 0.0), (c[0, 0], c[1, 1], c[2, 2]), c[0, 1],
                c[1, 2], c[0, 2], self.system.pbc, None)

    def gather_atoms(self, name, t, count):
        if name == "x":
            return self.system.positions.reshape(-1).copy()
        if name == "type":
            return np.ones(len(self.system), dtype=int)
        raise KeyError(name)

    def fix_external_set_energy_global(self, fix_id, e):
        self.pushed["energy"] = (fix_id, float(e))

    def fix_external_set_virial_global(self, fix_id, v):
        self.pushed["virial"] = (fix_id, np.asarray(v).copy())
