"""The port's oracle and file tools against the JAX package's (CPU,
float64): the OUTCAR reader and ``parse_slice``, the tape tools, the
socket oracle (``serve_request``, ``Server`` / ``SocketCalculator`` and
learning with ``inprocess = False``), the VASP and Gaussian adapters, the
command line's oracle names, and the LAMMPS driver (``cl/lmp.py``).

Tolerances:
  * OUTCAR frames, tape records, VASP / Gaussian parses and files, LAMMPS
    script parsing: identical (the same numpy code on the same text).
  * ``serve_request``: the port writes its reply with exact floats, so its
    frame equals the oracle's results bit for bit; the JAX package writes
    8 decimals, so the two replies agree to a unit of the 8th decimal
    (1e-8: forces, positions) and to 12 significant digits (energy,
    stress).
  * The socket round trip: within 1e-10 of the largest value of the
    in-process oracle's energy and forces (the wire carries exact floats;
    the bound leaves room for nothing but rounding).
  * Learning through the socket: the same sampling decisions (log lines),
    sizes and ``mu`` within 1e-12 as the in-process run.
  * The LAMMPS callback: pushed energy and forces within 1e-9 eV (eV/A)
    of the JAX driver's on the same state, the virial within 1e-9 of its
    largest component, with the LJ oracle and with a model trained by the
    port (float64 on the CPU in both packages).
"""

import os
import threading

import numpy as np
import pytest
import torch

import autoforce_tpu.cl as jax_cl
import autoforce_tpu_torch.cl as cl
from autoforce_tpu.calculator.oracles import LennardJones as JaxLJ
from autoforce_tpu.system import bulk_fcc as jax_bulk_fcc
from autoforce_tpu_torch.calculator.oracles import LennardJones
from autoforce_tpu_torch.system import SinglePointCalculator, bulk_fcc

from test_outcar import OUTCAR2

LJ = dict(epsilon=0.15, sigma=2.3, rc=4.0)


@pytest.fixture
def in_tmp(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    return tmp_path


def assert_frames_identical(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(y.numbers, x.numbers)
        np.testing.assert_array_equal(y.positions, x.positions)
        np.testing.assert_array_equal(np.asarray(y.cell), np.asarray(x.cell))
        np.testing.assert_array_equal(y.pbc, x.pbc)
        if x.calc is None:
            assert y.calc is None
            continue
        assert sorted(y.calc.results) == sorted(x.calc.results)
        for k, v in x.calc.results.items():
            if v is None:
                assert y.calc.results[k] is None
            else:
                np.testing.assert_array_equal(y.calc.results[k], v)


# ------------------------------------------------------------- OUTCAR
HEAD = ("POTCAR:    PAW_PBE Cu 22Jun2005\n"
        "POTCAR:    PAW_PBE O 08Apr2002\n")
COUNTS = "ions per type =               2   1"
OUTCAR_CASES = {
    "two_steps": (OUTCAR2, None),
    "last": (OUTCAR2, "-1::"),
    "every_second": (OUTCAR2, "0:2:2"),
    "bare_first": (OUTCAR2, "0"),
    "bare_last": (OUTCAR2, "-1"),
    "repeated_species": (
        OUTCAR2.replace(HEAD * 2, (HEAD + "POTCAR:    PAW_PBE Cu 22Jun2005\n")
                        * 2).replace(COUNTS, "ions per type =   1   1   1"),
        None),
    "truncated": (OUTCAR2[: OUTCAR2.rindex(" free  energy   TOTEN")], None),
}


@pytest.mark.parametrize("case", sorted(OUTCAR_CASES))
def test_outcar_frames_match_jax(case, tmp_path, capsys):
    from autoforce_tpu.io.outcar import parse_slice as jax_slice
    from autoforce_tpu.io.outcar import read_outcar_frames as jax_read
    from autoforce_tpu_torch.io.outcar import parse_slice, read_outcar_frames

    text, sl = OUTCAR_CASES[case]
    p = tmp_path / "OUTCAR"
    p.write_text(text)
    ref = jax_read(str(p), index=jax_slice(sl) if sl else None)
    jax_err = capsys.readouterr().err
    got = read_outcar_frames(str(p), index=parse_slice(sl) if sl else None)
    assert capsys.readouterr().err == jax_err
    assert_frames_identical(ref, got)
    assert len(got) == {"two_steps": 2, "repeated_species": 2}.get(case, 1)
    if case == "repeated_species":
        assert list(got[0].numbers) == [29, 8, 29]
    if case == "truncated":
        assert "incomplete" in jax_err


def test_outcar_unresolvable_species_raises_like_jax(tmp_path):
    from autoforce_tpu.io.outcar import read_outcar_frames as jax_read
    from autoforce_tpu_torch.io.outcar import read_outcar_frames

    p = tmp_path / "OUTCAR"
    p.write_text(OUTCAR2.replace(COUNTS, "ions per type =   1   1   1"))
    with pytest.raises(ValueError, match="species") as ref:
        jax_read(str(p))
    with pytest.raises(ValueError, match="species") as got:
        read_outcar_frames(str(p))
    assert str(got.value) == str(ref.value)


@pytest.mark.parametrize("text", ["::", "0:10:2", ":-1:", "5", "-1", "0",
                                  "1:", None])
def test_parse_slice_matches_jax(text):
    from autoforce_tpu.io.outcar import parse_slice as jax_slice
    from autoforce_tpu_torch.io.outcar import parse_slice

    assert parse_slice(text) == jax_slice(text)


# ------------------------------------------------------------- tape tools
def write_tape(path):
    """The tape of tests/test_cl.py::test_tape_tools, written by the port:
    two environments and one structure, two of them twice."""
    from autoforce_tpu_torch.io.tape import SgprTape
    from autoforce_tpu_torch.regression.sgpr import InducingEnv

    tape = SgprTape(path)
    env1 = InducingEnv.from_arrays(29, [[1.0, 0, 0], [0, 1.2, 0]], [29, 29])
    env2 = InducingEnv.from_arrays(29, [[1.1, 0, 0]], [29])
    s = bulk_fcc("Cu", 3.6)
    s.calc = SinglePointCalculator(s, energy=-1.0, forces=np.zeros((4, 3)))
    for obj in (env1, env1, env2, s, s):
        tape.write(obj)
    return s


@pytest.mark.parametrize("tool", ["dedup", "truncate", "slice"])
def test_tape_tools_match_jax(tool, in_tmp):
    from autoforce_tpu.io import tape_tools as jax_tools
    from autoforce_tpu.io.tape import SgprTape as JaxTape
    from autoforce_tpu_torch.io import tape_tools
    from autoforce_tpu_torch.io.tape import SgprTape
    from autoforce_tpu_torch.io.xyz import read_xyz, write_xyz

    s = write_tape("a.sgpr")
    if tool == "dedup":
        n = (jax_tools.dedup("a.sgpr", "j.sgpr"),
             tape_tools.dedup("a.sgpr", "p.sgpr"))
        assert n == (3, 3)
    elif tool == "truncate":
        n = (jax_tools.truncate("a.sgpr", "j.sgpr", 4),
             tape_tools.truncate("a.sgpr", "p.sgpr", 4))
        assert n == (4, 4)
    else:
        write_xyz("t.extxyz", [s.copy() for _ in range(10)])
        n = (jax_tools.slice_traj("t.extxyz", "j.sgpr", "1::3"),
             tape_tools.slice_traj("t.extxyz", "p.sgpr", "1::3"))
        assert n == (3, 3)
        assert_frames_identical(read_xyz("j.sgpr"), read_xyz("p.sgpr"))
    assert open("p.sgpr").read() == open("j.sgpr").read()
    if tool != "slice":
        ref = JaxTape("j.sgpr").read()
        got = SgprTape("p.sgpr").read()
        assert [c for c, _ in got] == [c for c, _ in ref]


# ------------------------------------------------------------- socket
def rattled_cu(fcc, seed, reps=(2, 1, 1)):
    s = fcc("Cu", 3.6).repeat(reps)
    s.rattle(0.05, seed=seed)
    return s


def test_serve_request_matches_jax(in_tmp):
    """One ``in:out`` request to an oracle object and one ``in:out:script``
    request naming a script (built on ``device``), in both packages."""
    from autoforce_tpu.calculator.socket import serve_request as jax_serve
    from autoforce_tpu_torch.calculator.socket import serve_request
    from autoforce_tpu_torch.io.xyz import read_xyz, write_xyz

    s = rattled_cu(bulk_fcc, 3)
    write_xyz("in.xyz", s, exact=True)
    jax_serve("in.xyz:j.xyz", JaxLJ(**LJ))
    serve_request("in.xyz:p.xyz", LennardJones(**LJ), device="cpu")
    ref, got = read_xyz("j.xyz", index=0), read_xyz("p.xyz", index=0)
    s.calc = LennardJones(**LJ)
    res = {"energy": s.get_potential_energy(), "forces": s.get_forces(),
           "stress": s.get_stress()}
    for k, v in res.items():  # the port's reply is exact
        np.testing.assert_array_equal(got.calc.results[k], v)
    np.testing.assert_array_equal(got.positions, s.positions)
    np.testing.assert_allclose(got.positions, ref.positions, rtol=0,
                               atol=1e-8)
    np.testing.assert_allclose(got.get_forces(), ref.get_forces(), rtol=0,
                               atol=1e-8)
    np.testing.assert_allclose(got.get_potential_energy(),
                               ref.get_potential_energy(), rtol=1e-11)
    np.testing.assert_allclose(got.get_stress(), ref.get_stress(), rtol=1e-11,
                               atol=1e-15)
    # a script in the request: the package's LJ script, built on the CPU
    from autoforce_tpu_torch.calculator import scripts

    script = os.path.join(os.path.dirname(scripts.__file__), "lj.py")
    serve_request(f"in.xyz:q.xyz:{script}", device="cpu")
    q = read_xyz("q.xyz", index=0)
    np.testing.assert_array_equal(q.get_forces(),
                                  LennardJones().calculate(s)["forces"])


def start_server(callback_args):
    """A port ``Server`` on a port the OS chose, listening in a daemon
    thread."""
    from autoforce_tpu_torch.calculator.socket import Server, serve_request

    server = Server("localhost", 0, callback=serve_request,
                    args=callback_args)
    t = threading.Thread(target=server.listen, daemon=True)
    t.start()
    return server, t


def test_socket_round_trip(in_tmp):
    from autoforce_tpu_torch.calculator.socket import SocketCalculator

    lj = LennardJones(**LJ)
    server, t = start_server((lj, "cpu"))
    sc = SocketCalculator(port=server.port)
    assert sc.ping() == "!"
    try:
        for seed in range(3):
            s = rattled_cu(bulk_fcc, seed, reps=(2, 2, 1))
            res = sc.calculate(s)
            ref = lj.calculate(s)
            for k in ("energy", "forces", "stress"):
                scale = np.abs(ref[k]).max()
                assert np.abs(res[k] - ref[k]).max() <= 1e-10 * scale, k
            assert not os.path.exists("socket_send.xyz")
            assert not os.path.exists("socket_recv.xyz")
    finally:
        sc.close()
        t.join(timeout=5)
    assert not t.is_alive()


def test_socket_reports_a_failed_oracle(in_tmp):
    """The server answers -1 when the oracle raises, and keeps serving."""
    from autoforce_tpu_torch.calculator.socket import SocketCalculator

    class Broken:
        def calculate(self, system):
            raise ValueError("broken oracle")

    server, t = start_server((Broken(), "cpu"))
    sc = SocketCalculator(port=server.port)
    try:
        with pytest.raises(RuntimeError, match="SocketCalculator failed"):
            sc.calculate(rattled_cu(bulk_fcc, 0))
        assert sc.ping() == "!"
    finally:
        sc.close()
        t.join(timeout=5)
    assert not t.is_alive()


def learn_log(tmp, name, port=None):
    """A short host Langevin learning run of ``gen_active_calc`` on the
    32-atom EMT Cu box, with the oracle in this process or behind the
    socket; returns the calculator and its log without time stamps."""
    from autoforce_tpu_torch import units
    from autoforce_tpu_torch.md import Langevin
    from autoforce_tpu_torch.system import maxwell_boltzmann_velocities

    d = tmp / name
    d.mkdir()
    os.chdir(d)
    lines = ["calculator = 'EMT'", "calc_device = 'cpu'",
             "dtype = 'float64'", "logfile = 'active.log'", "pckl = None",
             "tape = None", "kernel_kw = dict(cutoff=4.5, lmax=2, nmax=2)",
             "ediff = 0.005", "ediff_tot = 0.005", "fdiff = 1e-4", "seed = 0",
             "ioptim = 0"]
    if port is not None:
        lines += ["inprocess = False", f"socket_port = {port}"]
    (d / "ARGS").write_text("\n".join(lines) + "\n")
    cl.refresh()
    calc = cl.gen_active_calc()
    s = bulk_fcc("Cu", 3.6).repeat((2, 2, 2))
    s.rattle(0.05, seed=0)
    s.calc = calc
    maxwell_boltzmann_velocities(s, 600, seed=1)
    Langevin(s, 2 * units.fs, 600, friction=0.01, seed=2).run(12)
    log = [ln.split(None, 2)[2] for ln in open("active.log")]
    return calc, log


def test_socket_learning_matches_inprocess(tmp_path, monkeypatch):
    """The same learning run with the EMT oracle in this process and
    behind the socket: the same sampling decisions, sizes and mu."""
    from autoforce_tpu_torch.calculator.socket import SocketCalculator

    monkeypatch.chdir(tmp_path)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # sum order: the decisions are threshold tests
    try:
        ref, ref_log = learn_log(tmp_path, "inprocess")
        server, t = start_server((None, "cpu"))
        try:
            got, got_log = learn_log(tmp_path, "socket", port=server.port)
            assert isinstance(cl.ARGS["calculator"], SocketCalculator)
            assert cl.ARGS["calculator"].port == server.port
        finally:
            SocketCalculator(port=server.port).close()
            t.join(timeout=5)
    finally:
        torch.set_num_threads(threads)
        cl.ARGS.clear()
    assert not t.is_alive()
    assert got_log == ref_log
    assert got.size == ref.size and ref.size[1] > 1
    assert got.event_counts["fp_calls"] == ref.event_counts["fp_calls"] > 1
    np.testing.assert_allclose(got.model.mu, ref.model.mu, rtol=0,
                               atol=1e-12 * np.abs(ref.model.mu).max())


# ------------------------------------------------------------- the names
@pytest.mark.parametrize("line,cls", [
    ("calculator = 'VASP'", "VaspCalculator"),
    ("calculator = 'GAUSSIAN'", "GaussianCalculator"),
    ("calculator = 'LJ'\ninprocess = False", "SocketCalculator"),
])
def test_cl_resolves_oracles_like_jax(line, cls, in_tmp):
    """``calculator = 'VASP' | 'GAUSSIAN'`` and ``inprocess = False``
    resolve to the port's adapters and socket client, as to the JAX
    package's."""
    from autoforce_tpu_torch.calculator import gaussian, socket, vasp

    (in_tmp / "ARGS").write_text(line + "\ncalc_device = 'cpu'\n")
    try:
        jax_cl.refresh()
        ref = jax_cl.ARGS["calculator"]
        cl.refresh()
        got = cl.ARGS["calculator"]
    finally:
        (in_tmp / "ARGS").unlink()
        jax_cl.refresh()
        cl.ARGS.clear()
    mod = {"VaspCalculator": vasp, "GaussianCalculator": gaussian,
           "SocketCalculator": socket}[cls]
    assert type(got) is getattr(mod, cls)
    assert type(ref).__name__ == cls
    if cls == "SocketCalculator":
        assert (got.ip, got.port) == (ref.ip, ref.port) == ("localhost", 6666)
        assert os.path.basename(got.script) == os.path.basename(ref.script)


# ------------------------------------------------------------- VASP
from test_misc_utils import OUTCAR as VASP_OUTCAR  # noqa: E402


def test_vasp_read_outcar_matches_jax(tmp_path):
    from autoforce_tpu.calculator.vasp import read_outcar as jax_read
    from autoforce_tpu_torch.calculator.vasp import read_outcar

    for text in (VASP_OUTCAR, OUTCAR2):
        p = tmp_path / "OUTCAR"
        p.write_text(text)
        for a, b in zip(jax_read(str(p)), read_outcar(str(p))):
            np.testing.assert_array_equal(b, a)


def fake_program(tmp_path, name, body):
    fake = tmp_path / name
    fake.write_text(body)
    return f"python {fake}"


def test_vasp_subprocess_round_trip_matches_jax(in_tmp):
    """POSCAR written, a fake VASP command run, its OUTCAR parsed, in both
    packages; the POSCARs they write are the same."""
    from autoforce_tpu.calculator.vasp import VaspCalculator as JaxVasp
    from autoforce_tpu_torch.calculator.vasp import VaspCalculator

    cmd = fake_program(in_tmp, "fake_vasp.py",
                       "import pathlib\n"
                       "assert pathlib.Path('POSCAR').exists()\n"
                       f"pathlib.Path('OUTCAR').write_text({VASP_OUTCAR!r})\n")
    ref = JaxVasp(directory=str(in_tmp / "j"), command=cmd).calculate(
        rattled_cu(jax_bulk_fcc, 1))
    got = VaspCalculator(directory=str(in_tmp / "p"), command=cmd).calculate(
        rattled_cu(bulk_fcc, 1))
    assert sorted(got) == sorted(ref) == ["energy", "forces", "stress"]
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k])
    # the first line names the package
    assert ((in_tmp / "p" / "POSCAR").read_text().splitlines()[1:]
            == (in_tmp / "j" / "POSCAR").read_text().splitlines()[1:])


# ------------------------------------------------------------- Gaussian
GAUSSIAN_LOG = """\
 SCF Done:  E(RB3LYP) =  -1640.12345678     A.U. after   12 cycles
 -------------------------------------------------------------------
 Center     Atomic                   Forces (Hartrees/Bohr)
 Number     Number              X              Y              Z
 -------------------------------------------------------------------
      1       29           0.001000000    0.002000000   -0.003000000
      2       29          -0.001000000   -0.002000000    0.003000000
 -------------------------------------------------------------------
 SCF Done:  E(RB3LYP) =  -1640.23456789     A.U. after    8 cycles
 -------------------------------------------------------------------
 Center     Atomic                   Forces (Hartrees/Bohr)
 Number     Number              X              Y              Z
 -------------------------------------------------------------------
      1       29           0.000500000    0.001000000   -0.001500000
      2       29          -0.000500000   -0.001000000    0.001500000
 -------------------------------------------------------------------
"""
TEMPLATE = "%mem=2GB\n#P force pbe1pbe/def2svp\n\ntitle\n\n0 2\nCu 0 0 0\n"


def cu_dimer(mod):
    return mod.System(numbers=[29, 29], positions=[[0, 0, 0], [2.2, 0.1, 0]])


@pytest.mark.parametrize("template", [False, True])
def test_gaussian_write_gjf_matches_jax(template, in_tmp):
    import autoforce_tpu.system as jax_system
    import autoforce_tpu_torch.system as system
    from autoforce_tpu.calculator.gaussian import write_gjf as jax_write
    from autoforce_tpu_torch.calculator.gaussian import write_gjf

    if template:
        (in_tmp / "template.gjf").write_text(TEMPLATE)
    jax_write("j.gjf", cu_dimer(jax_system))
    write_gjf("p.gjf", cu_dimer(system))
    text = open("p.gjf").read()
    assert text == open("j.gjf").read()
    assert ("0 2" in text and "pbe1pbe" in text) == template


def test_gaussian_read_log_matches_jax(tmp_path):
    from autoforce_tpu.calculator.gaussian import read_log as jax_read
    from autoforce_tpu_torch.calculator.gaussian import read_log
    from autoforce_tpu_torch.units import Bohr, Hartree

    p = tmp_path / "calc.log"
    p.write_text(GAUSSIAN_LOG)
    e, f = read_log(str(p), 2)
    e0, f0 = jax_read(str(p), 2)
    assert e == e0 == pytest.approx(-1640.23456789 * Hartree)
    np.testing.assert_array_equal(f, f0)
    np.testing.assert_allclose(f[0], np.array([5e-4, 1e-3, -1.5e-3])
                               * Hartree / Bohr)


def test_gaussian_subprocess_round_trip_matches_jax(in_tmp):
    """calc.gjf written, a fake Gaussian command run, its log parsed and
    the single-atom energies subtracted, in both packages."""
    import autoforce_tpu.system as jax_system
    import autoforce_tpu_torch.system as system
    from autoforce_tpu.calculator.gaussian import GaussianCalculator as JaxG
    from autoforce_tpu_torch.calculator.gaussian import GaussianCalculator

    cmd = fake_program(in_tmp, "fake_g16.py",
                       "import pathlib, sys\n"
                       "assert 'force' in pathlib.Path(sys.argv[1]).read_text()\n"
                       f"pathlib.Path('calc.log').write_text({GAUSSIAN_LOG!r})\n")
    sub = {29: -1640.0}
    ref = JaxG(command=cmd, subtract_atoms=sub).calculate(cu_dimer(jax_system))
    gjf = open("calc.gjf").read()
    os.remove("calc.log")
    got = GaussianCalculator(command=cmd, subtract_atoms=sub).calculate(
        cu_dimer(system))
    assert open("calc.gjf").read() == gjf
    assert sorted(got) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k])


# ------------------------------------------------------------- LAMMPS
from test_lmp import SCRIPT, FakeLammps  # noqa: E402


def test_lammps_script_matches_jax(tmp_path):
    from autoforce_tpu.cl.lmp import LammpsScript as JaxScript
    from autoforce_tpu.cl.lmp import read_lammps_file as jax_read
    from autoforce_tpu_torch.cl.lmp import LammpsScript, read_lammps_file

    for units_ in ("metal", "real"):
        p = tmp_path / f"in.{units_}"
        p.write_text(SCRIPT.format(units=units_))
        assert vars(LammpsScript.parse(p)) == vars(JaxScript.parse(p))
        assert read_lammps_file(p) == jax_read(p)
        assert LammpsScript.parse(p).units == units_


@pytest.mark.parametrize("text,match", [
    ("units metal\nrun 1\n", "fix AutoForce"),
    ("units metal\nfix AutoForce all external pf/callback 1 1\n",
     "atomic_numbers"),
])
def test_lammps_script_errors_match_jax(text, match, tmp_path):
    from autoforce_tpu.cl.lmp import LammpsScript as JaxScript
    from autoforce_tpu_torch.cl.lmp import LammpsScript

    p = tmp_path / "bad.lammps"
    p.write_text(text)
    with pytest.raises(RuntimeError, match=match) as ref:
        JaxScript.parse(p)
    with pytest.raises(RuntimeError, match=match) as got:
        LammpsScript.parse(p)
    assert str(got.value) == str(ref.value)


@pytest.fixture(scope="module")
def port_model(tmp_path_factory):
    """A model folder trained by the port's ``cl.train`` on the CPU (float64)
    from four LJ-labelled 4-atom Cu frames (tests/test_cl.py's setup)."""
    from autoforce_tpu_torch.cl.train import train
    from autoforce_tpu_torch.io.xyz import write_xyz

    d = tmp_path_factory.mktemp("lmp_model")
    cwd = os.getcwd()
    os.chdir(d)
    try:
        frames = []
        for k in range(4):
            s = bulk_fcc("Cu", 3.6)
            s.rattle(0.08, seed=k)
            s.calc = SinglePointCalculator(s, **LennardJones(**LJ).calculate(s))
            frames.append(s)
        write_xyz("data.extxyz", frames)
        (d / "ARGS").write_text(
            "kernel_kw = dict(cutoff=4.0, lmax=2, nmax=2)\npckl = 'model.pckl'\n"
            "tape = None\nlogfile = None\nediff = 0.01\nfdiff = 0.05\n"
            "calc_device = 'cpu'\ndtype = 'float64'\n")
        cl.refresh()
        calc = train(["data.extxyz"])
        assert calc.size[1] >= 1
    finally:
        cl.ARGS.clear()
        os.chdir(cwd)
    return str(d / "model.pckl")


@pytest.mark.parametrize("oracle", ["lj", "model"])
@pytest.mark.parametrize("lmp_units", ["metal", "real"])
def test_lammps_callback_matches_jax(lmp_units, oracle, request):
    """The fix-external callback of both packages on the same LAMMPS state
    (tests/test_lmp.py's mocked handle): energy, forces and virial pushed
    in LAMMPS units, and permuted tags permuting the forces."""
    from autoforce_tpu.cl.lmp import LammpsDriver as JaxDriver
    from autoforce_tpu_torch.cl.lmp import LammpsDriver

    if oracle == "lj":
        calcs = (JaxLJ(**LJ), LennardJones(**LJ))
    else:
        from autoforce_tpu.calculator.active import ActiveCalculator as JaxCalc
        from autoforce_tpu_torch.calculator.active import ActiveCalculator

        folder = request.getfixturevalue("port_model")
        kw = dict(covariance=folder, calculator=None, logfile=None, pckl=None,
                  tape=None)
        calcs = (JaxCalc(**kw), ActiveCalculator(device="cpu",
                                                 dtype=torch.float64, **kw))
    pushed = []
    for fcc, calc, Driver in ((jax_bulk_fcc, calcs[0], JaxDriver),
                              (bulk_fcc, calcs[1], LammpsDriver)):
        s = rattled_cu(fcc, 0)
        fake = FakeLammps(s)
        driver = Driver(fake, calc, lmp_units, {1: 29}, "AutoForce")
        n = len(s)
        fext = np.zeros((n, 3))
        driver(None, 0, n, np.arange(1, n + 1), None, fext)
        perm = np.random.default_rng(1).permutation(n)
        fext2 = np.zeros((n, 3))
        s.positions[3] += 0.02  # LAMMPS moved an atom
        driver(None, 1, n, perm + 1, None, fext2)
        pushed.append((fake.pushed, fext, fext2))
    (ref, f_ref, f2_ref), (got, f_got, f2_got) = pushed
    assert ref["energy"][0] == got["energy"][0] == "AutoForce"
    tol = 1e-9 / (1.0 if lmp_units == "metal" else 0.0433641)  # 1e-9 eV
    np.testing.assert_allclose(got["energy"][1], ref["energy"][1], rtol=0,
                               atol=tol)
    np.testing.assert_allclose(f_got, f_ref, rtol=0, atol=tol)
    np.testing.assert_allclose(f2_got, f2_ref, rtol=0, atol=tol)
    np.testing.assert_allclose(got["virial"][1], ref["virial"][1], rtol=0,
                               atol=1e-9 * np.abs(ref["virial"][1]).max())
    assert not np.allclose(f2_got[np.argsort(perm)], f_got)
