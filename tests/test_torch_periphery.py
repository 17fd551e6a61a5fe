"""The port's periphery against the JAX package's (CPU): the analysis
helpers (``simplesim``, ``statsutil``, ``rdf``, ``trajectory``,
``structgen``, ``logs``, ``symmetry``, ``visual``), the ASE adapter and
``remote``.  The tests mirror tests/test_misc_utils.py (simplesim,
statsutil), tests/test_structgen.py, tests/test_meta_analysis.py
(``test_rdf_fcc``, ``test_traj_analyser``) and tests/test_remote_visual.py
with both packages on the same numpy-seeded inputs.

Tolerances: where both sides compute in numpy (everything but the
SGPR energies) the results are held bit for bit; a ``StructureSearch``
ranked by the port's ``ActiveCalculator`` against the JAX package's, on
one model carried over by ``io.convert.sgpr_model_from_jax``, holds the
same parents and energies within 1e-10 relative (float64; both sum the
same terms in other orders)."""

import importlib
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from autoforce_tpu.analysis import simplesim as jax_simplesim
from autoforce_tpu.analysis import statsutil as jax_stats
from autoforce_tpu.analysis import structgen as jax_structgen
from autoforce_tpu.analysis import trajectory as jax_traj
from autoforce_tpu.calculator import ase_adapter as jax_ase
from autoforce_tpu.calculator.active import ActiveCalculator as JaxCalc
from autoforce_tpu.calculator.oracles import MixtureLennardJones as JaxMLJ
from autoforce_tpu.system import bulk_fcc as jax_bulk_fcc
from autoforce_tpu_torch import analysis, remote
from autoforce_tpu_torch.analysis import simplesim, statsutil, structgen
from autoforce_tpu_torch.analysis import trajectory as traj
from autoforce_tpu_torch.calculator import ase_adapter
from autoforce_tpu_torch.calculator.active import ActiveCalculator
from autoforce_tpu_torch.calculator.oracles import MixtureLennardJones
from autoforce_tpu_torch.io.convert import sgpr_model_from_jax
from autoforce_tpu_torch.system import bulk_fcc

# the packages' ``analysis.rdf`` names the function: the modules by path
jax_rdf_mod = importlib.import_module("autoforce_tpu.analysis.rdf")
rdf_mod = importlib.import_module("autoforce_tpu_torch.analysis.rdf")
F64 = dict(device="cpu", dtype=torch.float64)
EPS = {(29, 29): 0.15, (47, 47): 0.12}
SIG = {(29, 29): 2.3, (47, 47): 2.9}
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def both(make):
    """``make(bulk_fcc)`` in the JAX package and in the port."""
    return make(jax_bulk_fcc), make(bulk_fcc)


def same(a, b):
    np.testing.assert_array_equal(np.asarray(b), np.asarray(a))


# ------------------------------------------------------------ simplesim
def rattled(fcc, reps=(2, 2, 2), rattle=0.05, seed=0):
    s = fcc("Cu", 3.6).repeat(reps)
    s.rattle(rattle, seed=seed)
    return s


def test_simplesim_matches_jax():
    js, ts = both(rattled)
    jsim = jax_simplesim.SimpleSim(js, cutoff=4.5)
    tsim = simplesim.SimpleSim(ts, cutoff=4.5)
    for (jz, jd), (tz, td) in zip(jsim.data, tsim.data):
        same(jz, tz)
        same(jd, td)
    for i, j in ((0, 0), (0, 3), (3, 0), (5, 17), (31, 2)):
        assert tsim(i, j) == jsim(i, j)
    assert tsim(0, 0) == pytest.approx(1.0)
    assert 0.0 < tsim(0, 3) <= 1.0 + 1e-12


def test_simplesim_distinguishes_perturbed_environment():
    ideal = simplesim.SimpleSim(bulk_fcc("Cu", 3.6).repeat((2, 2, 2)),
                                cutoff=4.5)
    assert ideal(0, 5) == pytest.approx(1.0, abs=1e-9)
    p = bulk_fcc("Cu", 3.6).repeat((2, 2, 2))
    p.positions[0] += [0.4, 0.0, 0.0]
    pert = simplesim.SimpleSim(p, cutoff=4.5)
    jp = jax_bulk_fcc("Cu", 3.6).repeat((2, 2, 2))
    jp.positions[0] += [0.4, 0.0, 0.0]
    assert pert(0, 5) == jax_simplesim.SimpleSim(jp, cutoff=4.5)(0, 5)
    assert pert(0, 5) < ideal(0, 5) - 1e-3


# ------------------------------------------------------------ statsutil
def test_statsutil_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=4000)
    same(jax_stats.moving_average(x, 3), statsutil.moving_average(x, 3))
    assert statsutil.block_error(x, 10) == jax_stats.block_error(x, 10)
    same(jax_stats.autocorrelation(x[:1000], 10),
         statsutil.autocorrelation(x[:1000], 10))
    ys = rng.normal(size=(200, 3))
    oc, jc = statsutil.OnlineCov(), jax_stats.OnlineCov()
    for y in ys:
        oc(y)
        jc(y)
    same(jc.mat, oc.mat)
    assert np.allclose(oc.mat, np.cov(ys.T, bias=True), atol=1e-10)
    w, _ = oc.eig
    same(jc.eig[0], w)
    got = statsutil.moving_average(np.arange(10.0), 3)
    assert np.allclose(got, np.convolve(np.arange(10.0), np.ones(3) / 3,
                                        mode="valid"))
    assert statsutil.autocorrelation(x[:1000], 10)[0] == pytest.approx(1.0)


# ------------------------------------------------------------ structgen
def test_configure_doping_matches_jax():
    def run(fcc, mod):
        prim = fcc("Cu", 3.6)
        prim.numbers[:2] = 3
        return mod.configure_doping(prim, {3: 10, 29: 5, 47: 1},
                                    mul=(1, 2, 3, 4, 6))

    want = run(jax_bulk_fcc, jax_structgen)
    got = run(bulk_fcc, structgen)
    assert got == want
    repeat, initial, solution, delta, errors = got
    assert sum(delta.values()) == 0
    assert errors[repeat] == min(errors.values())
    assert structgen.composition_error(solution, {3: 10, 29: 5, 47: 1}) < 0.12


def test_normalized_formula_and_error_match_jax():
    for a, b in (({3: 1, 29: 1}, {3: 1, 29: 1}), ({3: 2}, {29: 2}),
                 ({3: 5, 29: 3, 47: 1}, {3: 4, 29: 4})):
        assert structgen.composition_error(a, b) == \
            jax_structgen.composition_error(a, b)
    assert structgen.normalized_formula({3: 2, 29: 2}) == {3: 0.5, 29: 0.5}
    assert structgen.composition_error({3: 2}, {29: 2}) > 0.5


def test_random_doping_matches_jax():
    js, ts = both(lambda fcc: fcc("Cu", 3.6).repeat((2, 2, 2)))
    mask = np.zeros(32, dtype=bool)
    mask[:8] = True
    for delta, kw in (({29: -4, 47: 4}, dict(rng=3)),
                      ({29: -3, 47: 3}, dict(mask=mask, rng=4))):
        jd, jsubs, jto = jax_structgen.random_doping(js, delta, **kw)
        td, tsubs, tto = structgen.random_doping(ts, delta, **kw)
        assert (tsubs, tto) == (jsubs, jto)
        same(jd.numbers, td.numbers)
        assert (ts.numbers == 29).all()
    assert all(i < 8 for i in tsubs)


def test_canonical_generator_matches_jax():
    for gen in (((3, 29, 47), (5, 29, 47)), ((5, 29, 47), (3, 29, 47)),
                ((3, 29, 47), (3, 47, 3))):
        assert structgen.canonical_generator(gen) == \
            jax_structgen.canonical_generator(gen)
    assert structgen.canonical_generator(((3, 29, 47), (3, 47, 3))) == \
        ((3, 29, 3),)


def doped(fcc, rattle=0.02):
    s = fcc("Cu", 3.6).repeat((2, 2, 1))
    s.numbers[:4] = 47
    s.rattle(rattle, seed=5)
    return s


def search_run(mod, system, calc, prefix, epochs=2):
    search = mod.StructureSearch(system, calc=calc, sim=0.99999,
                                 prefix=prefix, rng=7)
    e0 = search.energy(())
    parents = search.search_swaps([()], [(47, 29)], epochs=epochs,
                                  max_child=6, max_parents=3)
    return search, e0, parents


def test_structure_search_swaps_matches_jax(tmp_path, monkeypatch):
    """The oracle-driven swap search of tests/test_structgen.py in both
    packages with the same rng: the same parents and energies, bit for
    bit; the structure restored, the cache and generation files read
    back."""
    monkeypatch.chdir(tmp_path)
    js, ts = both(doped)
    jsearch, je0, jparents = search_run(jax_structgen, js, JaxMLJ(EPS, SIG,
                                                                  rc=4.5),
                                        "jax")
    search, e0, parents = search_run(structgen, ts,
                                     MixtureLennardJones(EPS, SIG, rc=4.5),
                                     "srch")
    assert parents == jparents
    assert search.cached == jsearch.cached
    assert e0 == je0
    assert min(search.energy(p) for p in parents) <= e0
    assert (ts.numbers[:4] == 47).all() and (ts.numbers[4:] == 29).all()
    again = structgen.StructureSearch(ts, calc=None, prefix="srch", rng=7)
    assert again.cached == search.cached
    assert again.energy(()) == e0
    search.save_generation(parents, "gen.txt")
    assert search.load_generation("gen.txt") == [tuple(p) for p in parents]
    assert open("srch.cached").read() == open("jax.cached").read()


def learned_model():
    """A small two-species model trained in the JAX package: four Ag-site
    inducing environments of fcc Cu and one Lennard-Jones data record of
    the doped 16-atom box, solved with the noise optimizer."""
    from autoforce_tpu.descriptor.soap import SoapParams
    from autoforce_tpu.engine import Engine
    from autoforce_tpu.neighbors import displacements, neighbor_table
    from autoforce_tpu.regression.sgpr import DataRecord, InducingEnv, SgprModel

    eng = Engine(params=SoapParams(lmax=2, nmax=2, rc=4.0), exponent=4,
                 species=[29, 47])
    model = SgprModel(eng)
    for seed in range(4):
        s = jax_bulk_fcc("Cu", 3.6)
        s.numbers[(seed + 1) % 4] = 47
        s.rattle(0.1, seed=seed)
        t = neighbor_table(s.positions, s.cell, s.pbc, 4.0)
        r = displacements(s.positions, s.cell, t)
        i = (seed + 1) % 4 if seed % 2 == 0 else seed % 4
        m = t.mask[i]
        model.add_inducing(InducingEnv.from_arrays(
            s.numbers[i], r[i][m], s.numbers[t.idx[i][m]]), remake=False)
    data = doped(jax_bulk_fcc, rattle=0.05)
    data.calc = JaxMLJ(EPS, SIG, rc=4.0)
    model.add_data(DataRecord.from_system(data), remake=False)
    model.make_munu(optimize=True, noise_f=0.01)
    return model


def test_structure_search_with_the_active_calculator_matches_jax(
        tmp_path, monkeypatch):
    """``StructureSearch`` ranked by a frozen ``ActiveCalculator`` in each
    package on one JAX-trained model (the structure rattled so that no two
    children tie): the same parents, energies within 1e-10 relative."""
    monkeypatch.chdir(tmp_path)
    jm = learned_model()
    tm = sgpr_model_from_jax(jm, **F64)
    kw = dict(calculator=None, logfile=None, pckl=None, tape=None)
    js, ts = both(lambda fcc: doped(fcc, rattle=0.05))
    jsearch, je0, jparents = search_run(jax_structgen, js,
                                        JaxCalc(covariance=jm, **kw), "jax",
                                        epochs=1)
    search, e0, parents = search_run(structgen, ts,
                                     ActiveCalculator(covariance=tm, **kw),
                                     "srch", epochs=1)
    assert parents == jparents
    assert set(search.cached) == set(jsearch.cached)
    assert len(search.cached) >= 4
    scale = max(abs(e) for e in jsearch.cached.values())
    for g, e in jsearch.cached.items():
        assert abs(search.cached[g] - e) <= 1e-10 * scale, g
    assert (ts.numbers[:4] == 47).all() and (ts.numbers[4:] == 29).all()


def test_trajectory_extras_match_jax():
    def frames(fcc):
        rng = np.random.default_rng(0)
        base = fcc("Cu", 3.6).repeat((2, 2, 2))
        out = []
        for _ in range(12):
            f = base.copy()
            f.positions = f.positions + rng.normal(0, 0.05, f.positions.shape)
            out.append(f)
        return out

    jt, tt = (mod.TrajAnalyser(frames(fcc)) for mod, fcc in (
        (jax_traj, jax_bulk_fcc), (traj, bulk_fcc)))
    same(jt.get_scalars(("volume",))[0], tt.get_scalars(("volume",))[0])
    assert tt.ave_vol(sample_size=20, rng=1) == jt.ave_vol(sample_size=20,
                                                           rng=1)
    same(jt.center_of_mass(), tt.center_of_mass())
    assert len(list(tt.sample_pairs(3, sample_size=5, rng=2))) == 5
    want = jt.hist_rtp_displacements(2, rmax=2.0, bins=(10, 6, 8),
                                     sample_size=10, rng=3)
    got = tt.hist_rtp_displacements(2, rmax=2.0, bins=(10, 6, 8),
                                    sample_size=10, rng=3)
    for g, w in zip(got, want):
        same(w, g)
    assert got[3].shape == (9, 5, 7) and abs(got[3].sum() - 1.0) < 1e-9


# ------------------------------------------------------ rdf, trajectory
def test_rdf_fcc_matches_jax():
    js, ts = both(lambda fcc: fcc("Cu", 3.6).repeat((3, 3, 3)))
    jr, jg = jax_rdf_mod.rdf([js], rmax=5.0, bins=200)
    r, g = analysis.rdf([ts], rmax=5.0, bins=200)
    same(jr, r)
    assert set(g) == set(jg) == {(29, 29)}
    same(jg[(29, 29)], g[(29, 29)])
    assert abs(r[np.argmax(g[(29, 29)])] - 3.6 / np.sqrt(2)) < 0.05
    assert g[(29, 29)][r < 2.0].max() == 0.0
    # two species, a pair list
    jd, td = both(doped)
    assert rdf_mod.get_numbers_pairs(td.numbers) == \
        jax_rdf_mod.get_numbers_pairs(jd.numbers)
    jr, jg = jax_rdf_mod.rdf([jd], rmax=4.0, bins=50)
    r, g = rdf_mod.rdf([td], rmax=4.0, bins=50)
    assert set(g) == set(jg) == {(29, 29), (47, 47), (29, 47)}
    for pair in g:
        same(jg[pair], g[pair])


def test_traj_analyser_matches_jax():
    drift = np.array([0.05, 0.0, 0.0])

    def frames(fcc):
        base = fcc("Cu", 3.6).repeat((2, 2, 2))
        out = []
        for t in range(20):
            f = base.copy()
            f.positions = f.positions + t * drift
            out.append(f)
        return out

    ta = analysis.TrajAnalyser(frames(bulk_fcc))
    ja = jax_traj.TrajAnalyser(frames(jax_bulk_fcc))
    same(ja.msd(), ta.msd())
    np.testing.assert_allclose(ta.msd()[10], 0.5 ** 2, rtol=1e-6)
    assert ta.diffusion_constant(2.0) == ja.diffusion_constant(2.0)
    want = jax_traj.arrhenius_fit([300, 600, 1200], [1e-7, 1e-6, 3e-6])
    got = traj.arrhenius_fit([300, 600, 1200], [1e-7, 1e-6, 3e-6])
    assert got == want and got[0] > 0


# ---------------------------------------- symmetry, visual, ASE adapter
def test_symmetry_needs_spglib_in_both():
    from autoforce_tpu.analysis import symmetry as jax_symmetry
    from autoforce_tpu_torch.analysis import symmetry

    try:
        import spglib  # noqa: F401
    except ImportError:
        for mod in (jax_symmetry, symmetry):
            s = (jax_bulk_fcc if mod is jax_symmetry else bulk_fcc)("Cu", 3.6)
            with pytest.raises(ImportError):
                mod.get_spacegroup(s)
            with pytest.raises(ImportError):
                mod.standardize(s)
    else:  # where spglib is installed, both packages agree
        js, ts = both(lambda fcc: fcc("Cu", 3.6))
        assert symmetry.get_spacegroup(ts) == jax_symmetry.get_spacegroup(js)
        same(jax_symmetry.standardize(js).positions,
             symmetry.standardize(ts).positions)


def test_plot_trajectory_and_show_trajectory(tmp_path):
    from autoforce_tpu.analysis import visual as jax_visual
    from autoforce_tpu_torch.analysis import visual

    trajs = {}
    for mod, fcc in ((jax_visual, jax_bulk_fcc), (visual, bulk_fcc)):
        frames = []
        for k in range(5):
            s = fcc("Cu", 3.6)
            s.rattle(0.02, seed=k)
            frames.append(s)
        trajs[mod] = frames
        out = tmp_path / f"{mod.__name__}.png"
        assert mod.plot_trajectory(frames, out=str(out)) is not None
        assert out.exists()
        try:
            import nglview  # noqa: F401
        except ImportError:  # the gate raises in both packages
            with pytest.raises(ImportError):
                mod.show_trajectory(frames)
    for a, b in zip(trajs[jax_visual], trajs[visual]):
        same(a.positions, b.positions)


class AtomsStub:
    """Duck-typed ``ase.Atoms``: what ``system_from_ase`` reads."""

    def __init__(self, numbers, positions, cell, pbc, velocities=None):
        self.numbers = np.asarray(numbers)
        self.positions = np.asarray(positions, dtype=float)
        self.cell = np.asarray(cell, dtype=float)
        self.pbc = np.asarray(pbc, dtype=bool)
        self._v = velocities

    def get_velocities(self):
        if self._v is None:
            raise AttributeError("no velocities")
        return self._v


def test_ase_adapter_matches_jax():
    s = bulk_fcc("Cu", 3.6).repeat((2, 1, 1))
    s.rattle(0.05, seed=1)
    v = np.random.default_rng(2).normal(0, 0.01, (len(s), 3))
    for vel in (None, v):
        stub = AtomsStub(s.numbers, s.positions, s.cell, s.pbc, vel)
        got = ase_adapter.system_from_ase(stub)
        want = jax_ase.system_from_ase(stub)
        for attr in ("numbers", "positions", "cell", "pbc"):
            same(getattr(want, attr), getattr(got, attr))
        same(want.get_velocities(), got.get_velocities())
    assert ase_adapter.HAVE_ASE == jax_ase.HAVE_ASE
    if not ase_adapter.HAVE_ASE:
        for mod in (jax_ase, ase_adapter):
            with pytest.raises(ImportError):
                mod.system_to_ase(got)
            with pytest.raises(ImportError):
                mod.AseCalculatorAdapter(None)
    # what the adapter hands ASE: host arrays, 0-d tensors as floats
    res = ase_adapter.host_results(dict(
        energy=torch.tensor(1.5, dtype=torch.float64),
        forces=torch.ones((2, 3)), stress=np.zeros(6), free_energy=1.5))
    assert isinstance(res["energy"], float) and res["energy"] == 1.5
    assert isinstance(res["forces"], np.ndarray) and res["forces"].shape == (2, 3)
    assert isinstance(res["stress"], np.ndarray)


# ---------------------------------------------------------------- remote
def test_port_pids_and_clear():
    code = (
        "import socket, time\n"
        "s = socket.socket(); s.bind(('127.0.0.1', 0))\n"
        "print(s.getsockname()[1], flush=True)\n"
        "s.listen(1); time.sleep(60)\n"
    )
    proc = subprocess.Popen([sys.executable, "-c", code],
                            stdout=subprocess.PIPE, text=True)
    try:
        port = int(proc.stdout.readline())
        pids = remote.port_pids(port)
        if not pids:
            pytest.skip("lsof unavailable or namespace hides sockets")
        assert proc.pid in pids
        out = remote.clear_port(port)
        assert any(pid == proc.pid and ok for pid, ok in out)
        proc.wait(timeout=5)
    finally:
        if proc.poll() is None:
            proc.kill()


def test_twinrun_roundtrip(tmp_path, monkeypatch, capfd):
    """``twinrun`` (here through ``python -m autoforce_tpu_torch.remote
    twin ... --device cpu``) starts the port's calc_server, runs the
    script against it and shuts the server down; the script's energy
    through the socket equals the EMT oracle's in this process."""
    from autoforce_tpu_torch.calculator.emt import EMT

    monkeypatch.chdir(tmp_path)
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    script = tmp_path / "driver.py"
    script.write_text(
        "import sys\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        "from autoforce_tpu_torch.calculator.socket import SocketCalculator\n"
        "from autoforce_tpu_torch.system import bulk_fcc\n"
        "s = bulk_fcc('Cu', 3.6).repeat((2, 1, 1))\n"
        "s.rattle(0.04, seed=3)\n"
        f"s.calc = SocketCalculator(ip='127.0.0.1', port={port})\n"
        "print('E', repr(s.get_potential_energy()), flush=True)\n"
    )
    rc = remote.main(["twin", str(script), "--ip", "127.0.0.1", "--port",
                      str(port), "--calc", "EMT", "--device", "cpu"])
    assert rc == 0
    line = [ln for ln in capfd.readouterr().out.splitlines()
            if ln.startswith("E ")][-1]
    ref = bulk_fcc("Cu", 3.6).repeat((2, 1, 1))
    ref.rattle(0.04, seed=3)
    ref.calc = EMT(device="cpu")
    e = ref.get_potential_energy()
    assert abs(float(line.split()[1]) - e) <= 1e-10 * abs(e)
    assert remote.port_pids(port) == []


def test_spatial_ordering_roundtrip_matches_jax():
    js, ts = both(lambda fcc: rattled(fcc, (4, 4, 4)))
    jo, jp = js.spatially_ordered(cell_size=4.0)
    to, tp = ts.spatially_ordered(cell_size=4.0)
    same(jp, tp)
    same(jo.positions, to.positions)
    assert sorted(tp.tolist()) == list(range(len(ts)))
    np.testing.assert_allclose(to.positions[np.argsort(tp)], ts.positions)
