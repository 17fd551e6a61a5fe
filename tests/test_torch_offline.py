"""The port's offline workflow against the JAX package's (CPU, float64), on
the same ARGS and frames with both packages' Lennard-Jones oracles in numpy:
``cl.train`` with ``cl.test`` and ``regression.scores``, ``cl.offline``,
``cl.build`` from the tape, ``cl.train -i OUTCAR``, ``cl.init_model`` with
``cl.singlepoint``, and ``regression.compress``'s ``shrink`` and
``sparsify``.  Each command runs in one directory per package; the frames
are tests/test_cl.py's (four 4-atom Cu cells rattled 0.08 A, LJ epsilon
0.15 eV, sigma 2.3 A, rc 4 A), plus two held-out frames to predict on.

Tolerances:
  * (ndata, m), the inducing order (``shrink`` / ``sparsify`` keep lists)
    and the sampling decisions: identical.
  * Predictions of the resulting models: within 1e-8 eV and 1e-8 eV/A
    (both solve the same float64 system; the port's descriptors and Gram
    run in torch, the JAX package's in XLA, and their rounding differs by
    far less).
  * ``mu``: within 1e-8 of its largest component.
  * Scores: the port's ``compare_trajectories`` and the JAX package's on
    the same files within 1e-12 (the same numpy arithmetic); the scores of
    the two packages' own ``cl.test`` files within 1e-6 (the files carry
    forces to 8 decimals).
  * ``cl.singlepoint``: identical (the same numpy oracle on the same
    positions).
``init_model`` and ``shrink(candidates=8)`` draw from
``numpy.random.default_rng()``: the test patches it to one seeded
generator per run, in this process, for both packages.

The noise optimizer (scipy's BFGS on the flat objective (force MAE -
noise_f)^2) is patched out of both packages' ``ActiveCalculator.optimize``
in this process: the solve runs at the fixed noise.  On these models (M's
condition ~5e7) covariance blocks equal to 2e-15 send the two optimizers
to log-noise 0.02 apart, while on one and the same state they agree
(tests/test_torch_active.py holds them so).  One case keeps it, with
``cl.train``'s default ``ioptim``: the two packages' seed steps, which
precede the first optimization, are identical, and after it, where the
sampling decisions part, both models reach a held-out force R2 of 0.8
(tests/test_cl.py's bar) and a held-out force MAE of at most 2 fdiff.
"""

import os
import re
import types

import numpy as np
import pytest
import torch

import autoforce_tpu.cl as jax_cl
import autoforce_tpu_torch.cl as cl
from autoforce_tpu.calculator.oracles import LennardJones as JaxLJ
from autoforce_tpu.system import SinglePointCalculator as JaxSP
from autoforce_tpu.system import bulk_fcc as jax_bulk_fcc
from autoforce_tpu_torch.calculator.oracles import LennardJones
from autoforce_tpu_torch.system import SinglePointCalculator, bulk_fcc

from test_outcar import OUTCAR2

LJ = dict(epsilon=0.15, sigma=2.3, rc=4.0)
TRAIN_ARGS = dict(kernel_kw=dict(cutoff=4.0, lmax=2, nmax=2),
                  pckl="model.pckl", tape=None, logfile=None, ediff=0.01,
                  fdiff=0.05, ioptim=10**6, calc_device="cpu",
                  dtype="float64")


def package(name):
    """The modules of one package, by the names the tests use."""
    if name == "jax":
        import autoforce_tpu.cl.build as build
        import autoforce_tpu.cl.init_model as init_model
        import autoforce_tpu.cl.offline as offline
        import autoforce_tpu.cl.singlepoint as singlepoint
        import autoforce_tpu.cl.test as cltest
        import autoforce_tpu.cl.train as train
        import autoforce_tpu.io.xyz as xyz
        import autoforce_tpu.regression.compress as compress
        import autoforce_tpu.regression.scores as scores

        return types.SimpleNamespace(
            cl=jax_cl, build=build, init_model=init_model, offline=offline,
            singlepoint=singlepoint, cltest=cltest, train=train, xyz=xyz,
            compress=compress, scores=scores, fcc=jax_bulk_fcc, SP=JaxSP,
            LJ=JaxLJ, oracles="autoforce_tpu.calculator.oracles")
    import autoforce_tpu_torch.cl.build as build
    import autoforce_tpu_torch.cl.init_model as init_model
    import autoforce_tpu_torch.cl.offline as offline
    import autoforce_tpu_torch.cl.singlepoint as singlepoint
    import autoforce_tpu_torch.cl.test as cltest
    import autoforce_tpu_torch.cl.train as train
    import autoforce_tpu_torch.io.xyz as xyz
    import autoforce_tpu_torch.regression.compress as compress
    import autoforce_tpu_torch.regression.scores as scores

    return types.SimpleNamespace(
        cl=cl, build=build, init_model=init_model, offline=offline,
        singlepoint=singlepoint, cltest=cltest, train=train, xyz=xyz,
        compress=compress, scores=scores, fcc=bulk_fcc,
        SP=SinglePointCalculator, LJ=LennardJones,
        oracles="autoforce_tpu_torch.calculator.oracles")


def lj_frames(pkg, seeds, reps=(1, 1, 1)):
    """tests/test_cl.py's frames: rattled Cu cells labelled by LJ."""
    out = []
    for k in seeds:
        s = pkg.fcc("Cu", 3.6).repeat(reps)
        s.rattle(0.08, seed=k)
        s.calc = pkg.SP(s, **pkg.LJ(**LJ).calculate(s))
        out.append(s)
    return out


def write_args(path, args):
    with open(os.path.join(path, "ARGS"), "w") as f:
        for k, v in args.items():
            f.write(f"{k} = {v!r}\n")


def calculator_classes():
    from autoforce_tpu.calculator.active import ActiveCalculator as JaxCalc
    from autoforce_tpu_torch.calculator.active import ActiveCalculator

    return JaxCalc, ActiveCalculator


OPTIMIZE = {cls: cls.optimize for cls in calculator_classes()}


@pytest.fixture(autouse=True)
def one_thread(monkeypatch):
    for cls in calculator_classes():
        monkeypatch.setattr(cls, "optimize", lambda self: self.model.make_munu())
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # sum order: the decisions are threshold tests
    yield
    torch.set_num_threads(threads)
    jax_cl.ARGS.clear()
    cl.ARGS.clear()


def run_both(tmp_path, monkeypatch, args, fn):
    """``fn(pkg)`` in one directory per package, each after writing
    ``data.extxyz`` and the same ARGS and reading them."""
    out = {}
    for name in ("jax", "port"):
        pkg = package(name)
        d = tmp_path / name
        d.mkdir()
        monkeypatch.chdir(d)
        pkg.xyz.write_xyz("data.extxyz", lj_frames(pkg, range(4)))
        write_args(str(d), args)
        pkg.cl.refresh()
        out[name] = fn(pkg)
    return out


def predictions(pkg, calc):
    """Energies and forces of ``calc`` on the data and two held-out frames."""
    calc._calc = None
    frames = lj_frames(pkg, range(4)) + lj_frames(pkg, (10, 11))
    res = [calc.calculate(s) for s in frames]
    return (np.array([r["energy"] for r in res]),
            np.stack([np.asarray(r["forces"]) for r in res]))


def assert_same_model(ref, got):
    """``ref`` / ``got``: (calculator, predictions) of each package."""
    (cr, (er, fr)), (cg, (eg, fg)) = ref, got
    assert cg.size == cr.size
    mu = np.asarray(cr.model.mu)
    np.testing.assert_allclose(cg.model.mu, mu, rtol=0,
                               atol=1e-8 * np.abs(mu).max())
    np.testing.assert_allclose(eg, er, rtol=0, atol=1e-8)
    np.testing.assert_allclose(fg, fr, rtol=0, atol=1e-8)


def test_cl_train_test_scores_match_jax(tmp_path, monkeypatch):
    def fn(pkg):
        calc = pkg.train.train(["data.extxyz"])
        pkg.cltest.test("data.extxyz")
        return calc, predictions(pkg, calc)

    out = run_both(tmp_path, monkeypatch, TRAIN_ARGS, fn)
    assert_same_model(out["jax"], out["port"])
    assert out["port"][0].size[0] >= 1 and out["port"][0].size[1] >= 1
    from autoforce_tpu.regression import scores as jax_scores
    from autoforce_tpu_torch.regression import scores

    sc = {}
    for name in ("jax", "port"):
        ml, fp = (str(tmp_path / name / f) for f in ("test_ML.extxyz",
                                                      "test_FP.extxyz"))
        sc[name] = scores.compare_trajectories(ml, fp)
        ref = jax_scores.compare_trajectories(ml, fp)
        for kind in ("energy", "forces"):
            for k, v in ref[kind].items():
                assert sc[name][kind][k] == pytest.approx(v, rel=1e-12,
                                                          abs=1e-12)
    for kind in ("energy", "forces"):
        for k, v in sc["jax"][kind].items():
            assert sc["port"][kind][k] == pytest.approx(v, rel=1e-6, abs=1e-8)
    assert sc["port"]["forces"]["r2"] > 0.8, sc["port"]


def test_cl_train_with_noise_optimizer_against_jax(tmp_path, monkeypatch):
    """``cl.train`` as its users run it: the noise optimizer on, after the
    seed and after every update (the default ``ioptim``)."""
    for cls, optimize in OPTIMIZE.items():
        monkeypatch.setattr(cls, "optimize", optimize)
    args = {k: v for k, v in TRAIN_ARGS.items() if k != "ioptim"}
    args["logfile"] = "active.log"

    def fn(pkg):
        calc = pkg.train.train(["data.extxyz"])
        calc._calc = None
        held = lj_frames(pkg, (10, 11))
        f = np.stack([np.asarray(calc.calculate(s)["forces"]) for s in held])
        ref = np.stack([np.asarray(s.get_forces()) for s in held])
        with open("active.log") as log:
            # the decisions ahead of the first optimization, without the
            # time stamps
            seed = []
            for line in log:
                if "seed size" in line or seed:
                    seed.append(re.sub(r"^\S+ \S+ ", "", line))
                if "randomly displaced" in line:
                    break
        return calc.size, f, ref, seed

    out = run_both(tmp_path, monkeypatch, args, fn)
    assert out["port"][3] == out["jax"][3]
    assert len(out["port"][3]) == 2, out["port"][3]
    for name in ("jax", "port"):
        size, f, ref, _ = out[name]
        assert 2 <= size[0] <= 4 and size[1] >= 1, (name, size)
        r2 = 1 - ((f - ref) ** 2).sum() / ((ref - ref.mean()) ** 2).sum()
        assert r2 >= 0.8, (name, r2)
        assert np.abs(f - ref).mean() <= 2 * args["fdiff"], name


def test_cl_offline_matches_jax(tmp_path, monkeypatch):
    def fn(pkg):
        calc = pkg.offline.offline("data.extxyz")
        assert os.path.isdir("model.pckl")
        return calc, predictions(pkg, calc)

    out = run_both(tmp_path, monkeypatch, TRAIN_ARGS, fn)
    assert_same_model(out["jax"], out["port"])


def test_cl_build_from_tape_matches_jax(tmp_path, monkeypatch):
    """Train with a tape, then rebuild a fresh model folder from it."""
    args = dict(TRAIN_ARGS, pckl="a.pckl", tape="model.sgpr")

    def fn(pkg):
        trained = pkg.train.train(["data.extxyz"])
        write_args(os.getcwd(), dict(args, pckl="b.pckl"))
        pkg.cl.refresh()
        if pkg.cl is cl:
            calc = pkg.build.main()
        else:  # the JAX entry point returns nothing: read its folder
            pkg.build.main()
            calc = pkg.cl.gen_active_calc()
        assert os.path.isdir("b.pckl")
        assert calc.size == trained.size
        return calc, predictions(pkg, calc)

    out = run_both(tmp_path, monkeypatch, args, fn)
    assert_same_model(out["jax"], out["port"])


def test_cl_train_outcar_matches_jax(tmp_path, monkeypatch):
    """``cl.train -i OUTCAR`` on tests/test_outcar.py's two ionic steps."""
    args = dict(kernel_kw=dict(cutoff=3.0, lmax=2, nmax=2), covariance=None,
                pckl="m.pckl", tape="m.sgpr", ediff=0.5, logfile=None,
                ioptim=10**6, calc_device="cpu", dtype="float64")

    def fn(pkg):
        with open("OUTCAR", "w") as f:
            f.write(OUTCAR2)
        calc = pkg.train.train(["OUTCAR"])
        calc._calc = None
        frames = pkg.train.read_frames("OUTCAR")
        res = [calc.calculate(s) for s in frames]
        return calc, (np.array([r["energy"] for r in res]),
                      np.stack([r["forces"] for r in res]))

    out = run_both(tmp_path, monkeypatch, args, fn)
    assert_same_model(out["jax"], out["port"])
    assert out["port"][0].size[0] >= 1


def seeded_default_rng(monkeypatch, seed):
    """``numpy.random.default_rng()`` without a seed returns one seeded
    generator; seeded calls are left alone."""
    gen = np.random.default_rng(seed)
    orig = np.random.default_rng

    def default_rng(seed=None):
        return gen if seed is None else orig(seed)

    monkeypatch.setattr(np.random, "default_rng", default_rng)


def test_cl_init_model_and_singlepoint_match_jax(tmp_path, monkeypatch):
    """``cl.init_model`` seeds a model from three rattled copies of a cell
    labelled by an LJ script named in ARGS; ``cl.singlepoint`` labels the
    cell with the same script."""
    def fn(pkg):
        with open("lj.py", "w") as f:
            f.write(f"from {pkg.oracles} import LennardJones\n"
                    f"calc = LennardJones(**{LJ!r})\n")
        write_args(os.getcwd(), dict(TRAIN_ARGS, calculator="lj.py",
                                     tape="model.sgpr"))
        pkg.cl.refresh()
        seeded_default_rng(monkeypatch, 5)
        atoms = pkg.fcc("Cu", 3.6).repeat((2, 1, 1))
        calc = pkg.init_model.init_model(atoms, samples=3, rattle=0.1)
        assert os.path.isdir("model.pckl")
        sp = pkg.singlepoint.singlepoint(lj_frames(pkg, (7,))[0])
        single = pkg.xyz.read_xyz("singlepoint.extxyz", index=0)
        return calc, predictions(pkg, calc), sp, single

    out = run_both(tmp_path, monkeypatch, TRAIN_ARGS, fn)
    assert_same_model(out["jax"][:2], out["port"][:2])
    assert out["port"][0].size[0] >= 2
    sp_ref, sp = out["jax"][2], out["port"][2]
    assert sorted(sp) == sorted(sp_ref) == ["energy", "forces", "stress"]
    for k in sp_ref:
        np.testing.assert_array_equal(sp[k], sp_ref[k])
    a, b = out["jax"][3], out["port"][3]
    np.testing.assert_array_equal(b.positions, a.positions)
    np.testing.assert_array_equal(b.get_forces(), a.get_forces())
    assert b.get_potential_energy() == a.get_potential_energy()


@pytest.mark.parametrize("how", ["shrink", "shrink_candidates", "sparsify"])
def test_compress_matches_jax(how, tmp_path, monkeypatch):
    """The same model trained by both packages (16-atom frames, so that
    it holds enough inducing environments), then compressed."""
    def fn(pkg):
        pkg.xyz.write_xyz("data.extxyz", lj_frames(pkg, range(4), (2, 2, 1)))
        calc = pkg.train.train(["data.extxyz"])
        m0 = calc.size[1]
        if how == "sparsify":
            keep = pkg.compress.sparsify(calc.model, sweeps=1.0, seed=0)
        else:
            seeded_default_rng(monkeypatch, 3)
            keep = pkg.compress.shrink(
                calc.model, m0 - 2,
                candidates=8 if how == "shrink_candidates" else None)
            assert calc.model.m == m0 - 2
        return (calc, predictions(pkg, calc)), [int(k) for k in keep], m0

    out = run_both(tmp_path, monkeypatch, TRAIN_ARGS, fn)
    assert out["port"][1] == out["jax"][1]
    assert out["port"][2] == out["jax"][2] > 8
    assert_same_model(out["jax"][0], out["port"][0])
