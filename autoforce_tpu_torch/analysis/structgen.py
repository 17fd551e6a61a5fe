"""Structure generation: substitutional doping + combinatorial
substitution search.

Counterparts of theforce/analysis/doping.py:1-116 (choose a supercell
repeat + per-species substitution counts that best match a target
composition, then apply random substitutions) and
theforce/analysis/atomsgen.py:1-218 (greedy search over "switch"
sequences — single-site species changes — using a cheap site-similarity
kernel to prune symmetry-equivalent candidates and an attached
calculator to rank generations).  ASE-free: operates on
:class:`autoforce_tpu_torch.system.System`.

A copy of ``autoforce_tpu/analysis/structgen.py`` (numpy only): the port keeps
its own host modules so that it never imports the JAX package.
"""

from __future__ import annotations

import os

import numpy as np

from .simplesim import SimpleSim

__all__ = [
    "normalized_formula",
    "composition_error",
    "configure_doping",
    "random_doping",
    "canonical_generator",
    "StructureSearch",
]


# --------------------------------------------------------------- doping
def normalized_formula(formula):
    """{species: count} -> {species: fraction} (doping.py:5-7)."""
    total = sum(formula.values())
    return {s: c / total for s, c in formula.items()}


def composition_error(a, b):
    """max |x-y| plus a density-damped mean term (doping.py:19-31)."""
    species = set(a) | set(b)
    na = normalized_formula(a)
    nb = normalized_formula(b)
    x = np.array([na.get(s, 0.0) for s in species])
    y = np.array([nb.get(s, 0.0) for s in species])
    rho = (x + y) / 2
    diff = np.abs(x - y)
    return float(diff.max() + (diff * np.exp(-rho)).mean())


def configure_doping(prim, target, mul=(1, 2, 3, 4, 6)):
    """Best (repeat, initial, solution, delta, errors) matching ``target``
    composition from multiples of ``prim``'s formula (doping.py:33-94).

    ``prim``: a System (or anything with ``.numbers``); ``target``:
    {Z: count} in arbitrary normalization.  ``delta`` is the per-species
    substitution count to apply (net zero total)."""
    target = dict(target)
    uniq, cnt = np.unique(np.asarray(prim.numbers), return_counts=True)
    numbers = {int(s): int(c) for s, c in zip(uniq, cnt)}
    species = set(numbers) | set(target)
    for s in species:
        target.setdefault(s, 0)

    def solve(m):
        initial = {s: numbers.get(s, 0) * m for s in species}
        n = sum(initial.values())
        tar = normalized_formula(target)
        ini = normalized_formula(initial)
        delta = {s: int(round((tar[s] - ini[s]) * n)) for s in species}
        sol = {s: initial[s] + delta[s] for s in species}
        for s in species:
            if sol[s] < 0:
                delta[s] -= sol[s]
                sol[s] = 0
        # greedily fix the rounding residue one site at a time, always
        # taking the move that minimizes the composition error
        res = sum(delta.values())
        while res != 0:
            d = -int(np.sign(res))
            best, best_err = None, np.inf
            for s in species:
                if sol[s] + d > 0:
                    sol[s] += d
                    err = composition_error(sol, target)
                    if err < best_err:
                        best, best_err = s, err
                    sol[s] -= d
            sol[best] += d
            delta[best] += d
            res = sum(delta.values())
        return initial, sol, delta, composition_error(sol, target)

    errors = {}
    best = None
    repeat = None
    for m in sorted(mul):
        out = solve(m)
        errors[m] = out[3]
        if best is None or out[3] < best[3]:
            best, repeat = out, m
    initial, solution, delta, _ = best
    return repeat, initial, solution, delta, errors


def random_doping(system, delta, mask=None, rng=None):
    """Apply ``delta`` = {Z: net count} substitutions at random sites
    (doping.py:97-116).  Returns (doped_copy, site_indices, new_numbers)."""
    rng = np.random.default_rng(rng)
    numbers = np.asarray(system.numbers)
    if mask is None:
        mask = np.ones(len(numbers), dtype=bool)
    mask = np.asarray(mask, dtype=bool)
    to = []
    subs = []
    for z, c in delta.items():
        if c > 0:
            to += c * [z]
        elif c < 0:
            cand = [
                i for i in np.flatnonzero((numbers == z) & mask)
                if i not in subs
            ]
            subs += rng.choice(cand, -c, replace=False).tolist()
    subs = rng.permutation(subs).tolist()
    doped = system.copy()
    doped.numbers[subs] = to
    return doped, subs, to


# ------------------------------------------------- substitution search
def _reduced(generator):
    """Net (first, last) species per site along a switch sequence."""
    status = {}
    for k, i, f in generator:
        if k in status:
            assert status[k][1] == i
            status[k] = (status[k][0], f)
        else:
            status[k] = (i, f)
    return status


def canonical_generator(generator):
    """Path-independent canonical form of a switch sequence
    (atomsgen.py:62-73): per-site net (initial, final), sites sorted."""
    status = _reduced(generator)
    return tuple((k, *status[k]) for k in sorted(status))


def _admissible(parent, switch):
    """Prune reversals and out-of-order duplicates (atomsgen.py:49-59)."""
    k, i, f = switch
    if (k, f, i) in parent:
        return False
    for kk, ii, ff in parent:
        if kk > k and ii == i and ff == f:
            return False
    return True


class StructureSearch:
    """Greedy low-energy search over substitution patterns
    (atomsgen.py:76-218 ``AtomsGenerator``).

    A *switch* ``(index, i, f)`` changes site ``index`` from species
    ``i`` to ``f``; a *generator* is a tuple of switches relative to the
    base structure.  ``generate`` expands parents by one switch of a
    given type, de-duplicating symmetry-near-equivalent sites with the
    :class:`SimpleSim` kernel; ``search_swaps`` runs generations of
    swap moves ranked by the attached calculator's energy, with an
    on-disk energy cache (``<prefix>.cached``) for restarts."""

    def __init__(self, system, calc=None, sim=1.0 - 1e-6, forbidden=None,
                 prefix="search", rng=None):
        self.system = system
        self.calc = calc
        self.sim = sim
        self.simkern = SimpleSim(system)
        self.forbidden = forbidden or {}
        self.prefix = prefix
        self.rng = np.random.default_rng(rng)
        self.cached = {}
        self.cachefile = f"{prefix}.cached"
        self.dry_run = calc is None
        self._log("hello structure search", "w")
        self._read_cache()

    # -------------------------------------------------------------- io
    def _log(self, msg, mode="a"):
        with open(f"{self.prefix}.log", mode) as f:
            f.write(f"{msg}\n")

    def _read_cache(self):
        if os.path.isfile(self.cachefile):
            with open(self.cachefile) as f:
                for line in f:
                    key, val = line.rsplit(":", 1)
                    self.cached[_parse_gen(key)] = float(val)
            self._log(f"{len(self.cached)} energies read from cache")

    def save_generation(self, generation, path):
        with open(path, "w") as f:
            for g in generation:
                f.write(f"{tuple(g)}\n")

    def load_generation(self, path):
        with open(path) as f:
            return [_parse_gen(line.strip()) for line in f if line.strip()]

    # ------------------------------------------------------- switching
    def apply(self, generator):
        for index, i, f in generator:
            assert self.system.numbers[index] == i
            self.system.numbers[index] = f
        self.system._calc_cache = None

    def revert(self, generator):
        for index, i, f in generator[::-1]:
            assert self.system.numbers[index] == f
            self.system.numbers[index] = i
        self.system._calc_cache = None

    def energy(self, generator):
        """The attached calculator's energy of the base structure with
        ``generator`` applied, cached; with the port's calculator on the
        card, one prediction (both SOAP kernels) per new generator."""
        generator = tuple(generator)
        if generator in self.cached:
            return self.cached[generator]
        if self.dry_run:
            e = 0.0
        else:
            self.apply(generator)
            tmp = self.system.copy()
            tmp.calc = self.calc
            e = float(tmp.get_potential_energy())
            self.revert(generator)
        self.cached[generator] = e
        with open(self.cachefile, "a") as f:
            f.write(f"{generator} : {e}\n")
        return e

    # ------------------------------------------------------ generation
    def generate(self, parents, switch_type):
        """All canonical children of ``parents`` by one ``(i, f)``
        switch, site-deduplicated by similarity (atomsgen.py:217-241)."""
        i, f = switch_type
        generation = set()
        for parent in parents:
            self.apply(parent)
            unique = []
            for idx in np.flatnonzero(self.system.numbers == i):
                idx = int(idx)
                if f in self.forbidden and idx in self.forbidden[f]:
                    continue
                if any(
                    self.simkern(u, idx) >= self.sim for u in unique
                ):
                    continue
                unique.append(idx)
                switch = (idx, i, f)
                if _admissible(parent, switch):
                    generation.add(canonical_generator((*parent, switch)))
            self.revert(parent)
        return generation

    def swaps(self, parents, switch_type):
        """Children that swap one (i->f) with one (f->i) in either
        order (atomsgen.py:243-246)."""
        a = self.generate(self.generate(parents, switch_type),
                          switch_type[::-1])
        b = self.generate(self.generate(parents, switch_type[::-1]),
                          switch_type)
        return a | b

    def search_swaps(self, parents, swap_types, epochs=1, max_child=10,
                     max_parents=10):
        """Greedy generational search (atomsgen.py:248-267): expand each
        parent by all swap types, subsample to ``max_child``, rank by
        energy, keep the ``max_parents`` lowest as the next parents."""
        for _ in range(epochs):
            generation = set()
            for parent in parents:
                children = set()
                for st in swap_types:
                    children |= self.swaps([parent], st)
                children = list(children)
                if len(children) > max_child:
                    pick = self.rng.permutation(len(children))[:max_child]
                    children = [children[k] for k in pick]
                generation |= set(children)
                generation.add(parent)
            generation = list(generation)
            energies = [self.energy(g) for g in generation]
            order = np.argsort(energies)[: min(max_parents, len(generation))]
            parents = [generation[k] for k in order]
            self._log(f"{len(parents)} lowest energies of "
                      f"{len(generation)}")
            for k in order:
                self._log(f"{energies[k]} {generation[k]}")
        return parents


def _parse_gen(text):
    """Parse a generator tuple literal like ``((3, 29, 47),)`` without
    eval."""
    import ast

    val = ast.literal_eval(text.strip())
    return tuple(tuple(sw) for sw in val)
