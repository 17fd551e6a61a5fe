"""Trajectory visualization (reference theforce/util/visual.py).

``show_trajectory`` renders a trajectory in a notebook through nglview
when it is installed (the reference hard-imports it; here it is
imported at first use and its absence raises ImportError).  ``plot_trajectory`` is a
matplotlib-only fallback: per-axis position traces + energy/temperature
panels, which covers the monitoring use case headlessly.

A copy of ``autoforce_tpu/analysis/visual.py`` (numpy only): the port keeps
its own host modules so that it never imports the JAX package.
"""

from __future__ import annotations

import numpy as np


def _as_systems(traj):
    """Accept a list of System or an extxyz path."""
    if isinstance(traj, str):
        from ..io.xyz import read_xyz

        return read_xyz(traj)
    return list(traj)


def show_trajectory(traj, radiusScale=0.5, remove_ball_and_stick=False,
                    axes=True):
    """nglview widget for a trajectory (reference visual.py
    show_trajectory); raises a clear ImportError when nglview is not
    available (use :func:`plot_trajectory` then)."""
    try:
        import nglview
    except ImportError as err:  # pragma: no cover - optional
        raise ImportError(
            "nglview is not installed; use plot_trajectory for a "
            "matplotlib fallback"
        ) from err
    systems = _as_systems(traj)
    try:  # nglview understands ase.Atoms
        from ..calculator.ase_adapter import system_to_ase

        frames = [system_to_ase(s) for s in systems]
    except Exception:
        frames = systems
    view = nglview.show_asetraj(frames)
    if not remove_ball_and_stick:
        view.add_ball_and_stick()
    view.add_spacefill(radiusScale=radiusScale)
    if axes:
        view.add_axes()
    return view


def plot_trajectory(traj, atoms=None, out=None):
    """Headless monitoring figure: positions of selected atoms per axis,
    plus energy and temperature when the frames carry them.

    Args:
        traj: list of System or an extxyz path.
        atoms: indices to trace (default: first three).
        out: optional path to save the figure (png/pdf).
    Returns the matplotlib figure.
    """
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    systems = _as_systems(traj)
    if not systems:
        raise ValueError("empty trajectory")
    n = len(systems[0])
    sel = list(atoms) if atoms is not None else list(range(min(3, n)))
    pos = np.array([s.positions[sel] for s in systems])  # (T, len(sel), 3)
    energies = []
    temps = []
    for s in systems:
        res = getattr(s.calc, "results", None) if s.calc else None
        energies.append(res.get("energy", np.nan) if res else np.nan)
        try:
            temps.append(s.get_temperature())
        except Exception:
            temps.append(np.nan)
    fig, axs = plt.subplots(2, 2, figsize=(9, 6))
    for k, ax in enumerate(axs.flat[:3]):
        for j, i in enumerate(sel):
            ax.plot(pos[:, j, k], label=f"atom {i}")
        ax.set_ylabel("xyz"[k] + " [A]")
        ax.set_xlabel("frame")
    if sel:
        axs.flat[0].legend(fontsize=7)
    ax = axs.flat[3]
    if np.isfinite(energies).any():
        ax.plot(energies, label="energy [eV]")
    if np.isfinite(temps).any():
        ax2 = ax.twinx()
        ax2.plot(temps, color="C3", label="T [K]")
        ax2.set_ylabel("T [K]")
    ax.set_xlabel("frame")
    ax.set_ylabel("E [eV]")
    fig.tight_layout()
    if out:
        fig.savefig(out, dpi=120)
    return fig
