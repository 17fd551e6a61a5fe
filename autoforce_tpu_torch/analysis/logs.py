"""active.log parsing + 4-panel dashboard figure (counterpart of
parse_logfile/log_to_figure, theforce/calculator/active.py:1189-1391).

CLI:  python -m autoforce_tpu_torch.analysis.logs active.log

A copy of ``autoforce_tpu/analysis/logs.py`` (numpy only): the port keeps
its own host modules so that it never imports the JAX package.
"""

from __future__ import annotations

import re

import numpy as np

FLOAT = r"[-+]?[\d.]+(?:[eE][-+]?\d+)?"


def parse_logfile(path="active.log"):
    energy = []  # (step, E, T)
    covloss = []  # (step, beta_max)
    indu = []  # (step, total m)
    data = []  # (step, total n)
    fit = []  # (step, e_mean, e_mae, f_mean, f_mae, r2)
    exact = []  # (step, E_exact)
    test_errors = []  # (step, dE, dFmax, dFmean)
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) < 3:
                continue
            try:
                step = int(parts[2])
            except ValueError:
                continue
            msg = " ".join(parts[3:])
            m = re.match(rf"^({FLOAT}) ({FLOAT})( ({FLOAT}))?", msg)
            if m and not msg[0].isalpha():
                energy.append((step, float(m.group(1)), float(m.group(2))))
                if m.group(4):
                    covloss.append((step, float(m.group(4))))
                continue
            if msg.startswith("added indu"):
                m = re.search(r"size: (\d+) (\d+)", msg)
                if m:
                    indu.append((step, int(m.group(2))))
            elif msg.startswith("added data") or msg.startswith("seed size"):
                m = re.search(r"(?:size|seed size): (\d+) (\d+)", msg)
                if m:
                    data.append((step, int(m.group(1))))
                    indu.append((step, int(m.group(2))))
            elif msg.startswith("fit error"):
                nums = re.findall(FLOAT, msg)
                if len(nums) >= 5:
                    fit.append((step, *[float(x) for x in nums[:5]]))
            elif msg.startswith("exact energy"):
                nums = re.findall(FLOAT, msg)
                if nums:
                    exact.append((step, float(nums[-1])))
            elif msg.startswith("errors (test)"):
                nums = re.findall(FLOAT, msg)
                if len(nums) >= 3:
                    test_errors.append((step, *[float(x) for x in nums[:3]]))
    return {
        "energy": np.array(energy),
        "covloss": np.array(covloss),
        "inducing": np.array(indu),
        "data": np.array(data),
        "fit": np.array(fit),
        "exact": np.array(exact),
        "test_errors": np.array(test_errors),
    }


def log_to_figure(path="active.log", save=None):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    d = parse_logfile(path)
    fig, axes = plt.subplots(2, 2, figsize=(11, 7))
    ax = axes[0, 0]
    if len(d["energy"]):
        ax.plot(d["energy"][:, 0], d["energy"][:, 1], lw=0.8, label="ML energy")
    if len(d["exact"]):
        ax.plot(d["exact"][:, 0], d["exact"][:, 1], "r.", label="exact")
    ax.set_ylabel("energy (eV)")
    ax.legend()
    ax = axes[0, 1]
    if len(d["energy"]):
        ax.plot(d["energy"][:, 0], d["energy"][:, 2], lw=0.8, color="tab:orange")
    ax.set_ylabel("temperature (K)")
    ax = axes[1, 0]
    if len(d["covloss"]):
        ax.semilogy(d["covloss"][:, 0], np.maximum(d["covloss"][:, 1], 1e-12),
                    lw=0.8, label="max covloss")
    if len(d["inducing"]):
        ax2 = ax.twinx()
        ax2.step(d["inducing"][:, 0], d["inducing"][:, 1], "g-",
                 where="post", label="inducing")
        ax2.set_ylabel("inducing")
    ax.set_ylabel("covloss")
    ax.set_xlabel("step")
    ax = axes[1, 1]
    if len(d["fit"]):
        ax.semilogy(d["fit"][:, 0], np.abs(d["fit"][:, 2]), "o-", ms=3,
                    label="|E| MAE/atom")
        ax.semilogy(d["fit"][:, 0], np.abs(d["fit"][:, 4]), "s-", ms=3,
                    label="|F| MAE")
    ax.set_xlabel("step")
    ax.legend()
    fig.tight_layout()
    if save:
        fig.savefig(save, dpi=120)
    return fig


def main():
    import argparse

    p = argparse.ArgumentParser(description="Plot an active.log dashboard")
    p.add_argument("log", nargs="?", default="active.log")
    p.add_argument("-o", "--output", default=None)
    args = p.parse_args()
    out = args.output or (args.log + ".png")
    log_to_figure(args.log, save=out)
    print(f"saved {out}")


if __name__ == "__main__":
    main()
