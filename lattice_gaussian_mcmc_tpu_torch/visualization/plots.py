"""Publication plotting, host-side matplotlib (a copy of the JAX package's
`visualization/plots.py`): publication styling, 2D lattice-Gaussian
scatter and density, convergence comparison, trace and ACF plots, lattice
points with Voronoi cells, QQ plots, TVD evolution, importance weights,
algorithm comparison and multi-format saves with data sidecars.

Every function takes numpy arrays (move tensors to the host first) and
returns the matplotlib Figure. matplotlib is imported here and nowhere on
the samplers' paths, so a host without it runs everything but the plots.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional, Sequence

import numpy as np

import matplotlib
matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402


STYLE = {
    "figure.figsize": (6.0, 4.0),
    "figure.dpi": 120,
    "font.size": 10,
    "axes.grid": True,
    "grid.alpha": 0.3,
    "lines.linewidth": 1.6,
    "savefig.bbox": "tight",
}


class PlottingTools:
    """Thin stateful wrapper carrying style + output directory."""

    def __init__(self, output_dir: str = "results/figures",
                 formats: Sequence[str] = ("png", "pdf")):
        self.output_dir = output_dir
        self.formats = formats
        plt.rcParams.update(STYLE)

    # -- persistence -------------------------------------------------------

    def save(self, fig, name: str, data: Optional[Dict] = None):
        """Multi-format save + JSON data sidecar (reference :993-1125)."""
        os.makedirs(self.output_dir, exist_ok=True)
        for ext in self.formats:
            fig.savefig(os.path.join(self.output_dir, f"{name}.{ext}"))
        if data is not None:
            with open(os.path.join(self.output_dir, f"{name}_data.json"),
                      "w") as f:
                json.dump(data, f, indent=2, default=float)
        plt.close(fig)

    def save_tikz(self, name: str, curves: Dict[str, tuple],
                  xlabel: str = "x", ylabel: str = "y",
                  xmode: str = "normal", ymode: str = "normal"):
        """Export line plots as a standalone pgfplots/TikZ .tex file
        (reference :993-1125 ships a TikZ export alongside PNG/PDF so paper
        figures can be regenerated natively in LaTeX).

        curves: {legend label: (x array, y array)}; x/ymode "log" selects
        logarithmic axes.
        """
        os.makedirs(self.output_dir, exist_ok=True)
        path = os.path.join(self.output_dir, f"{name}.tex")
        lines = [
            r"\documentclass[tikz]{standalone}",
            r"\usepackage{pgfplots}",
            r"\pgfplotsset{compat=1.17}",
            r"\begin{document}",
            r"\begin{tikzpicture}",
            (r"\begin{axis}[xlabel={%s}, ylabel={%s}, xmode=%s, ymode=%s,"
             r" legend pos=outer north east, grid=major]"
             % (xlabel, ylabel, xmode, ymode)),
        ]
        for label, (x, y) in curves.items():
            x = np.asarray(x).ravel()
            y = np.asarray(y).ravel()
            coords = " ".join(f"({xv:.8g},{yv:.8g})" for xv, yv in zip(x, y))
            lines.append(r"\addplot coordinates {%s};" % coords)
            lines.append(r"\addlegendentry{%s}" % label.replace("_", r"\_"))
        lines += [r"\end{axis}", r"\end{tikzpicture}", r"\end{document}", ""]
        with open(path, "w") as f:
            f.write("\n".join(lines))
        return path

    # -- plots -------------------------------------------------------------

    def lattice_gaussian_2d(self, points, sigma: float, center=None,
                            name: str = "lattice_gaussian_2d"):
        """Scatter + density heat of 2D samples (reference :184-250)."""
        pts = np.asarray(points)
        fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(9, 4))
        ax1.scatter(pts[:, 0], pts[:, 1], s=4, alpha=0.25)
        ax1.set_title(f"samples (sigma={sigma:g})")
        ax1.set_aspect("equal")
        h = ax2.hist2d(pts[:, 0], pts[:, 1], bins=40, cmap="viridis")
        fig.colorbar(h[3], ax=ax2)
        ax2.set_title("empirical density")
        if center is not None:
            c = np.asarray(center)
            for ax in (ax1, ax2):
                ax.plot([c[0]], [c[1]], "r+", markersize=12)
        self.save(fig, name)
        return fig

    def trace_plot(self, chain, name: str = "trace", max_dims: int = 4):
        """Trace plots of the first coordinates (reference :408-470)."""
        x = np.asarray(chain)
        d = min(x.shape[1] if x.ndim > 1 else 1, max_dims)
        fig, axes = plt.subplots(d, 1, sharex=True, figsize=(6, 1.8 * d))
        axes = np.atleast_1d(axes)
        for i in range(d):
            axes[i].plot(x[:, i] if x.ndim > 1 else x, lw=0.6)
            axes[i].set_ylabel(f"x[{i}]")
        axes[-1].set_xlabel("step")
        self.save(fig, name)
        return fig

    def acf_plot(self, acf, name: str = "acf"):
        """Autocorrelation stem plot (reference :470-532)."""
        a = np.asarray(acf)
        fig, ax = plt.subplots()
        ax.stem(np.arange(len(a)), a, basefmt=" ")
        ax.axhline(0, color="k", lw=0.8)
        ax.set_xlabel("lag")
        ax.set_ylabel("ACF")
        self.save(fig, name, data={"acf": a.tolist()})
        return fig

    def convergence_comparison(self, results: Sequence[Dict],
                               x_key: str = "sigma_over_eta",
                               y_keys: Sequence[str] = ("klein_tvd",
                                                        "imhk_tvd"),
                               name: str = "convergence_comparison"):
        """Klein-vs-IMHK TVD curves (reference :251)."""
        fig, ax = plt.subplots()
        xs = [r[x_key] for r in results]
        for yk in y_keys:
            ax.plot(xs, [r.get(yk) for r in results], "o-", label=yk)
        ax.set_xlabel(x_key)
        ax.set_ylabel("TVD to target")
        ax.set_yscale("log")
        ax.legend()
        self.save(fig, name, data={"results": list(results)})
        return fig

    def tvd_evolution(self, decay: Sequence[Dict], name: str = "tvd_evolution"):
        """Empirical TVD vs t with the (1-delta)^t bound (reference :738)."""
        fig, ax = plt.subplots()
        ts = [r["t"] for r in decay]
        ax.loglog(ts, [r["tvd"] for r in decay], "o-", label="empirical")
        if "bound" in decay[0]:
            ax.loglog(ts, [max(r["bound"], 1e-12) for r in decay], "--",
                      label="(1-delta)^t")
        ax.set_xlabel("t")
        ax.set_ylabel("TVD")
        ax.legend()
        self.save(fig, name, data={"decay": list(decay)})
        return fig

    def importance_weights(self, log_ws, name: str = "importance_weights"):
        """Histogram of Klein log-weights (reference :807)."""
        lw = np.ravel(np.asarray(log_ws))
        fig, ax = plt.subplots()
        ax.hist(lw, bins=60, density=True)
        ax.set_xlabel("log w(x)")
        ax.set_ylabel("density")
        self.save(fig, name, data={"mean": float(lw.mean()),
                                   "std": float(lw.std()),
                                   "max": float(lw.max())})
        return fig

    def scaling_plot(self, rows: Sequence[Dict], x_key: str, y_key: str,
                     name: str = "scaling", loglog: bool = True):
        """Generic scaling curve (delta-scaling :356, perf scaling etc.)."""
        fig, ax = plt.subplots()
        xs = [r[x_key] for r in rows]
        ys = [r[y_key] for r in rows]
        (ax.loglog if loglog else ax.plot)(xs, ys, "o-")
        ax.set_xlabel(x_key)
        ax.set_ylabel(y_key)
        self.save(fig, name, data={"rows": list(rows)})
        return fig

    def delta_scaling(self, rows: Sequence[Dict],
                      name: str = "delta_scaling"):
        """Spectral-gap scaling: delta and the mixing-time proxy 1/delta vs
        dimension, with the theoretical (1-delta)^t mixing-time overlay
        (reference plots.py:356 `plot_delta_scaling`).

        rows: dicts with keys `dimension`, `delta` and optionally
        `delta_theory`.
        """
        rows = sorted(rows, key=lambda r: r["dimension"])
        dims = [r["dimension"] for r in rows]
        deltas = [max(r["delta"], 1e-300) for r in rows]
        fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(9, 4))
        ax1.semilogy(dims, deltas, "o-", label="empirical/MC")
        if any("delta_theory" in r for r in rows):
            ax1.semilogy(dims, [max(r.get("delta_theory", np.nan), 1e-300)
                                for r in rows], "s--", label="theory")
        ax1.set_xlabel("dimension n")
        ax1.set_ylabel(r"spectral gap $\delta$")
        ax1.legend()
        tmix = [-np.log(0.01) / d for d in deltas]
        ax2.semilogy(dims, tmix, "o-")
        ax2.set_xlabel("dimension n")
        ax2.set_ylabel(r"$t_{mix}(0.01) \leq \ln(1/\epsilon)/\delta$")
        self.save(fig, name, data={"rows": list(rows)})
        return fig

    def algorithm_comparison_panel(self, rows: Sequence[Dict],
                                   x_key: str = "dimension",
                                   panels: Sequence[str] = (
                                       "samples_per_sec", "acceptance",
                                       "tvd", "ess_per_sec"),
                                   group_key: str = "algorithm",
                                   name: str = "algorithm_comparison_panel"):
        """2x2 multi-panel algorithm comparison: one curve per algorithm per
        panel metric (reference plots.py:863-935 `plot_algorithm_comparison`).

        rows: flat dicts with `algorithm`, x_key and any of the panel keys.
        Panels with no data are annotated rather than dropped so the layout
        is stable for golden tests.
        """
        algos = sorted({r[group_key] for r in rows})
        fig, axes = plt.subplots(2, 2, figsize=(9, 7))
        for ax, metric in zip(axes.ravel(), panels):
            plotted = False
            for algo in algos:
                pts = sorted(((r[x_key], r[metric]) for r in rows
                              if r.get(group_key) == algo
                              and r.get(metric) is not None),
                             key=lambda p: p[0])
                if pts:
                    xs, ys = zip(*pts)
                    ax.plot(xs, ys, "o-", label=str(algo))
                    plotted = True
            ax.set_xlabel(x_key)
            ax.set_ylabel(metric)
            if metric in ("samples_per_sec", "ess_per_sec", "tvd"):
                ax.set_yscale("log")
            if plotted:
                ax.legend(fontsize=8)
            else:
                ax.annotate("no data", (0.5, 0.5),
                            xycoords="axes fraction", ha="center")
        fig.tight_layout()
        self.save(fig, name, data={"rows": list(rows)})
        return fig

    def sensitivity_heatmap(self, rows: Sequence[Dict],
                            x_key: str = "sigma_over_eta",
                            y_key: str = "dimension",
                            z_key: str = "acceptance",
                            name: str = "sensitivity_heatmap"):
        """Parameter-sensitivity heatmap over a (x, y) grid of experiment
        rows, e.g. acceptance over (sigma/eta, dimension) (reference
        plots.py:936-992 `plot_parameter_sensitivity`). Missing grid cells
        render as NaN (blank)."""
        xs = sorted({r[x_key] for r in rows})
        ys = sorted({r[y_key] for r in rows})
        grid = np.full((len(ys), len(xs)), np.nan)
        for r in rows:
            if r.get(z_key) is None:
                continue
            grid[ys.index(r[y_key]), xs.index(r[x_key])] = r[z_key]
        fig, ax = plt.subplots()
        im = ax.imshow(grid, origin="lower", aspect="auto", cmap="viridis")
        ax.set_xticks(range(len(xs)), [f"{x:g}" for x in xs])
        ax.set_yticks(range(len(ys)), [f"{y:g}" for y in ys])
        ax.set_xlabel(x_key)
        ax.set_ylabel(y_key)
        fig.colorbar(im, ax=ax, label=z_key)
        for (i, j), v in np.ndenumerate(grid):
            if np.isfinite(v):
                ax.text(j, i, f"{v:.2g}", ha="center", va="center",
                        fontsize=7, color="w")
        self.save(fig, name, data={"x": list(xs), "y": list(ys),
                                   "z": grid.tolist(), "z_key": z_key})
        return fig

    def convergence_multipanel(self, chains, acf, tvd_decay: Sequence[Dict],
                               log_ws, name: str = "convergence_multipanel"):
        """4-panel convergence summary: trace, ACF, TVD decay, log-weight
        histogram in one figure (reference plots.py:251-356
        `plot_convergence_comparison` multi-panel layout)."""
        x = np.asarray(chains)
        a = np.asarray(acf)
        lw = np.ravel(np.asarray(log_ws))
        fig, axes = plt.subplots(2, 2, figsize=(9, 7))
        axes[0, 0].plot(x[:, 0] if x.ndim > 1 else x, lw=0.6)
        axes[0, 0].set_xlabel("step")
        axes[0, 0].set_ylabel("x[0]")
        axes[0, 1].stem(np.arange(len(a)), a, basefmt=" ")
        axes[0, 1].set_xlabel("lag")
        axes[0, 1].set_ylabel("ACF")
        ts = [r["t"] for r in tvd_decay]
        axes[1, 0].loglog(ts, [r["tvd"] for r in tvd_decay], "o-",
                          label="empirical")
        if tvd_decay and "bound" in tvd_decay[0]:
            axes[1, 0].loglog(ts, [max(r["bound"], 1e-12) for r in tvd_decay],
                              "--", label="$(1-\\delta)^t$")
            axes[1, 0].legend()
        axes[1, 0].set_xlabel("t")
        axes[1, 0].set_ylabel("TVD")
        axes[1, 1].hist(lw, bins=40, density=True)
        axes[1, 1].set_xlabel("log w(x)")
        axes[1, 1].set_ylabel("density")
        fig.tight_layout()
        self.save(fig, name)
        return fig

    def qq_plot(self, samples, sigma: float, name: str = "qq"):
        """QQ plot of a coordinate vs the continuous Gaussian (reference
        :692)."""
        x = np.sort(np.ravel(np.asarray(samples)))
        from scipy import stats as _st
        q = _st.norm.ppf((np.arange(len(x)) + 0.5) / len(x), scale=sigma)
        fig, ax = plt.subplots()
        ax.plot(q, x, ".", ms=2)
        lim = max(abs(q[0]), abs(q[-1]))
        ax.plot([-lim, lim], [-lim, lim], "r--", lw=1)
        ax.set_xlabel("normal quantile")
        ax.set_ylabel("sample quantile")
        self.save(fig, name)
        return fig


def lattice_points_2d(basis, radius: int = 5, samples=None,
                      voronoi: bool = True, output_dir: str = "results/figures",
                      name: str = "lattice_points"):
    """2D lattice points + optional Voronoi cells + optional sample overlay
    (reference plots.py:533-691). Standalone helper (no PlottingTools state).
    """
    import itertools
    B = np.asarray(basis, dtype=np.float64)
    coords = np.array(list(itertools.product(range(-radius, radius + 1),
                                             repeat=2)))
    pts = coords @ B.T
    fig, ax = plt.subplots(figsize=(5, 5))
    if voronoi:
        try:
            from scipy.spatial import Voronoi, voronoi_plot_2d
            vor = Voronoi(pts)
            voronoi_plot_2d(vor, ax=ax, show_points=False,
                            show_vertices=False, line_width=0.6,
                            line_colors="gray")
        except Exception:
            pass
    ax.plot(pts[:, 0], pts[:, 1], "k.", ms=4)
    if samples is not None:
        s = np.asarray(samples)
        ax.plot(s[:, 0], s[:, 1], "r.", ms=1.5, alpha=0.3)
    # basis vectors
    for v, color in zip(B.T, ("C0", "C1")):
        ax.annotate("", xy=v, xytext=(0, 0),
                    arrowprops=dict(arrowstyle="->", color=color, lw=2))
    lim = radius * max(np.linalg.norm(B, axis=0))
    ax.set_xlim(-lim * 0.6, lim * 0.6)
    ax.set_ylim(-lim * 0.6, lim * 0.6)
    ax.set_aspect("equal")
    os.makedirs(output_dir, exist_ok=True)
    fig.savefig(os.path.join(output_dir, f"{name}.png"))
    plt.close(fig)
    return fig
