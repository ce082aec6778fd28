"""LaTeX tables and publication figures from the experiments' result JSON
(a copy of the JAX package's `experiments/reporting.py`; the port's drivers
write the same files). Tables need nothing beyond the standard library;
figures import matplotlib through `visualization/`.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence


def _load(results_dir: str, *names: str) -> Dict:
    out = {}
    for name in names:
        path = os.path.join(results_dir, name)
        if os.path.exists(path):
            with open(path) as f:
                out[os.path.basename(name)] = json.load(f)
    return out


def latex_table(rows: Sequence[Dict], columns: Sequence[str],
                headers: Optional[Sequence[str]] = None,
                caption: str = "", label: str = "",
                fmt: str = ".3g") -> str:
    """Render a list of dicts as a LaTeX booktabs table."""
    headers = headers or columns
    lines = [r"\begin{table}[ht]", r"\centering",
             r"\begin{tabular}{" + "l" * len(columns) + "}", r"\toprule",
             " & ".join(headers) + r" \\", r"\midrule"]
    for row in rows:
        cells = []
        for c in columns:
            v = row.get(c, "")
            if isinstance(v, float):
                cells.append(f"{v:{fmt}}")
            else:
                cells.append(str(v))
        lines.append(" & ".join(cells) + r" \\")
    lines += [r"\bottomrule", r"\end{tabular}"]
    if caption:
        lines.append(rf"\caption{{{caption}}}")
    if label:
        lines.append(rf"\label{{{label}}}")
    lines.append(r"\end{table}")
    return "\n".join(lines)


def generate_tables(results_dir: str = "results",
                    out_dir: Optional[str] = None) -> List[str]:
    """Tables 1-5 style outputs from whatever experiment JSON exists."""
    out_dir = out_dir or os.path.join(results_dir, "tables")
    os.makedirs(out_dir, exist_ok=True)
    written = []

    def write(name: str, content: str):
        path = os.path.join(out_dir, name)
        with open(path, "w") as f:
            f.write(content + "\n")
        written.append(path)

    # Table 1: algorithm comparison (crypto suite)
    crypto = _load(os.path.join(results_dir, "crypto"), "crypto_results.json")
    if crypto:
        rows = list(crypto["crypto_results.json"].values())
        write("table_1_algorithm_comparison.tex", latex_table(
            rows, ["lattice", "dimension", "sigma", "acceptance",
                   "spectral_gap"],
            caption="IMHK on cryptographic lattices", label="tab:crypto"))

    # Table 2: convergence by regime
    conv = _load(os.path.join(results_dir, "convergence"),
                 "convergence_study.json")
    if conv:
        rows = conv["convergence_study.json"].get("algorithm_comparison", [])
        write("table_2_convergence_summary.tex", latex_table(
            rows, ["dimension", "sigma_over_eta", "klein_tvd", "imhk_tvd",
                   "acceptance", "spectral_gap_mc"],
            caption="Convergence by sigma regime", label="tab:convergence"))

    # Table 3: performance benchmark
    bench = _load(os.path.join(results_dir, "benchmark"),
                  "benchmark_results.json")
    if bench:
        rows = bench["benchmark_results.json"].get("sampling", [])
        write("table_3_performance_benchmark.tex", latex_table(
            rows, ["algorithm", "dimension", "samples_per_sec", "p50_s"],
            caption="Sampling throughput", label="tab:perf"))

    # Table 4: parameter sensitivity
    sens = _load(os.path.join(results_dir, "sensitivity"),
                 "parameter_sensitivity.json")
    if sens:
        rows = sens["parameter_sensitivity.json"].get("sigma_sweep", {}).get(
            "rows", [])
        write("table_4_sigma_sensitivity.tex", latex_table(
            rows, ["sigma_over_eta", "acceptance", "spectral_gap"],
            caption="Sigma sensitivity", label="tab:sens"))

    # Table 5: scaling
    scal = _load(os.path.join(results_dir, "scaling"),
                 "dimension_scaling.json")
    if scal:
        rows = scal["dimension_scaling.json"].get("throughput", [])
        write("table_5_scaling_analysis.tex", latex_table(
            rows, ["dimension", "samples_per_sec", "sec_per_sample"],
            caption="Dimension scaling", label="tab:scaling"))

    # index
    write("index.md", "\n".join(f"- {os.path.basename(p)}" for p in written))
    return written


def generate_figures(results_dir: str = "results",
                     out_dir: Optional[str] = None) -> List[str]:
    """Figures 1-4 style plots from experiment JSON."""
    from lattice_gaussian_mcmc_tpu_torch.visualization import PlottingTools
    out_dir = out_dir or os.path.join(results_dir, "figures")
    pt = PlottingTools(out_dir)
    made = []

    conv = _load(os.path.join(results_dir, "convergence"),
                 "convergence_study.json")
    if conv:
        data = conv["convergence_study.json"]
        if data.get("algorithm_comparison"):
            pt.convergence_comparison(data["algorithm_comparison"],
                                      name="fig1_algorithm_comparison")
            made.append("fig1_algorithm_comparison")
        if data.get("tvd_decay"):
            pt.tvd_evolution(data["tvd_decay"], name="fig2_tvd_decay")
            made.append("fig2_tvd_decay")
    scal = _load(os.path.join(results_dir, "scaling"),
                 "dimension_scaling.json")
    if scal:
        rows = scal["dimension_scaling.json"].get("throughput", [])
        if rows:
            pt.scaling_plot(rows, "dimension", "samples_per_sec",
                            name="fig3_throughput_scaling")
            made.append("fig3_throughput_scaling")
    sens = _load(os.path.join(results_dir, "sensitivity"),
                 "parameter_sensitivity.json")
    if sens:
        rows = sens["parameter_sensitivity.json"].get("sigma_sweep", {}).get(
            "rows", [])
        if rows:
            pt.scaling_plot(rows, "sigma_over_eta", "spectral_gap",
                            name="fig4_sigma_gap", loglog=False)
            made.append("fig4_sigma_gap")
            heat = [r for r in rows
                    if r.get("acceptance") is not None
                    and r.get("dimension") is not None]
            if heat:
                pt.sensitivity_heatmap(heat, name="fig6_sigma_heatmap")
                made.append("fig6_sigma_heatmap")
    if scal:
        drows = scal["dimension_scaling.json"].get("inverse_delta", [])
        if drows:
            pt.delta_scaling(drows, name="fig5_delta_scaling")
            made.append("fig5_delta_scaling")
    bench = _load(os.path.join(results_dir, "benchmark"),
                  "benchmark_results.json")
    if bench:
        rows = bench["benchmark_results.json"].get("sampling", [])
        if rows:
            pt.algorithm_comparison_panel(
                rows, panels=("samples_per_sec", "acceptance",
                              "p50_s", "ess_per_sec"),
                name="fig7_algorithm_panel")
            made.append("fig7_algorithm_panel")
    return made
