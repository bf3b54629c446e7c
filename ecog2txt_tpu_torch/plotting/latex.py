"""LaTeX / TikZ emitters.

Rebuilds the reference's LaTeX legend and table emitters (reference
plotters.py:2260-2310, 2420-2462) and the ``tpl_save``-style TikZ
export from ``utils_jgm`` (pgfplots-ready data tables +
``tikz_partial_path`` naming, mocha-1_word_sequence.yaml:80).

The port's own copy of ``ecog2txt_tpu/plotting/latex.py``.
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np


def latex_table(
    rows: Sequence[Sequence],
    headers: Sequence[str],
    caption: str = "",
    label: str = "",
    float_fmt: str = "{:.3f}",
) -> str:
    """Booktabs-style table body."""
    def fmt(cell):
        if isinstance(cell, (float, np.floating)):
            return float_fmt.format(cell)
        return str(cell).replace("_", r"\_")

    lines = [
        r"\begin{table}",
        r"\centering",
        r"\begin{tabular}{" + "l" * len(headers) + "}",
        r"\toprule",
        " & ".join(fmt(h) for h in headers) + r" \\",
        r"\midrule",
    ]
    for row in rows:
        lines.append(" & ".join(fmt(c) for c in row) + r" \\")
    lines += [r"\bottomrule", r"\end{tabular}"]
    if caption:
        lines.append(rf"\caption{{{caption}}}")
    if label:
        lines.append(rf"\label{{{label}}}")
    lines.append(r"\end{table}")
    return "\n".join(lines)


def latex_legend(
    labels: Sequence[str], colors: Sequence[tuple[float, float, float]]
) -> str:
    """Standalone color legend as TikZ markers (reference
    plotters.py:2260-2310)."""
    lines = [r"\begin{tikzpicture}"]
    for i, (label, rgb) in enumerate(zip(labels, colors)):
        r, g, b = (float(c) for c in rgb[:3])
        lines.append(
            rf"\definecolor{{legend{i}}}{{rgb}}{{{r:.3f},{g:.3f},{b:.3f}}}"
        )
        lines.append(
            rf"\node[circle,fill=legend{i},inner sep=2pt,"
            rf"label=right:{{{label}}}] at (0,{-0.5 * i:.2f}) {{}};"
        )
    lines.append(r"\end{tikzpicture}")
    return "\n".join(lines)


def tikz_errorbar_plot(
    x: np.ndarray,
    y: np.ndarray,
    yerr: np.ndarray | None = None,
    xlabel: str = "x",
    ylabel: str = "y",
    series_name: str = "series",
) -> str:
    """pgfplots axis with an errorbar series — the tikz figure-export
    path (reference exports every figure via utils_jgm.tpl_save)."""
    rows = []
    yerr = np.zeros_like(np.asarray(y, float)) if yerr is None else yerr
    for xi, yi, ei in zip(x, y, yerr):
        rows.append(f"{float(xi):.6f} {float(yi):.6f} {float(ei):.6f}")
    table = "\n".join(rows)
    return "\n".join(
        [
            r"\begin{tikzpicture}",
            rf"\begin{{axis}}[xlabel={{{xlabel}}}, ylabel={{{ylabel}}}]",
            r"\addplot+[error bars/.cd, y dir=both, y explicit]",
            r"table[x index=0, y index=1, y error index=2] {",
            table,
            r"};",
            rf"\addlegendentry{{{series_name}}}",
            r"\end{axis}",
            r"\end{tikzpicture}",
        ]
    )


def save_tikz(content: str, tikz_partial_path: str, name: str) -> str:
    """Write a ``.tex`` snippet to ``tikz_partial_path.format(name)``."""
    path = tikz_partial_path.format(name)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write(content + "\n")
    return path


# FreeSurfer Desikan-Killiany cortical-label colors (RGB), from the
# public FreeSurferColorLUT ctx-lh-* entries — the values the reference
# pulls from img_pipe's FS_colorLUT (reference plotters.py:2260-2285).
FREESURFER_DK_COLORS = {
    "precentral": (60, 20, 220),
    "postcentral": (220, 20, 20),
    "supramarginal": (80, 160, 20),
    "pars triangularis": (220, 60, 20),
    "pars opercularis": (220, 180, 140),
    "pars orbitalis": (20, 100, 50),
    "superior temporal": (140, 220, 220),
    "middle temporal": (160, 100, 50),
    "inferior temporal": (180, 20, 20),
    "rostral middle frontal": (75, 50, 125),
    "caudal middle frontal": (100, 25, 0),
}

# the reference's hard-coded legend inventory (plotters.py:2264-2272):
# M1/S1/PPC, IFG, temporal, middle frontal
ANATOMICAL_LEGEND_AREAS = list(FREESURFER_DK_COLORS)


def print_latex_anatomical_legend(
    brain_areas: Sequence[str] | None = None,
    legend_split_points: Sequence[str] = ("pars orbitalis",),
    PRINT: bool = True,
) -> str:
    """LaTeX/TikZ code for the anatomical color legend (reference
    plotters.py:2260-2312): ``\\providecolor`` definitions from the
    FreeSurfer LUT, then an ``\\anatomyLegend`` TikZ command with the
    legend split into stacked nodes at ``legend_split_points``."""
    brain_areas = list(
        ANATOMICAL_LEGEND_AREAS if brain_areas is None else brain_areas
    )
    lines = []
    for area in brain_areas:
        r, g, b = FREESURFER_DK_COLORS[area]
        lines.append(
            r"\providecolor{%s}{RGB}{%d,%d,%d}"
            % (area.replace(" ", ""), r, g, b)
        )
    lines.append("")
    lines.append(r"\newcommand{\anatomyLegend}{%")
    lines.append("\t\\begin{tikzpicture}[>=latex,remember picture]%")
    vertical_pos = 0.0
    lines.append("\t\t\\node at (0,%g) {%%" % vertical_pos)
    for i, area in enumerate(brain_areas):
        lines.append("\t\t\t\\begin{tikzpicture}")
        lines.append(
            "\t\t\t\t\\fill[%s] (1ex,1ex) circle (1ex)"
            % area.replace(" ", "")
        )
        lines.append(
            "\t\t\t\t\tnode[label={[black]right:%s}] {};" % area
        )
        lines.append("\t\t\t\\end{tikzpicture}")
        if area in legend_split_points and i + 1 < len(brain_areas):
            lines.append("\t\t};")
            vertical_pos -= 0.5
            lines.append("\t\t\\node at (0,%g) {%%" % vertical_pos)
    lines.append("\t\t};")
    lines.append("\t\\end{tikzpicture}")
    lines.append("}")
    out = "\n".join(lines)
    if PRINT:
        print(out)
    return out


def _stat(stats: dict, *names):
    for name in names:
        if name in stats:
            return stats[name]
    raise KeyError(f"none of {names} in {sorted(stats)}")


def effect_of_tabularizer(summary_dict: dict, PRINT: bool = True) -> str:
    """LaTeX tabular of per-subject comparison statistics (reference
    plotters.py:2420-2462): one row-triple (p value, test statistic,
    effect size) per participant, one column per comparison suffix.
    ``summary_dict`` is {subj_id: {experiment: {'comparisons':
    {key: {suffix: stats}}}}} with stats from :mod:`assess`
    (``p_value``/``statistic``/``effect_size``; the reference's
    space-separated spellings also accepted)."""
    from .plotters import suffix_to_label

    lines: list[str] = []
    labels: list[str] | None = None
    hline = r"\\\hline"
    for subj_id, summary_entry in summary_dict.items():
        for experiment_dict in summary_entry.values():
            for comparisons in experiment_dict["comparisons"].values():
                tentative = [suffix_to_label(s) for s in comparisons]
                if labels is None:  # first non-empty comparisons set
                    labels = tentative
                    lines.append(
                        r"\begin{tabular}{r%s}" % ("|c" * (len(labels) + 1))
                    )
                    lines.append(
                        r"participant & baseline: & "
                        + " & ".join(labels) + hline + r"\hline"
                    )
                else:
                    assert labels == tentative, (
                        "subjects compared to different baselines"
                    )
                p_values = [
                    "%.1e" % _stat(s, "p_value", "p value")
                    for s in comparisons.values()
                ]
                test_statistics = [
                    "%d" % _stat(s, "statistic", "test statistic", "t")
                    for s in comparisons.values()
                ]
                effect_sizes = [
                    "%.2f" % _stat(s, "effect_size", "effect size",
                                   "mean_diff")
                    for s in comparisons.values()
                ]
                cline = r"\\\cline{2-%i}" % (len(labels) + 2)
                lines.append(
                    r"\ecnum{%s} & (unadjusted) p value & " % subj_id
                    + " & ".join(p_values) + cline
                )
                lines.append(
                    r"           & test statistic & "
                    + " & ".join(test_statistics) + cline
                )
                lines.append(
                    r"           & effect size & "
                    + " & ".join(effect_sizes) + hline
                )
    lines.append(r"\end{tabular}")
    out = "\n".join(lines)
    if PRINT:
        print(out)
    return out
