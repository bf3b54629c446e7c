"""Cross-plotter figure functions.

Rebuilds the reference's module-level figure functions (reference
plotters.py:1595-1927): multi-subject performance-vs-training-data
curves, annotated performance comparisons with statistical-significance
brackets, and a generic performance plot wrapper.

The port's own copy of ``ecog2txt_tpu/plotting/figures.py``; seaborn and
pandas are imported inside ``plot_performance``, matplotlib inside
``_mpl``.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from ..assess import results_comparator


def _mpl():
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    return plt


def plot_performances_vs_amount_of_training_data(
    results_list: Sequence,
    labels: Sequence[str] | None = None,
    colors: Sequence | None = None,
    metric: str = "word_error_rate",
    ax=None,
):
    """Overlayed WER-vs-training-minutes curves across subjects /
    experiments (reference plotters.py:1595-1719)."""
    plt = _mpl()
    if ax is None:
        fig, ax = plt.subplots(figsize=(7, 5))
    else:
        fig = ax.figure
    for i, results in enumerate(results_list):
        minutes = results.nums_seconds.mean_across_folds / 60.0
        matrix = getattr(results, metric)
        ax.errorbar(
            minutes,
            matrix.mean_across_folds,
            yerr=matrix.stderr_across_folds,
            marker="o",
            label=(labels[i] if labels else f"series {i}"),
            color=(colors[i] if colors else None),
        )
    ax.set_xlabel("amount of training data (min)")
    ax.set_ylabel(metric.replace("_", " "))
    ax.set_ylim(bottom=0)
    ax.legend(frameon=False)
    return fig


def pvalue_annotate(ax, x1: float, x2: float, y: float, p_value: float):
    """Significance bracket between two bars (reference
    plotters.py:1875-1927).  Stars: *** <1e-3, ** <1e-2, * <0.05,
    'n.s.' otherwise."""
    if p_value < 1e-3:
        text = "***"
    elif p_value < 1e-2:
        text = "**"
    elif p_value < 0.05:
        text = "*"
    else:
        text = "n.s."
    h = 0.02 * y
    ax.plot(
        [x1, x1, x2, x2], [y, y + h, y + h, y], lw=1.2, color="k",
        solid_capstyle="butt",
    )
    ax.text((x1 + x2) / 2, y + h, text, ha="center", va="bottom")
    return text


def plot_annotated_performances(
    wers_per_condition: dict[str, np.ndarray],
    comparisons: Sequence[tuple[str, str]] = (),
    method: str = "wilcoxon",
    colors=None,
    ax=None,
):
    """Bar plot of per-condition WERs with pairwise significance
    brackets (reference plotters.py:1722-1807)."""
    plt = _mpl()
    if ax is None:
        fig, ax = plt.subplots(figsize=(7, 5))
    else:
        fig = ax.figure
    names = list(wers_per_condition)
    means = [float(np.mean(wers_per_condition[n])) for n in names]
    errs = [
        float(np.std(wers_per_condition[n]) / np.sqrt(len(wers_per_condition[n])))
        for n in names
    ]
    xs = np.arange(len(names))
    ax.bar(
        xs, means, yerr=errs,
        color=(colors if colors else None), capsize=3,
    )
    ax.set_xticks(xs, names, rotation=20, ha="right")
    ax.set_ylabel("word error rate")
    compare = results_comparator(method)
    top = max(m + e for m, e in zip(means, errs)) if names else 0.0
    results = []
    for k, (a, b) in enumerate(comparisons):
        out = compare(
            wers_a=wers_per_condition[a], wers_b=wers_per_condition[b]
        )
        top *= 1.12
        pvalue_annotate(ax, names.index(a), names.index(b), top, out["p_value"])
        results.append({"pair": (a, b), **out})
    return fig, results


def plot_performance(
    values: np.ndarray,
    by: np.ndarray,
    kind: str = "box",
    ax=None,
    ylabel: str = "word error rate",
):
    """Generic grouped performance plot (the reference wraps seaborn,
    plotters.py:1810-1872; seaborn is optional here)."""
    plt = _mpl()
    if ax is None:
        fig, ax = plt.subplots(figsize=(6, 4))
    else:
        fig = ax.figure
    groups: dict = {}
    for v, g in zip(values, by):
        groups.setdefault(g, []).append(float(v))
    names = sorted(groups)
    data = [groups[n] for n in names]
    try:
        import seaborn as sns
        import pandas as pd

        df = pd.DataFrame({"value": values, "group": by})
        plot_fn = {"box": sns.boxplot, "violin": sns.violinplot,
                   "bar": sns.barplot, "strip": sns.stripplot}[kind]
        plot_fn(data=df, x="group", y="value", ax=ax)
    except ImportError:  # pragma: no cover
        if kind == "violin":
            ax.violinplot(data)
            ax.set_xticks(range(1, len(names) + 1), names)
        else:
            ax.boxplot(data, tick_labels=names)
    ax.set_ylabel(ylabel)
    return fig
