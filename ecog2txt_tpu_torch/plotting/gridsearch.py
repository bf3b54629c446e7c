"""Hyperparameter grid-search projections.

Rebuilds the reference's grid-search heatmap machinery (reference
plotters.py:2159-2257): results of a hyperparameter sweep are stored as
``grid_search_{subject}_…`` archives mapping hyperparameter settings →
WER; 2-D projections marginalize (min or mean) over the remaining axes.
Native container is npz (hickle-free, like plotting.results).

The port's own copy of ``ecog2txt_tpu/plotting/gridsearch.py``.
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np


def save_grid_search(
    path: str,
    param_names: Sequence[str],
    param_values: Sequence[Sequence],
    wers: np.ndarray,
) -> str:
    """``wers`` has one axis per hyperparameter, in ``param_names``
    order."""
    if not path.endswith(".npz"):
        path += ".npz"
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(
        path,
        param_names=np.asarray(param_names, dtype=object),
        wers=np.asarray(wers, float),
        allow_pickle=True,
        **{
            f"values_{name}": np.asarray(vals)
            for name, vals in zip(param_names, param_values)
        },
    )
    return path


class GridSearchResults:
    def __init__(self, path: str):
        for ext in (".npz", ".hkl"):
            if not path.endswith(ext) and os.path.exists(path + ext):
                path += ext
                break
        if path.endswith(".hkl"):
            self._init_from_hkl(path)
            return
        with np.load(path, allow_pickle=True) as z:
            self.param_names = [str(n) for n in z["param_names"]]
            self.wers = z["wers"]
            self.param_values = {
                name: z[f"values_{name}"] for name in self.param_names
            }

    def _init_from_hkl(self, path: str) -> None:
        """Reference-toolchain archive: a hickle tuple ``(all_results,
        parameter_names, grids)`` where ``grids`` are meshgrid-flattened
        coordinates over the search grid (reference
        plotters.py:2216-2221, 2159-2199)."""
        from .hkl import find_mapping, load_hkl

        raw = load_hkl(path)
        if not (isinstance(raw, (list, tuple)) and len(raw) >= 3):
            raise ValueError(f"{path}: expected (results, names, grids)")
        all_results, parameter_names, grids = raw[0], raw[1], raw[2]
        results = find_mapping(all_results, ("word_error_rate",))
        if results is None:
            raise ValueError(f"{path}: no word_error_rate in results")
        self.param_names = [str(n) for n in np.atleast_1d(parameter_names)]
        grids = [np.asarray(g, float) for g in grids]
        # grid shape: per-axis unique-count, in meshgrid('ij') layout
        grid_shape = tuple(
            len(np.unique(g)) for g in grids
        )
        wers = np.asarray(results["word_error_rate"], float).reshape(
            grid_shape
        )
        self.wers = wers
        self.param_values = {}
        for i, name in enumerate(self.param_names):
            g = grids[i].reshape(grid_shape)
            index = tuple(
                slice(None) if j == i else 0 for j in range(len(grid_shape))
            )
            self.param_values[name] = g[index]

    def project(
        self,
        x_param: str,
        y_param: str,
        reduce: str = "min",
        conditions: dict | None = None,
    ) -> np.ndarray:
        """Marginalize all other axes (min = best-case, mean = average)
        → (len(y values), len(x values)) heatmap matrix.  ``conditions``
        (param name → value) slices those axes to the given value
        instead of marginalizing (the reference's conditioning_list,
        plotters.py:2164-2199)."""
        xi = self.param_names.index(x_param)
        yi = self.param_names.index(y_param)
        wers = self.wers
        if conditions:
            indexer: list = [slice(None)] * wers.ndim
            for name, value in conditions.items():
                i = self.param_names.index(name)
                if i in (xi, yi):
                    raise ValueError(f"{name} is a heatmap axis")
                matches = np.where(
                    np.asarray(self.param_values[name]) == value
                )[0]
                if not len(matches):
                    raise ValueError(f"{name} has no grid point {value!r}")
                # length-1 slice (not an index array): keeps ndim and
                # axis order so xi/yi stay valid
                indexer[i] = slice(matches[0], matches[0] + 1)
            wers = wers[tuple(indexer)]
        axes = tuple(
            i for i in range(wers.ndim) if i not in (xi, yi)
        )
        fn = {"min": np.nanmin, "mean": np.nanmean, "max": np.nanmax}[reduce]
        out = fn(wers, axis=axes) if axes else wers
        if xi < yi:
            out = out.T
        return out

    def best(self) -> dict:
        idx = np.unravel_index(np.nanargmin(self.wers), self.wers.shape)
        return {
            "wer": float(self.wers[idx]),
            **{
                name: self.param_values[name][i]
                for name, i in zip(self.param_names, idx)
            },
        }

    def plot_projection(
        self,
        x_param: str,
        y_param: str,
        reduce: str = "min",
        ax=None,
        conditions: dict | None = None,
    ):
        import matplotlib

        matplotlib.use("Agg", force=False)
        import matplotlib.pyplot as plt

        if ax is None:
            fig, ax = plt.subplots(figsize=(6, 5))
        else:
            fig = ax.figure
        matrix = self.project(x_param, y_param, reduce, conditions)
        im = ax.imshow(matrix, cmap="viridis", aspect="auto")
        ax.set_xticks(
            range(len(self.param_values[x_param])),
            [str(v) for v in self.param_values[x_param]],
        )
        ax.set_yticks(
            range(len(self.param_values[y_param])),
            [str(v) for v in self.param_values[y_param]],
        )
        ax.set_xlabel(x_param)
        ax.set_ylabel(y_param)
        fig.colorbar(im, ax=ax, label=f"{reduce} WER")
        return fig


def ith_param_range(grids, ii, grid_shape):
    """Distinct values of hyperparameter ``ii`` from meshgrid-flattened
    search coordinates (reference plotters.py:2159-2162): ``grids`` is
    (N_points, N_params) with ``N_points == prod(grid_shape)``."""
    grids = np.asarray(grids, float)
    ith_grid = np.reshape(grids[:, ii], grid_shape)
    return np.reshape(np.moveaxis(ith_grid, ii, -1), [-1])[
        : ith_grid.shape[ii]
    ]


def all_grid_search_projections(
    results: "GridSearchResults | str",
    marginal_params: Sequence[str],
    reduce: str = "mean",
    annotate: bool = True,
):
    """Every 2-D heatmap slice of a grid search, conditioned on each
    combination of ``marginal_params`` values (reference
    plotters.py:2207-2257).

    The two parameters NOT in ``marginal_params`` form the heatmap axes
    of every subplot.  Subplots within a figure sweep the last two
    marginal params; one figure is produced per combination of any
    remaining (outer) marginal params.  Returns the list of figures.
    """
    import itertools

    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    if isinstance(results, str):
        results = GridSearchResults(results)
    heat_params = [p for p in results.param_names if p not in marginal_params]
    if len(heat_params) != 2:
        raise ValueError(
            f"need exactly 2 non-marginal params for heatmap axes, "
            f"got {heat_params}"
        )
    y_param, x_param = heat_params
    ranges = [list(results.param_values[p]) for p in marginal_params]
    outer_params = list(marginal_params[:-2])
    inner_params = list(marginal_params[-2:])
    subplot_shape = [len(results.param_values[p]) for p in inner_params]
    per_fig = int(np.prod(subplot_shape)) if subplot_shape else 1
    vmax = float(np.nanmax(results.wers))

    figures = []
    fig = None
    for ii, conditioning in enumerate(itertools.product(*ranges)):
        jj = ii % per_fig
        if jj == 0:
            fig, axes = plt.subplots(
                *(subplot_shape or [1, 1]),
                figsize=(3 * max(subplot_shape[-1:] or [1], default=1), 9),
                squeeze=False,
            )
            outer_bits = ", ".join(
                f"{p}={c}" for p, c in zip(outer_params, conditioning)
            )
            fig.suptitle(f"Performance: {outer_bits}" if outer_bits else
                         "Performance")
            figures.append(fig)
        ax = fig.axes[jj]
        conditions = dict(zip(marginal_params, conditioning))
        matrix = results.project(x_param, y_param, reduce, conditions)
        ax.imshow(matrix, cmap="viridis", aspect="auto", vmin=0, vmax=vmax)
        if annotate:
            for (r, c), val in np.ndenumerate(matrix):
                if np.isfinite(val):
                    ax.text(c, r, f"{val:.2f}", ha="center", va="center",
                            fontsize=7, color="w")
        ax.set_xticks(
            range(len(results.param_values[x_param])),
            [str(v) for v in results.param_values[x_param]], fontsize=7,
        )
        ax.set_yticks(
            range(len(results.param_values[y_param])),
            [str(v) for v in results.param_values[y_param]], fontsize=7,
        )
        inner_bits = ", ".join(
            f"{p}={c}"
            for p, c in zip(marginal_params, conditioning)
            if p in inner_params
        )
        ax.set_title(inner_bits, fontsize=8)
        ax.set_xlabel(x_param, fontsize=8)
        ax.set_ylabel(y_param, fontsize=8)
    return figures
