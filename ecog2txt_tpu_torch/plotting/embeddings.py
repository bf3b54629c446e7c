"""Word-embedding clustering and low-dimensional projections.

Rebuilds the reference's ``cluster_embeddings`` (reference
plotters.py:2315-2380: PCA/t-SNE + Gaussian-mixture clustering over the
decoder word-embedding rows) and ``scatter_desequenced_data``
(plotters.py:2384-2417).

The port's own copy of ``ecog2txt_tpu/plotting/embeddings.py``; sklearn
is imported inside the functions that need it.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


def _mpl():
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    return plt


def embed_rows(
    embeddings: np.ndarray,
    method: str = "pca",
    num_components: int = 2,
    seed: int = 0,
) -> np.ndarray:
    """(V, E) embedding matrix → (V, num_components) projection."""
    embeddings = np.asarray(embeddings, float)
    if method == "pca":
        from sklearn.decomposition import PCA

        return PCA(n_components=num_components, random_state=seed).fit_transform(
            embeddings
        )
    if method == "tsne":
        from sklearn.manifold import TSNE

        return TSNE(
            n_components=num_components,
            random_state=seed,
            perplexity=min(30.0, max(2.0, len(embeddings) / 4)),
            init="pca",
        ).fit_transform(embeddings)
    raise ValueError(f"unknown method {method!r}")


def cluster_embeddings(
    embeddings: np.ndarray,
    class_list: Sequence[str] | None = None,
    method: str = "pca",
    num_clusters: int = 8,
    num_components: int = 2,
    seed: int = 0,
    plot: bool = True,
):
    """Project embedding rows and cluster with a Gaussian mixture.

    Returns (projection (V, k), cluster_ids (V,), figure|None)."""
    from sklearn.mixture import GaussianMixture

    projection = embed_rows(embeddings, method, num_components, seed)
    num_clusters = min(num_clusters, len(projection))
    gmm = GaussianMixture(
        n_components=num_clusters, random_state=seed, covariance_type="full"
    )
    cluster_ids = gmm.fit_predict(projection)
    fig = None
    if plot:
        plt = _mpl()
        fig, ax = plt.subplots(figsize=(7, 6))
        sc = ax.scatter(
            projection[:, 0], projection[:, 1],
            c=cluster_ids, cmap="tab10", s=24,
        )
        if class_list is not None and len(class_list) <= 200:
            for (x, y), token in zip(projection, class_list):
                ax.annotate(
                    token, (x, y), fontsize=5, alpha=0.6,
                    xytext=(2, 2), textcoords="offset points",
                )
        ax.set_title(f"{method} projection of decoder embeddings")
    return projection, cluster_ids, fig


def scatter_desequenced_data(
    sequences: Sequence[np.ndarray],
    labels: Sequence[int] | None = None,
    method: str = "pca",
    seed: int = 0,
):
    """Flatten (T_i, F) sequences to per-step points, project, scatter
    colored by sequence id (reference plotters.py:2384-2417)."""
    points = np.concatenate([np.asarray(s, float) for s in sequences])
    ids = np.concatenate(
        [
            np.full(len(s), labels[i] if labels is not None else i)
            for i, s in enumerate(sequences)
        ]
    )
    projection = embed_rows(points, method, 2, seed)
    plt = _mpl()
    fig, ax = plt.subplots(figsize=(7, 6))
    ax.scatter(projection[:, 0], projection[:, 1], c=ids, cmap="tab20", s=8)
    return projection, ids, fig
