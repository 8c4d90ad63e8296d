"""Visualizations: similarity heatmap and consensus network plot.

Equivalents of the reference's ``plot_similarity_matrix``
(R/plotting.R:14-29, stats::heatmap with optional hclust dendrogram
ordering) and ``consensusplot`` (R/clusterbreak.R:379-399, MinHash over
consensus sequences → thresholded graph → Louvain communities →
Fruchterman–Reingold layout), rendered with matplotlib + networkx.
"""

from __future__ import annotations

import warnings

import numpy as np


def plot_similarity_matrix(
    x: np.ndarray,
    cluster: bool = True,
    *,
    ax=None,
    cmap: str = "viridis",
    title: str = "Similarity Matrix Heatmap",
):
    """Heatmap of a similarity matrix, optionally ordered by hierarchical
    clustering of rows/columns (R/plotting.R:22-28 semantics).

    Returns (ax, row_order, col_order).
    """
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    x = np.asarray(x, dtype=float)
    if x.ndim != 2:
        raise ValueError("Input must be a matrix")
    if x.shape[0] != x.shape[1] or not np.allclose(x, x.T, equal_nan=True):
        warnings.warn(
            "Input matrix is not symmetric. Results may be unexpected."
        )
    order_r = np.arange(x.shape[0])
    order_c = np.arange(x.shape[1])
    if cluster and x.shape[0] > 2:
        from scipy.cluster.hierarchy import leaves_list, linkage
        from scipy.spatial.distance import pdist

        # R: hclust(dist(X)) — euclidean row distances, complete linkage
        order_r = leaves_list(linkage(pdist(x), method="complete"))
        order_c = leaves_list(linkage(pdist(x.T), method="complete"))
    if ax is None:
        _, ax = plt.subplots(figsize=(6, 5))
    im = ax.imshow(x[np.ix_(order_r, order_c)], cmap=cmap, aspect="auto")
    ax.set_title(title)
    ax.set_xlabel("Sequence/Item Index")
    ax.set_ylabel("Sequence/Item Index")
    ax.figure.colorbar(im, ax=ax, shrink=0.8)
    return ax, order_r, order_c


def consensus_plot(
    df: np.ndarray,
    k_size: int = 2,
    hash_size: int = 50,
    threshold_p: float = 0.8,
    sens: float = 1.05,
    *,
    seed: int = 0,
    quirk_compat: bool = False,
    ax=None,
):
    """Consensus-sequence network plot (reference consensusplot,
    R/clusterbreak.R:379-399).

    Builds a MinHash similarity graph over the consensus sequences
    (column 1 of ``df``), thresholds at the ``threshold_p`` quantile,
    clusters with Louvain at resolution ``sens``, and draws a
    spring-layout (Fruchterman–Reingold) network colored by community,
    node labels = cluster ids (column 0).

    Note: the reference thresholds the pure-R pipeline's *distance*
    matrix as if it were a similarity matrix (documented quirk,
    it keeps the most DISsimilar edges).  By default
    we use similarity = 1 - distance; pass ``quirk_compat=True`` to
    reproduce the reference's behavior exactly.

    Returns (ax, membership).
    """
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt
    import networkx as nx

    from ..cluster.graph import adjacency_from_matrix
    from ..cluster.louvain import louvain
    from ..models.reference_r import minhash

    arr = np.asarray(df, dtype=object)
    seqs = [str(s) for s in arr[:, 1]]
    names = [str(s) for s in arr[:, 0]]
    res = minhash(seqs, k=k_size, n_hash=hash_size, seed=seed)
    mat = res["dist_matrix"]
    if not quirk_compat:
        mat = 1.0 - mat
        np.fill_diagonal(mat, 1.0)
    iu = np.triu_indices(mat.shape[0], k=1)
    if iu[0].size:
        t = np.quantile(mat[iu], threshold_p)
        mat = mat.copy()
        mat[mat < t] = 0.0
    adj = adjacency_from_matrix(mat, mode="upper")
    member = louvain(adj, resolution=sens, seed=seed).membership

    g = nx.Graph()
    g.add_nodes_from(range(len(seqs)))
    coo = adj.tocoo()
    for i, j, w in zip(coo.row, coo.col, coo.data):
        if i < j and w > 0:
            g.add_edge(int(i), int(j), weight=float(w))
    pos = nx.spring_layout(g, seed=seed)  # Fruchterman-Reingold
    if ax is None:
        _, ax = plt.subplots(figsize=(6, 6))
    cmap = plt.get_cmap("tab20")
    colors = [cmap(int(c) % 20) for c in member]
    nx.draw_networkx(
        g, pos=pos, ax=ax, node_color=colors,
        labels=dict(enumerate(names)), font_size=8, node_size=300,
    )
    ax.set_axis_off()
    return ax, member
