"""Louvain community detection (weighted, resolution-parameterized, seeded).

The reference delegates clustering to igraph's C-implemented
``cluster_louvain`` (R/clusterbreak.R:115-116,126).  python-igraph is not
available here, and bit-identical membership is unattainable anyway (the
algorithm is stochastic; SURVEY.md §7 hard part 4 sets ARI-level parity as
the target), so this is a from-scratch implementation of the standard
two-phase Louvain method (Blondel et al. 2008) with:

* edge weights and self-loops (the reference's graphs carry self-loops —
  ``graph_from_adjacency_matrix`` keeps the unit diagonal);
* a resolution parameter γ entering the null model term, matching
  igraph's generalized modularity  Q = Σ_ij [A_ij − γ k_i k_j / 2m]
  δ(c_i,c_j) / 2m;
* an explicit seed (node visiting order is the only stochastic part).

Graphs are CSR arrays; each node-move pass is O(E) with per-node
``np.bincount`` over neighbor communities, fast enough for ~10^5 nodes /
10^7 edges on the host while the similarity matrix itself is computed on
the card.
"""

from __future__ import annotations

import dataclasses

import numpy as np
from scipy import sparse

from ..utils.profiling import span
from ._native import native_louvain_pass


@dataclasses.dataclass
class LouvainResult:
    membership: np.ndarray  # int64 [n], 0-based community ids (dense)
    modularity: float
    n_levels: int


def modularity(
    adj: sparse.csr_matrix,
    membership: np.ndarray,
    resolution: float = 1.0,
) -> float:
    """Generalized modularity of a partition of an undirected weighted graph.

    ``adj`` must be symmetric; diagonal entries are self-loops (counted
    once in A_ii, twice in strength, igraph convention).
    """
    adj = sparse.csr_matrix(adj)
    membership = np.asarray(membership)
    strengths = np.asarray(adj.sum(axis=1)).ravel() + adj.diagonal()
    two_m = strengths.sum()
    if two_m == 0:
        return 0.0
    coo = adj.tocoo()
    same = membership[coo.row] == membership[coo.col]
    # Σ_ij A_ij δ : off-diagonal entries appear twice in the symmetric
    # matrix; self-loops contribute 2*A_ii in igraph's convention
    diag_mask = coo.row == coo.col
    internal = coo.data[same & ~diag_mask].sum() + 2.0 * coo.data[
        same & diag_mask
    ].sum()
    sum_tot = np.bincount(membership, weights=strengths)
    return float(
        internal / two_m
        - resolution * np.sum((sum_tot / two_m) ** 2)
    )


# above this node count the first sweep runs vectorized synchronous
# passes (the per-node Python loop costs ~10s at 100k nodes; the
# aggregated levels after it are small enough for the exact greedy)
_SYNC_THRESHOLD = 20_000


def _one_level_synchronous(
    indptr: np.ndarray,
    indices: np.ndarray,
    data: np.ndarray,
    strengths: np.ndarray,
    two_m: float,
    resolution: float,
    rng: np.random.Generator,
    max_passes: int = 24,
) -> np.ndarray:
    """Vectorized phase 1 for large graphs: every pass computes ALL
    nodes' best-gain moves against the current (frozen) assignment in
    O(E log E) numpy work, then applies a random subset of the
    improving moves (the stochastic damping prevents the two-node swap
    oscillations synchronous label updating is prone to).  Returns a
    community assignment for the aggregation step — the exact greedy
    refinement then runs on the (much smaller) aggregated graph.
    """
    n = len(indptr) - 1
    comm = np.arange(n, dtype=np.int64)
    gamma = resolution
    row = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    keep = row != indices  # self-loops don't count toward move gains
    row = row[keep]
    col = indices[keep]
    w = data[keep]

    for _ in range(max_passes):
        sum_tot = np.bincount(comm, weights=strengths, minlength=n)
        # group edge weight by (node, neighbor community); rows are
        # already contiguous (CSR expansion), so the sorted key leaves
        # every node's groups contiguous too
        tc = comm[col]
        key = row * np.int64(n) + tc
        order = np.argsort(key, kind="stable")
        ks = key[order]
        ws = w[order]
        starts = np.concatenate(([0], np.nonzero(ks[1:] != ks[:-1])[0] + 1))
        w_to = np.add.reduceat(ws, starts)
        gk = ks[starts]
        gv = gk // n
        gc = gk % n
        kv = strengths[gv]
        # gain of v joining C, with v removed from its own community
        tot_c = sum_tot[gc] - np.where(gc == comm[gv], kv, 0.0)
        gains = w_to - gamma * kv * tot_c / two_m
        # stay gain per node: the group where C == comm[v] (0 if no
        # neighbor remains there), floored at the empty-community 0
        stay = np.zeros(n)
        own = gc == comm[gv]
        stay[gv[own]] = gains[own]
        stay = np.maximum(stay, 0.0)
        # per-node argmax: node segments are contiguous in the group
        # arrays, so a maximum.reduceat + first-match scan avoids a
        # second sort
        nb = np.concatenate(
            ([0], np.nonzero(gv[1:] != gv[:-1])[0] + 1)
        )
        seg_max = np.maximum.reduceat(gains, nb)
        seg_id = np.cumsum(
            np.concatenate(([0], (gv[1:] != gv[:-1]).astype(np.int64)))
        )
        is_best = gains == seg_max[seg_id]
        # first best entry of each segment
        first_best = is_best & np.concatenate(
            ([True], ~(is_best[:-1] & (gv[1:] == gv[:-1])))
        )
        # (a segment may contain several best-tied groups; keep the
        # first occurrence per node)
        fb_idx = np.nonzero(first_best)[0]
        fb_v = gv[fb_idx]
        keep_first = np.concatenate(([True], fb_v[1:] != fb_v[:-1]))
        fb_idx = fb_idx[keep_first]
        best_v = gv[fb_idx]
        best_c = gc[fb_idx]
        best_g = gains[fb_idx]
        improving = (best_g > stay[best_v] + 1e-12) & (
            best_c != comm[best_v]
        )
        cand = best_v[improving]
        if len(cand) == 0:
            break
        # stochastic damping: each improving node moves with prob 0.8
        # (full synchronous updates oscillate on two-node swaps)
        sel = rng.random(len(cand)) < 0.8
        if not np.any(sel):
            continue
        comm[cand[sel]] = best_c[improving][sel]
        if len(cand) < max(n // 1000, 1):
            break
    return comm


def _numpy_pass(
    indptr: np.ndarray,
    indices: np.ndarray,
    data: np.ndarray,
    strengths: np.ndarray,
    two_m: float,
    gamma: float,
    order: np.ndarray,
    comm: np.ndarray,
    sum_tot: np.ndarray,
) -> bool:
    """One greedy pass over the nodes in ``order``, in place on ``comm``
    and ``sum_tot``; returns whether any node moved.  The plain version of
    the native pass (cpp/louvain_pass.cpp), which transcribes it double
    for double: the tests hold the two equal."""
    improved_any = False
    for v in order:
        cv = comm[v]
        kv = strengths[v]
        lo, hi = indptr[v], indptr[v + 1]
        nbrs = indices[lo:hi]
        wts = data[lo:hi]
        keep = nbrs != v  # self-loops don't count toward move gains
        nbrs = nbrs[keep]
        wts = wts[keep]
        if len(nbrs) == 0:
            continue
        ncomms = comm[nbrs]
        # accumulate weight to each neighbor community
        uniq, inv = np.unique(ncomms, return_inverse=True)
        w_to = np.bincount(inv, weights=wts)
        # remove v from its community for the comparison
        sum_tot[cv] -= kv
        # gain of joining community C: w(v,C) - γ k_v Σtot_C / 2m
        gains = w_to - gamma * kv * sum_tot[uniq] / two_m
        # gain of staying put (w(v, cv\{v}) may be 0 if no neighbors
        # remain there); a singleton restart scores exactly 0
        in_uniq = np.nonzero(uniq == cv)[0]
        stay = (
            float(gains[in_uniq[0]])
            if len(in_uniq)
            else -gamma * kv * sum_tot[cv] / two_m
        )
        stay = max(stay, 0.0)  # moving to an empty community gains 0
        best = int(np.argmax(gains))
        if gains[best] > stay + 1e-12 and uniq[best] != cv:
            comm[v] = uniq[best]
            sum_tot[uniq[best]] += kv
            improved_any = True
        else:
            sum_tot[cv] += kv
    return improved_any


# the pass _one_level runs: always the native one (a failed build raises).
# Tests swap in _numpy_pass to hold the two equal.
_greedy_pass = native_louvain_pass


def _one_level(
    indptr: np.ndarray,
    indices: np.ndarray,
    data: np.ndarray,
    strengths: np.ndarray,
    two_m: float,
    resolution: float,
    rng: np.random.Generator,
    max_passes: int = 32,
) -> np.ndarray:
    """Phase 1: greedy node moves until no improvement.  Returns community
    assignment (not renumbered).

    One call of the pass per sweep, so the ``rng.permutation`` stream
    advances the same way whichever pass runs.
    """
    n = len(indptr) - 1
    comm = np.arange(n, dtype=np.int64)
    sum_tot = strengths.copy()  # per community total strength
    # scipy CSR uses int32 indices; the passes take int64
    indptr = np.ascontiguousarray(indptr, dtype=np.int64)
    indices = np.ascontiguousarray(indices, dtype=np.int64)
    data = np.ascontiguousarray(data, dtype=np.float64)
    strengths = np.ascontiguousarray(strengths, dtype=np.float64)

    improved_any = True
    passes = 0
    while improved_any and passes < max_passes:
        passes += 1
        order = np.ascontiguousarray(rng.permutation(n), dtype=np.int64)
        improved_any = _greedy_pass(
            indptr, indices, data, strengths, float(two_m),
            float(resolution), order, comm, sum_tot,
        )
    return comm


def louvain(
    adj: sparse.spmatrix | np.ndarray,
    *,
    resolution: float = 1.0,
    seed: int = 0,
    max_levels: int = 32,
    sync_threshold: int | None = None,
) -> LouvainResult:
    """Two-phase Louvain on an undirected weighted graph.

    Args:
      adj: symmetric adjacency (dense or sparse); diagonal = self-loops.
      resolution: γ in the generalized modularity (igraph-compatible).
      seed: RNG seed for node visiting order.
      sync_threshold: node count above which the first sweep runs the
        vectorized synchronous pass (default ``_SYNC_THRESHOLD``; tests
        pass 0 to force the large-graph path on small graphs).
    """
    with span("louvain"):
        A = sparse.csr_matrix(adj, dtype=np.float64)
        n0 = A.shape[0]
        rng = np.random.default_rng(seed)

        # original node -> current node
        mapping = np.arange(n0, dtype=np.int64)
        A_top = A.copy()
        levels = 0
        while True:
            levels += 1
            strengths = np.asarray(A.sum(axis=1)).ravel() + A.diagonal()
            two_m = strengths.sum()
            if two_m == 0:
                break
            thr = (
                _SYNC_THRESHOLD if sync_threshold is None else sync_threshold
            )
            if A.shape[0] > thr:
                comm = _one_level_synchronous(
                    A.indptr, A.indices, A.data, strengths, two_m,
                    resolution, rng,
                )
            else:
                comm = _one_level(
                    A.indptr, A.indices, A.data, strengths, two_m,
                    resolution, rng,
                )
            uniq, dense = np.unique(comm, return_inverse=True)
            n_comms = len(uniq)
            mapping = dense[mapping]
            if n_comms == A.shape[0] or levels >= max_levels:
                break
            # Phase 2: aggregate graph — community -> super-node
            proj = sparse.csr_matrix(
                (np.ones(A.shape[0]), (np.arange(A.shape[0]), dense)),
                shape=(A.shape[0], n_comms),
            )
            A = (proj.T @ A @ proj).tocsr()
            A.sum_duplicates()

        q = modularity(A_top, mapping, resolution)
        return LouvainResult(
            membership=mapping, modularity=q, n_levels=levels
        )
