"""Plain clustering graph of BASELINE config 5, the yardstick of the
cluster cell.

The semantics are the sparse exact-hybrid clustering of the repository's
``bench_hybrid_large`` (benchmarks/run_benchmarks.py:335-366) on the
upstream's pieces: MinHash signatures (``minhash.py``), each row's
``top_k`` neighbours by agreeing slots (the row itself left out, equal
counts lowest index first), the pairs with a positive count deduplicated
to i < j with weight count / n_hash, the ``thresh_p`` quantile of those
weights by R's type 7 (numpy's "linear") as the threshold, the edges at
or above it kept, each kept edge weighted by the exact NW percent identity
of (sequence i, sequence j) (``nw.py``), and the graph clustered at the
generalized modularity of resolution γ with a unit self-loop at every node
(the upstream's unit diagonal; R/clusterbreak.R:115, igraph's
``cluster_louvain``).

Departure: there is no reference Louvain.  Louvain visits nodes in a
seeded order and its partition is not unique, so a second implementation
would either copy the program's or find another partition of equal worth.
The reference judges a partition instead by its modularity on the
reference's own graph (:func:`modularity`).

Written for this folder and importing nothing of the port.  The top-k is
found as a threshold count and a count of ties, not by sorting keys as the
port does.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import minhash, nw

# most elements of one row block's [b, N, n_hash] compare
BLOCK_ELEMENTS = 1 << 30


def topk_counts(sigs: torch.Tensor, top_k: int):
    """(rows, cols, counts), int64 [N * k] each on the host: each row's
    ``k = min(top_k, N - 1)`` columns with the most agreeing slots, the
    row itself left out, among equal counts the lowest columns, in row
    then column order."""
    n, n_hash = sigs.shape
    k = min(top_k, n - 1)
    if k < 1:
        return (np.zeros(0, dtype=np.int64),) * 3
    block = max(1, BLOCK_ELEMENTS // (n * n_hash))
    out = []
    for s in range(0, n, block):
        e = min(s + block, n)
        counts = (sigs[s:e, None, :] == sigs[None, :, :]).sum(dim=2)
        own = torch.arange(e - s, device=sigs.device)
        counts[own, own + s] = -1
        # the k-th largest count: every column above it is taken, and of
        # the columns equal to it the lowest ones, until k are taken
        kth = torch.topk(counts, k, dim=1).values[:, -1:]
        above = counts > kth
        tied = counts == kth
        room = k - above.sum(dim=1, keepdim=True)
        take = above | (tied & (tied.cumsum(dim=1) <= room))
        r, c = take.nonzero(as_tuple=True)
        out.append(torch.stack([r + s, c, counts[r, c]]).cpu().numpy())
    rows, cols, cnt = np.concatenate(out, axis=1)
    return rows, cols, cnt


@dataclasses.dataclass
class Graph:
    """The kept edges of one precision."""

    keys: np.ndarray  # int64 i * N + j (i < j), sorted
    threshold: float  # in its precision, as a float


def prefilter(n: int, rows, cols, counts, n_hash: int, quantile: float,
              dtype=np.float64) -> Graph:
    """The top-k lists' positive edges, deduplicated to i < j, kept at or
    above the ``quantile`` of their weights; weights, quantile and
    comparison in ``dtype``."""
    pos = counts > 0
    rows, cols, counts = rows[pos], cols[pos], counts[pos]
    keys, first = np.unique(np.minimum(rows, cols) * n
                            + np.maximum(rows, cols), return_index=True)
    w = counts[first].astype(dtype) / dtype(n_hash)
    t = (dtype(np.quantile(w, quantile, method="linear")) if w.size
         else dtype(0))
    return Graph(keys[w >= t], float(t))


def edge_weights(seqs, keys: np.ndarray, settings,
                 device) -> tuple[np.ndarray, np.ndarray]:
    """(matches, lengths), int64, of the exact NW alignment of each edge
    ``keys`` (i * N + j), sequence i as the upstream's sequence 1."""
    n = len(seqs)
    return nw.pair_counts(seqs, np.stack([keys // n, keys % n], axis=1),
                          settings, device)


def modularity(n: int, keys: np.ndarray, weight: np.ndarray, labels,
               resolution: float, dtype=np.float64) -> float:
    """Generalized modularity Q = Σ_ij [A_ij − γ k_i k_j / 2m] δ(c_i, c_j)
    / 2m of ``labels`` on the undirected graph of the edges ``keys`` with
    ``weight`` and a self-loop of weight 1 at every node, counted as igraph
    counts one: 2 to its node's strength and 2 to A_ii.  Summed in
    ``dtype``."""
    _, comm = np.unique(np.asarray(labels), return_inverse=True)
    i, j = keys // n, keys % n
    w = np.asarray(weight, dtype=dtype)
    two = dtype(2)
    strength = np.full(n, two, dtype=dtype)
    np.add.at(strength, i, w)
    np.add.at(strength, j, w)
    two_m = strength.sum(dtype=dtype)
    internal = two * w[comm[i] == comm[j]].sum(dtype=dtype) + two * dtype(n)
    per_comm = np.zeros(comm.max() + 1 if n else 0, dtype=dtype)
    np.add.at(per_comm, comm, strength)
    frac = per_comm / two_m
    q = internal / two_m - dtype(resolution) * (frac * frac).sum(dtype=dtype)
    return float(q)


def lists(seqs, settings, device):
    """:func:`topk_counts` of the MinHash signatures of ``seqs`` under the
    configuration's ``settings`` (k, n_hash, seed, top_k), on ``device``."""
    s = settings
    sigs = minhash.signatures(seqs, s["k"], s["n_hash"], s["seed"], device)
    return topk_counts(sigs, s["top_k"])
