"""Clustering orchestration: netcluster, louvain_mod, clusterbreak.

API parity with the reference's L3 layer (R/clusterbreak.R):

* ``netcluster`` (R/clusterbreak.R:112-136): similarity matrix → graph →
  pluggable cluster function → membership vector.
* ``louvain_mod`` (R/clusterbreak.R:37-67): resolution-scanning Louvain
  keeping the max-modularity run.  (The reference has a quirk where
  ``best_resolution`` is only updated on iterations i>1, so a best found
  at i==1 of a later resolution keeps a stale label — we return the
  correct resolution and note the divergence here.)
* ``clusterbreak`` (R/clusterbreak.R:180-275): the flagship recursive
  size-capped clustering routine.  Defaults mirror the reference:
  thresh_p=0.8, size_max=10, size_min=3, max_itr=10000,
  sim_fn=similarityMH(k=2, n_hash=50), Louvain resolution 1.05, labels
  "<itr>.<clusterid>".  On hitting max_itr the reference returns a bare
  matrix instead of its documented list (latent bug, :211-215); we return
  the standard result structure with convergence=0 instead.

The similarity matrices come from the injected ``sim_fn`` (default: a
:class:`dynaalign_torch.api.MinHashEngine` on ``device``); the recursion
itself is a host-side loop, exactly as in the reference where control
only leaves R via .Call.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Sequence

import numpy as np
from scipy import sparse

from ..utils.logging import log_message
from .graph import adjacency_from_matrix, quantile_threshold
from .louvain import LouvainResult, louvain, modularity


def netcluster(
    pepmat: np.ndarray,
    *,
    igraph_mode: str = "upper",
    cluster_func: Callable[[sparse.csr_matrix], np.ndarray] | None = None,
    resolution: float = 1.05,
    seed: int = 0,
) -> np.ndarray:
    """Similarity/adjacency matrix → 1-based cluster membership vector.

    Default cluster function is Louvain at resolution 1.05
    (R/clusterbreak.R:115-116).  A custom ``cluster_func`` receives the
    CSR adjacency and must return a numeric membership vector
    (validated, like R/clusterbreak.R:131-135).
    """
    pepmat = np.asarray(pepmat)
    if pepmat.ndim != 2 or pepmat.shape[0] != pepmat.shape[1]:
        raise ValueError("Input must be a square pairwise similarity matrix")
    adj = adjacency_from_matrix(pepmat, mode=igraph_mode)
    if cluster_func is None:
        out = louvain(adj, resolution=resolution, seed=seed).membership + 1
    else:
        out = cluster_func(adj)
    out = np.asarray(out)
    if out.ndim != 1 or not np.issubdtype(out.dtype, np.number):
        raise ValueError(
            "Wrong clustering output format. Output should be a numeric "
            "vector of cluster assignment."
        )
    return out.astype(np.int64)


def louvain_mod(
    adj: sparse.spmatrix | np.ndarray,
    res: float,
    res_range_perc: float = 0.0,
    res_step: float = 0.0,
    itr: int = 3,
    *,
    seed: int = 0,
) -> dict:
    """Resolution-scanning Louvain (R/clusterbreak.R:37-67).

    Scans resolutions res ± res_range_perc*res in steps of res_step,
    running ``itr`` seeded repeats each, and keeps the maximum-modularity
    clustering.  Returns {"cluster", "resolution", "modularity"}.
    """
    if res_step > 0:
        lo = res - res_range_perc * res
        hi = res + res_range_perc * res
        n_steps = int(np.floor((hi - lo) / res_step + 1e-9)) + 1
        resolutions = [lo + i * res_step for i in range(n_steps)]
    else:
        resolutions = [res]

    best: LouvainResult | None = None
    best_res = resolutions[0]
    s = seed
    for r in resolutions:
        for _ in range(max(1, itr)):
            result = louvain(adj, resolution=r, seed=s)
            s += 1
            if best is None or result.modularity > best.modularity:
                best = result
                best_res = r
    assert best is not None
    return {
        "cluster": best.membership + 1,
        "resolution": best_res,
        "modularity": best.modularity,
    }


def _save_checkpoint(path: str, state: dict) -> None:
    import pickle

    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(state, f)
    os.replace(tmp, path)


def _load_checkpoint(path: str) -> dict | None:
    import pickle

    if not os.path.exists(path):
        return None
    with open(path, "rb") as f:
        return pickle.load(f)


def _clear_checkpoint(path: str) -> None:
    if os.path.exists(path):
        os.remove(path)


@dataclasses.dataclass
class ClusterBreakResult:
    """Reference return structure (R/clusterbreak.R:257-258)."""

    clustered_seq: np.ndarray  # [n, 2] object array: (sequence, "itr.cid")
    filtered_seq: list[str]
    converged: bool
    n_calls: int

    def as_dict(self) -> dict:
        return {
            "clustered_seq": self.clustered_seq,
            "filtered_seq": self.filtered_seq,
        }


def _fresh_each_call(sim_fn) -> bool:
    """Whether ``sim_fn`` is ``Pipeline.similarity`` of a pipeline given
    no ``sim_fn`` of its own: its engines return a new array each call."""
    from ..models.pipeline import Pipeline

    return (getattr(sim_fn, "__func__", None) is Pipeline.similarity
            and sim_fn.__self__._sim_fn is None)


def clusterbreak(
    pep: Sequence[str],
    thresh_p: float = 0.8,
    size_max: int = 10,
    size_min: int = 3,
    max_itr: int = 10000,
    sim_fn: Callable[[list[str]], np.ndarray] | None = None,
    cluster_fn: Callable[[sparse.csr_matrix], np.ndarray] | None = None,
    *,
    resolution: float = 1.05,
    seed: int = 0,
    verbose: bool = True,
    device=None,
    checkpoint_path: str | None = None,
    checkpoint_every: int = 10,
) -> ClusterBreakResult:
    """Recursive size-capped clustering (R/clusterbreak.R:180-275).

    Per recursion level: similarity matrix on the current subset (via
    ``sim_fn``; default MinHash k=2 n_hash=50 on ``device``) → quantile
    threshold → Louvain membership → clusters larger than ``size_max``
    recurse on a fresh similarity matrix, smaller than ``size_min`` are
    dropped to ``filtered_seq``, the rest are labeled "<itr>.<cid>".

    The recursion is executed as an explicit depth-first worklist with
    the reference's pre-order ``itr`` numbering, which makes long runs
    checkpointable: pass ``checkpoint_path`` to persist
    (worklist, itr, outputs) every ``checkpoint_every`` subsets and to
    resume an interrupted run transparently (the reference keeps all
    state in an in-memory environment, R/clusterbreak.R:197-201, and has
    no resume capability — SURVEY.md §5).

    A caller's ``sim_fn`` may return an array it keeps (a cache, a slice
    of a larger matrix): clusterbreak copies it before it zeroes the
    entries under the threshold, so the caller's array comes back
    unchanged.  Only the arrays of the in-package engines, which are fresh
    on every call (the default MinHash engine, and ``Pipeline.similarity``
    of a pipeline given no ``sim_fn``), are thresholded in place, which
    saves a copy of each matrix (525 MB on all 8,103 h3n2sample rows).
    """
    if size_max <= size_min:
        raise ValueError("size_max must be greater than size_min")
    pep = list(pep)
    if len(pep) == 0:
        raise ValueError("empty input sequence vector")

    owned = sim_fn is None or _fresh_each_call(sim_fn)
    if sim_fn is None:
        # signature-caching engine: signatures and agreement counts are
        # built once for the full set and each recursion subset is a
        # slice of them, equal to calling similarity_mh per subset (a
        # signature depends only on (sequence, k, n_hash, seed))
        from ..api import MinHashEngine

        sim_fn = MinHashEngine(pep, k=2, n_hash=50, seed=seed, device=device)

    state = {
        "rows": [],  # list of (sequence, label)
        "itr": 0,
        "convergence": 1,
        "filtered": [],
        "stack": [[str(s) for s in pep]],  # DFS worklist (LIFO)
        "input_fingerprint": (len(pep), str(pep[0]), str(pep[-1])),
    }
    if checkpoint_path is not None:
        loaded = _load_checkpoint(checkpoint_path)
        if loaded is not None:
            if loaded["input_fingerprint"] != state["input_fingerprint"]:
                raise ValueError(
                    "checkpoint does not match the input sequence set"
                )
            state = loaded
            log_message(
                f"Resumed from checkpoint at itr={state['itr']}", "INFO"
            )

    processed_since_ckpt = 0
    while state["stack"]:
        sub = state["stack"].pop()
        state["itr"] += 1
        if state["itr"] > max_itr:
            log_message("Maximum function calls reached", "WARNING")
            state["convergence"] = 0
            # the reference aborts this branch; remaining siblings would
            # each trip the same guard, so drain the worklist
            state["stack"].clear()
            break

        # the entries under the threshold are zeroed below: a caller's
        # array is copied first (see the docstring)
        sim = np.asarray(sim_fn(sub), dtype=np.float64)
        if not (owned and sim.flags.writeable):
            sim = sim.copy()
        t = quantile_threshold(sim, thresh_p)
        sim[sim < t] = 0.0
        c_index = netcluster(
            sim, cluster_func=cluster_fn, resolution=resolution, seed=seed
        )
        sizes = np.bincount(c_index, minlength=c_index.max() + 1)[1:]
        ids = np.arange(1, len(sizes) + 1)
        id_itr = set(ids[sizes > size_max].tolist())
        id_rm = set(ids[sizes < size_min].tolist())

        seqs = np.asarray(sub, dtype=object)
        for s in seqs[np.isin(c_index, list(id_rm))]:
            state["filtered"].append(str(s))

        keep = ~np.isin(c_index, list(id_rm)) & ~np.isin(
            c_index, list(id_itr)
        )
        for s, cid in zip(seqs[keep], c_index[keep]):
            state["rows"].append((str(s), f"{state['itr']}.{cid}"))

        # push oversized clusters in reverse so the lowest cluster id is
        # processed next — reproduces the reference's DFS pre-order itr
        # numbering (R/clusterbreak.R:250-254)
        for cid in sorted(id_itr, reverse=True):
            members = [str(s) for s in seqs[c_index == cid]]
            state["stack"].append(members)

        processed_since_ckpt += 1
        if (
            checkpoint_path is not None
            and processed_since_ckpt >= checkpoint_every
        ):
            _save_checkpoint(checkpoint_path, state)
            processed_since_ckpt = 0

    if checkpoint_path is not None:
        _clear_checkpoint(checkpoint_path)

    if verbose:
        if state["convergence"] == 1:
            print("\nClustering complete:")
        else:
            print("\nClustering incomplete, consider adjusting parameters:")
        print(
            f"Total function calls (clusters broken): {state['itr']}"
        )

    rows = state["rows"]
    clustered = (
        np.array(rows, dtype=object)
        if rows
        else np.empty((0, 2), dtype=object)
    )
    return ClusterBreakResult(
        clustered_seq=clustered,
        filtered_seq=state["filtered"],
        converged=bool(state["convergence"]),
        n_calls=state["itr"],
    )
