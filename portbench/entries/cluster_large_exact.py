"""``dynaalign_torch.cluster_large_exact``: BASELINE config 5 exact, the
MinHash top-k prefilter, exact NW rescoring of the kept edges and Louvain,
with no dense matrix.

Work: n(n-1)/2 MinHash pairs a call, the pairs the top-k compares.
Judged: the graph the program clustered, which it hands out in its
``graph`` dict, and its labels, against ``reference/cluster.py``.  After
each call a run keeps the kept edges, the labels, a digest of the whole
result, and ``per_call`` edges with their weights drawn from ``--seed``
and the call; the result itself is freed.  Once the window has closed:

``edges_unequal``
    edges in one set and not the other, the program's against the
    reference's, summed over the calls;
``threshold_unequal``
    calls whose MinHash threshold is not the reference's, bit for bit;
``mismatched_weights``
    sampled edges whose float64 weight is not the reference's exact NW
    percent identity, bit for bit;
``modularity_off``
    calls where the reference's modularity of the returned labels on its
    graph differs from the program's by more than 1e-9, room for the
    order of a float64 sum over ~4e5 edges and no more;
``no_gain``
    calls whose labels score no higher than every node alone;
``calls_unlike_first``
    calls whose digest is not the first call's (the path is seeded).
"""

from __future__ import annotations

import dataclasses
import hashlib

import numpy as np

from ..reference import cluster as ref
from ..reference import nw as ref_nw

UNIT = "pairs"
# the reference in float32, the precision below the float64 stated
CONTROLS = ("float32",)
# how far two float64 sums of the same modularity may lie apart
MODULARITY_TOL = 1e-9


@dataclasses.dataclass
class Reading:
    keys: np.ndarray  # int64 i * N + j of the kept edges
    labels: np.ndarray
    threshold: float
    modularity: float
    digest: str
    sample: np.ndarray  # int64 keys of the sampled edges
    weight: np.ndarray  # float64 weights of the sampled edges


def _bits(x: float) -> int:
    return int(np.float64(x).view(np.int64))


def _digest(labels, g: dict) -> str:
    h = hashlib.sha256()
    for a in (g["pair_i"], g["pair_j"], g["weight"],
              np.float64(g["threshold"]), np.float64(g["modularity"]),
              labels):
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def well_formed(out, n: int) -> bool:
    if not (isinstance(out, tuple) and len(out) == 2):
        return False
    labels, g = out
    if not (isinstance(labels, np.ndarray) and labels.shape == (n,)
            and labels.dtype.kind in "iu" and isinstance(g, dict)):
        return False
    pi, pj, w = (g.get(k) for k in ("pair_i", "pair_j", "weight"))
    if not all(isinstance(a, np.ndarray) for a in (pi, pj, w)):
        return False
    m = len(pi)
    if not (pi.dtype == pj.dtype == np.int32 and w.dtype == np.float64
            and pi.shape == pj.shape == w.shape == (m,)):
        return False
    if not all(isinstance(g.get(k), float)
               for k in ("threshold", "modularity")):
        return False
    if m == 0:
        return True
    keys = pi.astype(np.int64) * n + pj
    return bool((pi >= 0).all() and (pi < pj).all() and (pj < n).all()
                and (np.diff(keys) > 0).all())


class Entry:
    def __init__(self, seqs, settings, traffic, seed, device):
        self.seqs = seqs
        self.settings = settings
        self.device = device
        self.seed = seed
        self.check = traffic["check"]
        self._lists = None  # the reference's top-k lists
        self._graphs = {}  # dtype name: (ref.Graph, its NW weights)
        # edges aligned so far, sorted, and their (matches, lengths)
        self._counts = (np.zeros(0, np.int64),) * 3

    def call(self, seqs):
        from dynaalign_torch import cluster_large_exact

        s = self.settings
        graph = {}
        labels = cluster_large_exact(
            seqs, k=s["k"], n_hash=s["n_hash"], seed=s["seed"],
            top_k=s["top_k"], thresh_p=s["thresh_p"],
            matrix_name=s["matrix_name"], gap_open=s["gap_open"],
            gap_ext=s["gap_ext"], resolution=s["resolution"],
            louvain_seed=s["louvain_seed"], device=self.device, graph=graph)
        return labels, graph

    def work(self) -> int:
        n = len(self.seqs)
        return n * (n - 1) // 2

    def bounds(self) -> dict[str, float]:
        return {}

    def read(self, out, call: int):
        n = len(self.seqs)
        if not well_formed(out, n):
            return None
        labels, g = out
        keys = g["pair_i"].astype(np.int64) * n + g["pair_j"]
        per_call = self.check["per_call"]
        rows = (np.arange(len(keys)) if per_call >= len(keys) else
                np.random.default_rng([self.seed, 2, call]).choice(
                    len(keys), size=per_call, replace=False))
        return Reading(keys, labels, g["threshold"], g["modularity"],
                       _digest(labels, g), keys[rows], g["weight"][rows])

    # the reference, computed once a run

    def _graph(self, dtype) -> tuple[ref.Graph, np.ndarray]:
        """The reference's kept edges in ``dtype`` and their exact NW
        weights in ``dtype``."""
        name = np.dtype(dtype).name
        if name not in self._graphs:
            s = self.settings
            if self._lists is None:
                self._lists = ref.lists(self.seqs, s, self.device)
            g = ref.prefilter(len(self.seqs), *self._lists, s["n_hash"],
                              s["thresh_p"], dtype)
            self._graphs[name] = g, self._weights(g.keys, dtype)
        return self._graphs[name]

    def _weights(self, keys: np.ndarray, dtype=np.float64) -> np.ndarray:
        """The exact NW percent identity of edges ``keys`` in ``dtype``,
        each edge aligned once a run."""
        known, mt, ln = self._counts
        new = np.setdiff1d(keys, known)
        if new.size:
            got = ref.edge_weights(self.seqs, new, self.settings,
                                   self.device)
            known, mt, ln = (np.concatenate(x) for x in zip(
                (known, mt, ln), (new, *got)))
            order = np.argsort(known)
            known, mt, ln = known[order], mt[order], ln[order]
            self._counts = known, mt, ln
        at = np.searchsorted(known, keys)
        return ref_nw.ratio(mt[at], ln[at], dtype)

    def _as_control(self, r: Reading, dtype) -> Reading:
        """``r`` with the program's numbers replaced by the reference's
        own in ``dtype``."""
        g, w = self._graph(dtype)
        q = ref.modularity(len(self.seqs), g.keys, w, r.labels,
                           self.settings["resolution"], dtype)
        return dataclasses.replace(r, keys=g.keys, threshold=g.threshold,
                                   modularity=q,
                                   weight=self._weights(r.sample, dtype))

    def judge(self, readings, control=None):
        """{name: (value, limit)} and what was compared; the control
        "float32" puts the reference in float32 in the program's place."""
        g, w = self._graph(np.float64)
        if control == "float32":
            readings = [self._as_control(r, np.float32) for r in readings]
        n, gamma = len(self.seqs), self.settings["resolution"]
        alone = ref.modularity(n, g.keys, w, np.arange(n), gamma)
        bad_edges = bad_t = bad_w = off = no_gain = unlike = seen = 0
        for r in readings:
            bad_edges += len(np.setxor1d(r.keys, g.keys))
            bad_t += _bits(r.threshold) != _bits(g.threshold)
            want = self._weights(r.sample)
            same = ((r.weight.view(np.int64) == want.view(np.int64))
                    | (np.isnan(r.weight) & np.isnan(want)))
            bad_w += int((~same).sum())
            seen += len(want)
            q = ref.modularity(n, g.keys, w, r.labels, gamma)
            off += not abs(q - r.modularity) <= MODULARITY_TOL
            no_gain += not q > alone
            unlike += r.digest != readings[0].digest
        checks = {"edges_unequal": (bad_edges, 0),
                  "threshold_unequal": (bad_t, 0),
                  "mismatched_weights": (bad_w, 0),
                  "modularity_off": (off, 0), "no_gain": (no_gain, 0),
                  "calls_unlike_first": (unlike, 0)}
        compared = {"calls": len(readings), "edges": int(len(g.keys)),
                    "threshold": g.threshold, "weights_compared": seen,
                    "modularity_alone": alone}
        return checks, compared
