"""``cluster_large_exact``'s ``graph`` dict and spans, on the CPU, at a
small copy of BASELINE config 5 (allunique[:1500] and 300 seeded point
mutants): the graph held to the benchmark's plain reference
(``portbench/reference/cluster.py``) bit for bit, to what
``similarity_hybrid_sparse`` builds, and the labels to those the call gave
before it handed out its graph."""

import hashlib
import importlib.util
import os
import sys

import numpy as np
import pytest
import torch
from scipy import sparse

import dynaalign_torch as dt
from dynaalign_torch.io.datasets import load_sequences
from dynaalign_torch.utils import profiling

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
from portbench.reference import cluster as ref  # noqa: E402
from portbench.reference import nw as ref_nw  # noqa: E402

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)

SETTINGS = dict(k=4, n_hash=50, seed=0, top_k=32, thresh_p=0.8,
                matrix_name="BLOSUM62", gap_open=10, gap_ext=4,
                resolution=1.05, louvain_seed=0)
HYBRID = ("k", "n_hash", "seed", "top_k", "matrix_name", "gap_open",
          "gap_ext")
# sha256 of the int64 labels cluster_large_exact gave on SEQS with the
# settings above before it took a graph dict
LABELS_SHA256 = (
    "7a5356df961da802d97e15cbc0f6f1b23166a65ec743914edbf98e14e4a42236")


@pytest.fixture(scope="module")
def seqs():
    return smoke.with_mutants(load_sequences("allunique", 1500), 1800)


@pytest.fixture(scope="module")
def clustered(seqs):
    graph = {}
    labels = dt.cluster_large_exact(seqs, device="cpu", graph=graph,
                                    **SETTINGS)
    return labels, graph


def _bits(x):
    return np.asarray(x, dtype=np.float64).view(np.int64)


def test_graph_equals_the_plain_reference(seqs, clustered):
    labels, g = clustered
    n = len(seqs)
    want = ref.prefilter(n, *ref.lists(seqs, SETTINGS, "cpu"),
                         SETTINGS["n_hash"], SETTINGS["thresh_p"])
    keys = g["pair_i"].astype(np.int64) * n + g["pair_j"]
    assert g["pair_i"].dtype == g["pair_j"].dtype == np.int32
    assert (g["pair_i"] < g["pair_j"]).all() and (np.diff(keys) > 0).all()
    np.testing.assert_array_equal(keys, want.keys)
    assert _bits(g["threshold"]) == _bits(want.threshold)
    weight = ref_nw.ratio(*ref.edge_weights(seqs, want.keys, SETTINGS,
                                            "cpu"))
    assert g["weight"].dtype == np.float64
    np.testing.assert_array_equal(_bits(g["weight"]), _bits(weight))
    q = ref.modularity(n, want.keys, weight, labels, SETTINGS["resolution"])
    assert abs(q - g["modularity"]) <= 1e-9
    alone = ref.modularity(n, want.keys, weight, np.arange(n),
                           SETTINGS["resolution"])
    assert q > alone


def test_graph_equals_what_similarity_hybrid_sparse_builds(seqs, clustered):
    _, g = clustered
    adj = dt.similarity_hybrid_sparse(
        seqs, prefilter_quantile=SETTINGS["thresh_p"], device="cpu",
        **{k: SETTINGS[k] for k in HYBRID})
    tri = sparse.triu(adj, k=1).tocoo()
    order = np.lexsort((tri.col, tri.row))
    np.testing.assert_array_equal(tri.row[order], g["pair_i"])
    np.testing.assert_array_equal(tri.col[order], g["pair_j"])
    np.testing.assert_array_equal(_bits(tri.data[order]), _bits(g["weight"]))
    np.testing.assert_array_equal(adj.diagonal(), np.ones(len(seqs)))


def test_labels_without_a_dict_are_unchanged(seqs, clustered):
    labels = dt.cluster_large_exact(seqs, device="cpu", **SETTINGS)
    assert hashlib.sha256(labels.astype(np.int64).tobytes()).hexdigest() \
        == LABELS_SHA256
    np.testing.assert_array_equal(labels, clustered[0])


SPANS = ("cluster_large_exact", "hybrid.topk", "hybrid.edges",
         "hybrid.rescore")


def _gauges_and_counts(g):
    gauges = profiling.gauges()
    counts = profiling.counters()
    assert gauges["cluster_large_exact.threshold"] == g["threshold"]
    assert gauges["cluster_large_exact.modularity"] == g["modularity"]
    assert gauges["cluster_large_exact.rescored_weight_sum"] == float(
        g["weight"].sum())
    assert counts["cluster_large_exact.rescored_edges"] == len(g["pair_i"])
    assert counts["hybrid.rescore.pairs"] == len(g["pair_i"])
    assert all(counts[name] == 1 for name in SPANS)


def test_spans_gauges_and_counts_under_a_profiler(seqs, clustered):
    profiling.reset()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        dt.cluster_large_exact(seqs, device="cpu", **SETTINGS)
    _gauges_and_counts(clustered[1])
    got = {s.name: s for s in profiling.spans()}
    assert set(SPANS) | {"topk.block", "louvain", "nw.launch"} <= set(got)
    top = got["cluster_large_exact"]
    assert top.parent is None and top.entries["modularity"] == (
        clustered[1]["modularity"])
    for name in SPANS[1:] + ("louvain",):
        assert got[name].call == top.id and got[name].parent == top.id
    assert got["topk.block"].parent == got["hybrid.topk"].id
    assert got["nw.launch"].parent == got["hybrid.rescore"].id
    assert got["hybrid.rescore"].entries["pairs"] == len(
        clustered[1]["pair_i"])
    profiling.reset()


def test_gauges_without_a_profiler(seqs, clustered):
    profiling.reset()
    dt.cluster_large_exact(seqs, device="cpu", **SETTINGS)
    assert profiling.spans() == []
    _gauges_and_counts(clustered[1])
    profiling.reset()
