"""The cluster cell (``cluster_exact_top32.peptides_100k``) at a small copy
of its traffic on the CPU: the program is ``correct``, faults underneath
make it false, each through the check that names it, and so does the
float32 control; the plain reference's top-k and modularity hold to their
definitions; the data file is the seeded draw it was made from; the four
stage shares read the program's spans.  On the card
(``python -m pytest -m gpu portbench/tests``): the cell at a small copy,
traced, ``correct`` and with every stage share read."""

import importlib
import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from portbench import control, generate, run, trace
from portbench.reference import cluster as ref

profiling = pytest.importorskip("dynaalign_torch.utils.profiling")
Span = profiling.Span

CELL = "cluster_exact_top32.peptides_100k"
SMALL = {"limit": 400, "warm": {"first": 64}}
SEED = 2**31 + 77


def _measure(seconds=0.0):
    bench = run.load_json(run.ROOT, "BENCHMARK.json")
    w, config, traffic = run.find_cell(bench, CELL)
    return run.measure(w, config, {**traffic, **SMALL}, SEED, seconds,
                       False, "cpu")


def test_sound_program_is_correct():
    result, r, judged = _measure(seconds=0.5)
    assert result["correct"] and result["failed"] == 0
    assert result["attempted"] == len(r.calls) >= 2
    assert all(v == 0 for v, _ in judged["checks"].values())
    assert judged["compared"]["edges"] > 0
    assert r.work == 400 * 399 // 2 and r.unit == "pairs"


def test_control_is_not_correct():
    """The reference in float32 in the program's place fails the cell's
    comparison, as at the cell's size (``portbench.control``): its
    threshold, weights and modularity all differ."""
    bench = run.load_json(run.ROOT, "BENCHMARK.json")
    _, config, traffic = run.find_cell(bench, CELL)
    mod, entry, got, _ = control.readings(config, {**traffic, **SMALL},
                                          SEED, 2, "cpu")
    prog, _ = entry.judge(got)
    assert all(v <= lim for v, lim in prog.values())
    assert mod.CONTROLS == ("float32",)
    ctrl, _ = entry.judge(got, "float32")
    over = {k for k, (v, lim) in ctrl.items() if v > lim}
    assert {"mismatched_weights", "modularity_off"} <= over, ctrl


def _pipeline():
    return importlib.import_module("dynaalign_torch.models.pipeline")


def _one_weight_altered(mp):
    mod = _pipeline()
    real = mod._ratio

    def altered(*a):
        vals = real(*a).copy()
        vals[len(vals) // 2] += 0.125
        return vals

    mp.setattr(mod, "_ratio", altered)


def _half_the_pairs_zeroed(mp):
    mod = _pipeline()
    real = mod._pairs_nw

    def zeroed(*a, **k):
        mt, ln = (x.copy() for x in real(*a, **k))
        mt[len(mt) // 2:] = 0
        return mt, ln

    mp.setattr(mod, "_pairs_nw", zeroed)


def _singletons(mp):
    from dynaalign_torch.cluster.louvain import LouvainResult, modularity

    def alone(adj, *, resolution=1.0, seed=0, **_):
        n = adj.shape[0]
        return LouvainResult(np.arange(n), modularity(
            adj, np.arange(n), resolution), 1)

    mp.setattr(_pipeline(), "louvain", alone)


FAULTS = {
    "one weight altered in _ratio": (_one_weight_altered,
                                     "mismatched_weights"),
    "half the rescored pairs zeroed": (_half_the_pairs_zeroed,
                                       "mismatched_weights"),
    "Louvain replaced by singletons": (_singletons, "no_gain"),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_makes_correct_false(monkeypatch, fault):
    make, check = FAULTS[fault]
    make(monkeypatch)
    result, _, judged = _measure()
    assert not result["correct"] and result["failed"] == 0
    value, limit = judged["checks"][check]
    assert value > limit, judged["checks"]


def test_reference_imports_nothing_of_the_port_or_jax():
    script = ("import json, sys; sys.path.insert(0, %r); "
              "import portbench.reference.cluster; print(json.dumps(sorted("
              "{m.split('.')[0] for m in sys.modules})))" % run.ROOT)
    out = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=300, cwd=run.ROOT)
    assert out.returncode == 0, out.stderr
    top = set(json.loads(out.stdout.splitlines()[-1]))
    assert "portbench" in top and not top & {
        "jax", "jaxlib", "flax", "dynaalign_tpu", "dynaalign_torch"}


def test_data_file_is_the_seeded_draw():
    """data/peptides_100k.npz: allunique's 65,339 12-mers, then 34,661
    point mutants drawn as bench_topk_large draws them."""
    import chip_smoke

    got = generate.dataset("peptides_100k", "sequence")
    allunique = generate.dataset("allunique", "peptides")
    assert len(allunique) == 65339 and got[:65339] == allunique
    assert got == chip_smoke.with_mutants(allunique, 100000, 0)


def _brute_topk(counts: np.ndarray, k: int):
    """Each row's k columns by count, lowest column first among equals,
    by a stable sort of the row."""
    rows, cols = [], []
    for r, row in enumerate(counts):
        order = [c for c in np.argsort(-row, kind="stable") if c != r][:k]
        rows += [r] * k
        cols += sorted(order)
    return np.array(rows), np.array(cols)


@pytest.mark.parametrize("n,n_hash,top_k", [(40, 4, 5), (30, 2, 29),
                                            (25, 3, 60), (2, 5, 1)])
def test_reference_topk_takes_ties_lowest_column_first(n, n_hash, top_k):
    g = torch.Generator().manual_seed(n * 100 + n_hash)
    sigs = torch.randint(0, 3, (n, n_hash), generator=g)
    rows, cols, counts = ref.topk_counts(sigs, top_k)
    full = (sigs[:, None, :] == sigs[None, :, :]).sum(-1).numpy()
    want_r, want_c = _brute_topk(full, min(top_k, n - 1))
    np.testing.assert_array_equal(rows, want_r)
    np.testing.assert_array_equal(cols, want_c)
    np.testing.assert_array_equal(counts, full[rows, cols])


def test_reference_modularity_equals_the_port_s_igraph_convention():
    from scipy import sparse

    from dynaalign_torch.cluster.louvain import modularity

    rng = np.random.default_rng(5)
    n = 60
    i, j = np.triu_indices(n, k=1)
    pick = rng.random(len(i)) < 0.1
    keys, w = i[pick] * n + j[pick], rng.random(pick.sum())
    labels = rng.integers(0, 7, n)
    adj = sparse.coo_matrix(
        (np.concatenate([w, w, np.ones(n)]),
         (np.concatenate([i[pick], j[pick], np.arange(n)]),
          np.concatenate([j[pick], i[pick], np.arange(n)]))),
        shape=(n, n)).tocsr()
    for gamma in (1.0, 1.05):
        assert ref.modularity(n, keys, w, labels, gamma) == pytest.approx(
            modularity(adj, labels, gamma), abs=1e-12)
    # in float32 the same sum lands elsewhere
    assert ref.modularity(n, keys, w, labels, 1.05, np.float32) != (
        ref.modularity(n, keys, w, labels, 1.05))


def test_quantile_is_r_type_7():
    rows = np.array([0, 0, 1, 2, 3])
    cols = np.array([1, 2, 2, 3, 0])
    counts = np.array([10, 20, 30, 40, 0])
    g = ref.prefilter(4, rows, cols, counts, 50, 0.8)
    # weights 0.2 0.4 0.6 0.8; h = 3 * 0.8 = 2.4: 0.6 + 0.4 * 0.2
    assert g.threshold == np.quantile([0.2, 0.4, 0.6, 0.8], 0.8)
    np.testing.assert_array_equal(g.keys, [2 * 4 + 3])


# one cluster_large_exact call of 20 ms: the top-k 8 ms (its two blocks
# 5 ms), the host edges 1 ms, the rescore 4 ms (its launch 2 ms, in which
# the kernel wrapper 1 ms, and the ratio 0.5 ms), Louvain 5 ms
MS = 1_000_000  # ns
SPANS = [
    Span(12, 11, 10, "topk.block", 0, 2 * MS, {}),
    Span(13, 11, 10, "topk.block", 2 * MS, 5 * MS, {}),
    Span(11, 10, 10, "hybrid.topk", 0, 8 * MS, {}),
    Span(14, 10, 10, "hybrid.edges", 8 * MS, 9 * MS, {}),
    Span(17, 16, 10, "nw_gotoh", 10 * MS, 11 * MS, {"instance0": 1}),
    Span(16, 15, 10, "nw.launch", 9 * MS, 11 * MS, {}),
    Span(18, 15, 10, "nw.ratio", 12 * MS, 12 * MS + MS // 2, {}),
    Span(15, 10, 10, "hybrid.rescore", 9 * MS, 13 * MS, {"pairs": 7}),
    Span(19, 10, 10, "louvain", 14 * MS, 19 * MS, {}),
    Span(10, None, 10, "cluster_large_exact", 0, 20 * MS, {}),
]
# another cell's spans: an NW call
OTHER = [Span(2, 1, 1, "nw.launch", 0, 2 * MS, {}),
         Span(3, 1, 1, "nw.ratio", 2 * MS, 3 * MS, {}),
         Span(1, None, 1, "similarity_nw", 0, 4 * MS, {})]
SHARES = ["topk_share.cluster", "edges_share.cluster",
          "rescore_share.cluster", "louvain_share.cluster"]


def _run(tr):
    return run.Run(unit="pairs", work=5, bounds={}, calls=[(0.0, 0.1)],
                   window_s=0.1, setup_s=1.0, trace=tr)


def _trace(window_s=0.1):
    return trace.Trace((1.0, 1.0 + window_s), np.zeros((0, 2)),
                       np.zeros((0, 2)), {"k": 1.0}, {})


def test_stage_shares_are_self_time_over_the_window(monkeypatch):
    monkeypatch.setattr(profiling, "_spans", list(SPANS))
    r = _run(_trace())
    got = [run.reader(name)(r) for name in SHARES]
    assert got == pytest.approx([8.0, 1.0, 4.0, 5.0])


@pytest.mark.parametrize("name", SHARES)
def test_stage_shares_find_nothing_to_read(monkeypatch, name):
    bench = run.load_json(run.ROOT, "BENCHMARK.json")
    (m,) = [m for m in bench["per_layer"] if m["name"] == name]
    assert m["workloads"] == [CELL] and m["layer"] == "cluster"
    assert m["moves"] == "mh_pairs_per_s" and m["source"] == "program_span"
    read = run.reader(name)
    # another cell's spans, an untraced run, a program without the
    # recorder (the parent of the change that added it)
    monkeypatch.setattr(profiling, "_spans", list(OTHER))
    assert read(_run(_trace())) is None
    monkeypatch.setattr(profiling, "_spans", list(SPANS))
    assert read(_run(None)) is None
    monkeypatch.delattr(profiling, "spans")
    assert read(_run(_trace())) is None


def test_the_cell_reports_mh_pairs_per_s_and_its_shares():
    bench = run.load_json(run.ROOT, "BENCHMARK.json")
    (w,) = [w for w in bench["workloads"] if w["name"] == CELL]
    assert w["chips"] == 1
    assert {m["name"] for m in run.reported(bench, CELL, False)} == {
        "mh_pairs_per_s", "setup_s"}
    assert {m["name"] for m in run.reported(bench, CELL, True)} == set(
        SHARES)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", 0)


@pytest.mark.gpu
def test_cell_is_correct_on_the_card_and_reads_its_stages(card):
    bench = run.load_json(run.ROOT, "BENCHMARK.json")
    w, config, traffic = run.find_cell(bench, CELL)
    profiling.reset()
    result, r, judged = run.measure(w, config, {**traffic, "limit": 4000},
                                    2**31 + 99, 1.0, True, card)
    assert result["correct"], judged
    assert result["device"]["busy_s"] > 0 and r.trace.kernel_s > 0
    calls = [s for s in profiling.spans() if s.name == config["entry"]]
    assert len(calls) == len(r.calls) and all(s.parent is None
                                              for s in calls)
    got = run.metrics(bench, CELL, r, True)
    assert all(got[name]["value"] > 0 for name in SHARES), got
