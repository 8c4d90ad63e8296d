"""The port's span recorder (``utils/profiling.py``) on the CPU: nesting,
self time, counts and gauges, nothing recorded and no ``record_function``
entered with the profiler off, every span inside its own event of the
exported Chrome trace, and the span trees of ``similarity_nw`` and
``similarity_mh``.  ``test_torch_cuda.py`` runs the trace check on the
card."""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from dynaalign_torch import cluster_large, similarity_mh  # noqa: E402
from dynaalign_torch import similarity_nw  # noqa: E402
from dynaalign_torch.encode import encode  # noqa: E402
from dynaalign_torch.io.datasets import load_sequences  # noqa: E402
from dynaalign_torch.ops import minhash, topk_graph  # noqa: E402
from dynaalign_torch.utils import profiling  # noqa: E402

AAS = list("ARNDCQEGHILKMFPSTWYV")
MS = 1_000_000  # ns


def _seqs(seed, n, lo=4, hi=30):
    rng = np.random.default_rng(seed)
    return ["".join(rng.choice(AAS, size=int(k)))
            for k in rng.integers(lo, hi, size=n)]


@pytest.fixture
def profiled():
    """A CPU profile around the test, the recorder reset before it."""
    profiling.reset()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        yield prof
    profiling.reset()


def spans_within_events(path: str, slack_ns: int = MS) -> int:
    """Check that each recorded span lies inside its own ``user_annotation``
    event of the Chrome trace at ``path`` (the n-th span of a name in the
    n-th event of that name, by start), on the trace's clock ``ts`` * 1000
    + ``baseTimeNanoseconds``, within ``slack_ns``; returns the spans
    checked."""
    with open(path) as f:
        doc = json.load(f)
    base = int(doc["baseTimeNanoseconds"])
    events: dict[str, list] = {}
    for e in doc["traceEvents"]:
        if e.get("ph") == "X" and e.get("cat") == "user_annotation":
            lo = base + round(e["ts"] * 1000)
            events.setdefault(e["name"], []).append(
                (lo, lo + round(e["dur"] * 1000)))
    by_name: dict[str, list] = {}
    for s in profiling.spans():
        by_name.setdefault(s.name, []).append(s)
    for name, got in by_name.items():
        got.sort(key=lambda s: s.start_ns)
        ev = sorted(events.get(name, []))
        assert len(ev) == len(got), name
        for s, (lo, hi) in zip(got, ev):
            assert lo - slack_ns <= s.start_ns <= s.end_ns <= hi + slack_ns, (
                s, lo, hi)
    return sum(len(v) for v in by_name.values())


def _tree(spans):
    """(depth, name, entries) of each span, in the order they started."""
    depth = {}
    out = []
    for s in sorted(spans, key=lambda s: s.start_ns):
        depth[s.id] = 0 if s.parent is None else depth[s.parent] + 1
        out.append((depth[s.id], s.name, s.entries))
    return out


def test_nesting_gives_parent_and_call(profiled):
    with profiling.span("a") as top:
        with profiling.span("b"):
            with profiling.span("c"):
                pass
        with profiling.span("b"):
            pass
        top["late"] = 3
    with profiling.span("a"):
        pass
    got = profiling.spans()
    assert [s.name for s in got] == ["c", "b", "b", "a", "a"]
    c, b1, b2, a1, a2 = got
    assert (a1.parent, b1.parent, b2.parent, c.parent) == (
        None, a1.id, a1.id, b1.id)
    assert {s.call for s in (a1, b1, b2, c)} == {a1.id}
    assert a2.parent is None and a2.call == a2.id != a1.id
    assert a1.entries == {"late": 3}
    assert all(s.start_ns <= s.end_ns for s in got)
    assert a1.start_ns <= b1.start_ns <= c.start_ns <= c.end_ns <= b1.end_ns
    assert b1.end_ns <= b2.start_ns <= b2.end_ns <= a1.end_ns


def test_self_seconds_takes_out_child_spans(monkeypatch):
    S = profiling.Span
    monkeypatch.setattr(profiling, "_spans", [
        S(2, 1, 1, "child", 2 * MS, 5 * MS, {}),
        S(3, 1, 1, "other", 6 * MS, 7 * MS, {}),
        S(1, None, 1, "parent", 0, 10 * MS, {}),
        S(4, None, 4, "parent", 20 * MS, 21 * MS, {}),
    ])
    assert profiling.self_seconds(["parent"]) == pytest.approx(0.007)
    assert profiling.self_seconds(["child"]) == pytest.approx(0.003)
    # a span and its child together: their union
    assert profiling.self_seconds(["parent", "child"]) == pytest.approx(0.010)
    assert profiling.self_seconds(["none"]) == 0.0


def test_counts_are_summed_and_gauges_kept():
    profiling.reset()
    for k in range(3):
        with profiling.span("x", pairs=10, bytes=np.int64(4)) as sp:
            sp["threshold"] = 0.25 * k
            sp["label"] = "not a number"
    with profiling.span("y", items=np.int32(7), mean=np.float64(1.5)):
        pass
    with pytest.raises(ValueError):
        with profiling.span("x", pairs=1000):
            raise ValueError("a failed region counts nothing")
    assert profiling.counters() == {"x": 3, "x.pairs": 30, "x.bytes": 12,
                                    "y": 1, "y.items": 7}
    assert profiling.gauges() == {"x.threshold": 0.5, "y.mean": 1.5}
    assert all(type(v) is int for v in profiling.counters().values())
    profiling.reset()
    assert profiling.counters() == profiling.gauges() == {}


def test_profiler_off_records_no_span_and_enters_no_range(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    profiling.reset()
    assert not torch.autograd._profiler_enabled()
    with profiling.span("outer", pairs=2):
        with profiling.span("inner"):
            pass
    similarity_mh(_seqs(1, 6), 2, 8, device="cpu")
    assert profiling.spans() == []
    got = profiling.counters()
    assert got["outer"] == 1 and got["outer.pairs"] == 2
    assert got["similarity_mh"] == 1 and got["mh.fetch"] == 1


def test_spans_lie_inside_their_trace_events(tmp_path):
    with profiling.span("before the trace"):
        pass
    with profiling.trace(str(tmp_path)):
        with profiling.span("outer"):
            for _ in range(3):
                with profiling.span("inner", items=1):
                    torch.ones(32, 32) @ torch.ones(32, 32)
        similarity_nw(_seqs(2, 5), device="cpu")
    names = {s.name for s in profiling.spans()}
    assert "before the trace" not in names  # trace() resets the recorder
    assert {"outer", "inner", "similarity_nw", "nw.fill"} <= names
    assert spans_within_events(str(tmp_path / "trace.json")) == len(
        profiling.spans())


def test_similarity_nw_span_tree(profiled):
    seqs = _seqs(3, 12)
    n = len(seqs)
    similarity_nw(seqs, device="cpu", chunk=32)  # 78 pairs: 3 launches
    pairs = n * (n + 1) // 2
    launch, check = (1, "nw.launch", {}), (2, "nw_gotoh.check", {})
    assert _tree(profiling.spans()) == [
        (0, "similarity_nw", {}),
        (1, "nw.encode", {}),
        launch, check, launch, check, launch, check,
        (1, "nw.fetch", {"bytes": 2 * 4 * pairs}),  # int32 matches, length
        (1, "nw.ratio", {}),
        (1, "nw.fill", {}),
    ]
    assert len({s.call for s in profiling.spans()}) == 1


def test_similarity_mh_span_tree(profiled):
    seqs = _seqs(4, 12)
    n = len(seqs)
    similarity_mh(seqs, 3, 16, device="cpu", chunk=5, block=5)
    assert _tree(profiling.spans()) == [
        (0, "similarity_mh", {}),
        (1, "mh.encode", {}),
        (1, "mh.signatures", {}),
        (1, "mh.compare", {}),
        (1, "mh.fetch", {"bytes": n * n}),  # uint8 counts at n_hash 16
        (1, "mh.similarity", {"workers": 0}),
    ]
    assert len({s.call for s in profiling.spans()}) == 1


@pytest.fixture
def threads(request):
    """torch's intra-op threads set to the test's parameter, restored
    after it."""
    was = torch.get_num_threads()
    torch.set_num_threads(request.param)
    yield request.param
    torch.set_num_threads(was)


@pytest.mark.parametrize("threads, rows, workers", [
    (4, 64, 0),     # under the pool's cut: the calling thread
    (4, 1100, 4),   # over it: a row block a thread
    (1, 1100, 0),   # one intra-op thread: no pool
], indirect=["threads"])
def test_similarity_span_counts_its_pooled_blocks(profiled, threads, rows,
                                                  workers):
    """``mh.similarity``'s ``workers``: the row blocks the divide ran on
    its thread pool, 0 when it ran on the calling thread."""
    minhash.counts_to_similarity(np.zeros((rows, rows), np.uint8), 50)
    (s,) = profiling.spans()
    assert (s.name, s.entries) == ("mh.similarity", {"workers": workers})


def test_cluster_large_gauges_its_threshold_and_kept_edges():
    """The float64 quantile threshold and the kept edges' weights, as the
    top-k lists give them, are gauges of the call."""
    pep = load_sequences("allunique", 400)
    profiling.reset()
    cluster_large(pep, top_k=8, device="cpu")
    g, c = profiling.gauges(), profiling.counters()
    enc = encode(pep, validate=False)
    vals, idx = topk_graph.minhash_topk(minhash.minhash_signatures(
        enc.ascii, enc.lengths, device="cpu"), k=8)
    t = float(np.quantile(vals[vals > 0], 0.8))
    adj = topk_graph.knn_graph(vals, idx, threshold=t)
    assert g["cluster_large.threshold"] == t
    assert c["cluster_large.kept_edges"] == adj.nnz // 2 > 0
    assert g["cluster_large.kept_weight_sum"] == pytest.approx(
        adj.toarray().sum() / 2, rel=1e-12)
    assert c["topk.block"] >= 1 and c["knn_graph"] == c["louvain"] == 1


def test_nw_launches_reads_the_kernel_spans():
    """``nw_cuda.launches`` reads the launch spans' counts back: launches
    of each kernel and the instances ``nw_gotoh`` ran."""
    from dynaalign_torch.ops import nw_cuda

    profiling.reset()
    assert nw_cuda.launches() == (0, 0, [])
    for k in (2, 0, 2):
        with profiling.span("nw_gotoh", **{f"instance{k}": 1}):
            pass
    with profiling.span("nw_gotoh_xl", items=5):
        pass
    assert nw_cuda.launches() == (3, 1, [0, 2])
    profiling.reset()
