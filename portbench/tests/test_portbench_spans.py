"""The readers of the program's own spans (``portbench/spans.py`` and the
metrics that use it) on recorder contents and traces whose numbers are
known, on a program without the recorder, and on the card at a small copy
of each cell (``python -m pytest -m gpu portbench/tests``)."""

import numpy as np
import pytest

from portbench import run, spans, trace

profiling = pytest.importorskip("dynaalign_torch.utils.profiling")
Span = profiling.Span

MS = 1_000_000  # ns

# one NW call of 10 ms: a launch, the fetch (2 ms, 600 bytes), the ratio
# (1 ms) and the fill (3 ms, of which 1 ms in a child span); a second
# call's fetch of 400 bytes; MinHash's divide (4 ms) and fetch (900 bytes)
FAKE = [
    Span(2, 1, 1, "nw.launch", 0, 2 * MS, {"pairs": 5}),
    Span(3, 1, 1, "nw.fetch", 2 * MS, 4 * MS, {"bytes": 600}),
    Span(4, 1, 1, "nw.ratio", 4 * MS, 5 * MS, {}),
    Span(6, 5, 1, "inner", 6 * MS, 7 * MS, {}),
    Span(5, 1, 1, "nw.fill", 5 * MS, 8 * MS, {"bytes": 800}),
    Span(1, None, 1, "similarity_nw", 0, 10 * MS, {"pairs": 5}),
    Span(7, None, 7, "nw.fetch", 20 * MS, 21 * MS, {"bytes": 400}),
    Span(8, None, 8, "mh.fetch", 30 * MS, 31 * MS, {"bytes": 900}),
    Span(9, None, 8, "mh.similarity", 31 * MS, 35 * MS, {"bytes": 1600}),
]


def _trace(window_s=0.1, ops=None):
    ops = {"Memcpy DtoH (Device -> Pageable)": 2e-7,
           "Memcpy HtoD (Pageable -> Device)": 5.0,
           "nw_gotoh_kernel": 9.0} if ops is None else ops
    return trace.Trace((1.0, 1.0 + window_s), np.zeros((0, 2)),
                       np.zeros((0, 2)), ops, {})


def _run(tr):
    return run.Run(unit="pairs", work=5, bounds={}, calls=[(0.0, 0.1)],
                   window_s=0.1, setup_s=1.0, trace=tr)


@pytest.fixture
def recorded(monkeypatch):
    monkeypatch.setattr(profiling, "_spans", list(FAKE))


def _read(name, r):
    return run.reader(name)(r)


def test_shares_are_self_time_over_the_window(recorded):
    r = _run(_trace())
    # ratio 1 ms + fill 3 ms less its 1 ms child, over 100 ms
    assert _read("ratio_fill_share.nw", r) == pytest.approx(3.0)
    assert _read("similarity_share.mh", r) == pytest.approx(4.0)


def test_fetch_rates_are_span_bytes_over_the_dtoh_copies(recorded):
    r = _run(_trace())
    # 1,000 bytes over 0.2 us of DtoH: 5 GB/s; the HtoD copy is not read
    assert _read("fetch_gb_per_s.nw", r) == pytest.approx(5.0)
    assert _read("fetch_gb_per_s.mh", r) == pytest.approx(4.5)
    # the harness's sanitised op names read the same
    r = _run(_trace(ops={"Memcpy_DtoH__Device_-__Pageable_": 1e-6,
                         "Memcpy_DtoD": 1.0}))
    assert _read("fetch_gb_per_s.nw", r) == pytest.approx(1.0)


METRICS = ["ratio_fill_share.nw", "fetch_gb_per_s.nw",
           "similarity_share.mh", "fetch_gb_per_s.mh"]


@pytest.mark.parametrize("name", METRICS)
def test_nothing_to_read_gives_none(monkeypatch, name):
    # no span recorded (an untraced window)
    monkeypatch.setattr(profiling, "_spans", [])
    assert _read(name, _run(_trace())) is None
    # spans but no trace, or a trace without a copy to the host
    monkeypatch.setattr(profiling, "_spans", list(FAKE))
    assert _read(name, _run(None)) is None
    if name.startswith("fetch"):
        assert _read(name, _run(_trace(ops={"k": 1.0}))) is None
    # a program without the recorder (the parent of the change adding it)
    monkeypatch.delattr(profiling, "spans")
    assert spans.recorder() is None
    assert _read(name, _run(_trace())) is None


@pytest.mark.parametrize("name", METRICS)
def test_each_reads_one_cell_that_reports_what_it_moves(name):
    bench = run.load_json(run.ROOT, "BENCHMARK.json")
    (m,) = [m for m in bench["per_layer"] if m["name"] == name]
    cell = {"nw": "nw_blosum62.h3n2_all",
            "mh": "mh_k4_n50.h3n2ha_all"}[name.rsplit(".", 1)[1]]
    assert m["workloads"] == [cell]
    assert m["moves"] == name.rsplit(".", 1)[1] + "_pairs_per_s"


SMALL = {
    "nw_blosum62.h3n2_all": ({"limit": 300},
                             ["ratio_fill_share.nw", "fetch_gb_per_s.nw"]),
    "mh_k4_n50.h3n2ha_all": ({"limit": 2000},
                             ["similarity_share.mh", "fetch_gb_per_s.mh"]),
}


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("cell", sorted(SMALL))
def test_traced_window_on_the_card_reads_its_spans(card, cell):
    """A traced run records the window's spans and no others (not the warm
    call's), and both of the cell's readers find them."""
    bench = run.load_json(run.ROOT, "BENCHMARK.json")
    small, names = SMALL[cell]
    w, config, traffic = run.find_cell(bench, cell)
    profiling.reset()
    result, r, judged = run.measure(w, config, {**traffic, **small},
                                    2**31 + 7, 1.0, True, card)
    assert result["correct"], judged
    entry = config["entry"]
    calls = [s for s in profiling.spans() if s.name == entry]
    assert len(calls) == len(r.calls) and all(s.parent is None
                                              for s in calls)
    got = run.metrics(bench, cell, r, True)
    for name in names:
        assert got[name]["value"] > 0, got
