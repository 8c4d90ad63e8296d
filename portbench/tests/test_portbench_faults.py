"""``correct`` comes out false when the timed path is broken underneath,
and for the control; true for the program as it is.

Each cell runs here on the CPU at a small copy of its traffic (the plain
versions of the port), through the runner's own set-up, window and
judging; only the look for a card is skipped.  The faults a cell can
have: an answer altered where it is produced; half of the work left out;
a call that returns its state unchanged (nothing computed).  There is no
exchange between chips: every cell takes one.
"""

import importlib

import numpy as np
import pytest

from portbench import run

SMALL = {
    "nw_blosum62.h3n2_all": {"limit": 14},
    "mh_k4_n50.h3n2ha_all": {"limit": 60},
}
SEED = 2**31 + 77


def _measure(cell, seconds=0.0):
    bench = run.load_json(run.ROOT, "BENCHMARK.json")
    w, config, traffic = run.find_cell(bench, cell)
    return run.measure(w, config, {**traffic, **SMALL[cell]}, SEED, seconds,
                       False, "cpu")


def _api():
    return importlib.import_module("dynaalign_torch.api")


def _minhash():
    return importlib.import_module("dynaalign_torch.ops.minhash")


def _wrap(mp, mod, name, change):
    real = getattr(mod, name)
    mp.setattr(mod, name, lambda *a, **k: change(real(*a, **k), *a))


def _alter_one(vals, *_):
    vals = vals.copy()
    vals.flat[len(vals.flat) // 2] += 0.125
    return vals


def _half_pairs(out, *_):
    mt, ln = (x.copy() for x in out)
    mt[len(mt) // 2:] = 0
    ln[len(ln) // 2:] = 0
    return mt, ln


def _half_rows(counts, *_):
    counts = counts.clone()
    counts[len(counts) // 2:] = 0
    return counts


FAULTS = {
    ("nw", "answer altered"): lambda mp: _wrap(mp, _api(), "_ratio",
                                               _alter_one),
    ("nw", "half left out"): lambda mp: _wrap(mp, _api(), "_pairs_nw",
                                              _half_pairs),
    ("nw", "state unchanged"): lambda mp: mp.setattr(
        _api(), "_fill", lambda n, vals: np.zeros((n, n))),
    ("mh", "answer altered"): lambda mp: _wrap(
        mp, _minhash(), "counts_to_similarity", _alter_one),
    ("mh", "half left out"): lambda mp: _wrap(
        mp, _minhash(), "signature_agreement_counts", _half_rows),
    ("mh", "state unchanged"): lambda mp: mp.setattr(
        _api(), "signature_similarity",
        lambda sigs, **k: np.zeros((len(sigs), len(sigs)))),
}
CELLS = {"nw": ["nw_blosum62.h3n2_all"], "mh": ["mh_k4_n50.h3n2ha_all"]}
CASES = [(cell, fault) for (kind, fault) in FAULTS
         for cell in CELLS[kind]]


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_sound_program_is_correct(cell):
    result, r, judged = _measure(cell, seconds=0.5)
    assert result["correct"] and result["failed"] == 0
    assert result["attempted"] == len(r.calls) >= 1
    assert all(v == 0 for v, _ in judged["checks"].values())


@pytest.mark.parametrize("cell,fault", CASES)
def test_fault_makes_correct_false(monkeypatch, cell, fault):
    kind = next(k for k, cells in CELLS.items() if cell in cells)
    FAULTS[(kind, fault)](monkeypatch)
    result, _, judged = _measure(cell)
    assert not result["correct"]
    (name, (value, limit)), = [
        kv for kv in judged["checks"].items() if kv[0] != "failed_calls"]
    assert value > limit, (name, value)


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_control_is_not_correct(cell):
    """The control in the program's place, the reference in float32,
    fails the cell's comparison, at this size as at the cell's
    (``portbench.control``)."""
    from portbench import control

    bench = run.load_json(run.ROOT, "BENCHMARK.json")
    _, config, traffic = run.find_cell(bench, cell)
    mod, entry, got, _ = control.readings(
        config, {**traffic, **SMALL[cell]}, SEED, 2, "cpu")
    prog, _ = entry.judge(got)
    assert all(v <= lim for v, lim in prog.values())
    fails = {c: any(v > lim for v, lim in entry.judge(got, c)[0].values())
             for c in mod.CONTROLS}
    assert all(fails.values()), fails
