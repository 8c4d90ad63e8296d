"""The BASELINE configurations that chip_smoke.py's phase 18 runs at full
size, here at a small size on the CPU: the same inputs through the JAX
package and the port (``device="cpu"``), tolerance 0, with phase 18's own
helpers (the J→L mapping and the seeded point mutants)."""

import importlib.util
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402,F401

import dynaalign_tpu as dj  # noqa: E402
from dynaalign_tpu import models as jmodels  # noqa: E402
from dynaalign_tpu.encode import InvalidSequenceError as JInvalid  # noqa: E402
from dynaalign_tpu.ops import topk_graph as jtopk  # noqa: E402

import dynaalign_torch as dt  # noqa: E402
from dynaalign_torch import oracle  # noqa: E402
from dynaalign_torch.encode import InvalidSequenceError  # noqa: E402
from dynaalign_torch.io.datasets import load_sequences  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)

CONFIG5 = dict(k=4, n_hash=50, seed=0, top_k=32, thresh_p=0.8)


def test_mutants_equal_the_jax_benchmarks_list(monkeypatch):
    """with_mutants gives the list benchmarks/run_benchmarks.py's
    bench_topk_large hands cluster_large, draw for draw."""
    monkeypatch.syspath_prepend(ROOT)
    from benchmarks import run_benchmarks

    seen = []

    def capture(seqs, **kw):
        seen.append((list(seqs), kw))
        return np.ones(len(seqs), dtype=np.int64)

    monkeypatch.setattr(jtopk, "cluster_large", capture)
    allunique = load_sequences("allunique")
    large_n = len(allunique) + 64
    assert run_benchmarks.main(
        ["--bench", "topk_large", "--large-n", str(large_n)]) == 0
    (seqs, kw), = seen
    assert {k: kw[k] for k in CONFIG5} == CONFIG5
    got = smoke.with_mutants(allunique, large_n)
    assert len(got) == large_n and got == seqs


@pytest.fixture(scope="module")
def config5_input():
    return smoke.with_mutants(load_sequences("allunique", 1500), 1800)


@pytest.mark.parametrize("name", ["cluster_large", "cluster_large_exact"])
def test_config5_membership_equals_jax(config5_input, name):
    jax_fn = {"cluster_large": jtopk.cluster_large,
              "cluster_large_exact": jmodels.cluster_large_exact}[name]
    got = getattr(dt, name)(config5_input, device="cpu", **CONFIG5)
    want = np.asarray(jax_fn(config5_input, **CONFIG5))
    assert got.shape == (1800,) and got.min() == 1
    np.testing.assert_array_equal(got, want)
    assert smoke._digest(got.astype(np.int64)) == smoke._digest(
        want.astype(np.int64))


def test_panel_hybrid_rescored_entries_exact():
    """run_benchmarks.py's rescored_entries_exact on adenovirus[:120]:
    every pair the MH prefilter keeps equals the oracle, every other
    off-diagonal entry is 0, and the matrix equals the JAX package's."""
    seqs = load_sequences("adenovirus", 120)
    got = dt.similarity_hybrid(seqs, k=4, n_hash=50, seed=0, device="cpu")
    np.testing.assert_array_equal(
        got, dj.similarity_hybrid(seqs, k=4, n_hash=50, seed=0))
    _, kept, _ = smoke.rescored_entries_exact(
        got, dt.similarity_mh(seqs, 4, 50, device="cpu"),
        oracle.nw_similarity(seqs))
    assert kept > 0


def test_j_rows_after_mapping_equal_jax_and_oracle():
    full = load_sequences("h3n2sample")
    mapped, rows = smoke.j_to_l(full)
    assert len(rows) == 2 and all("J" not in s for s in mapped)
    pick = rows + [0, 1, 4000, 8102]
    raw = [full[i] for i in pick]
    for fn, err in ((dt.similarity_nw, InvalidSequenceError),
                    (dj.similarity_nw, JInvalid)):
        with pytest.raises(err):
            fn(raw, **({"device": "cpu"} if fn is dt.similarity_nw else {}))
    seqs = [mapped[i] for i in pick]
    got = dt.similarity_nw(seqs, device="cpu")
    np.testing.assert_array_equal(got, dj.similarity_nw(seqs))
    np.testing.assert_array_equal(got, oracle.nw_similarity(seqs))


def test_full_set_minhash_prefix_equals_jax_and_oracle():
    seqs = load_sequences("h3n2ha1415", 200)
    got = dt.similarity_mh(seqs, 4, 50, device="cpu")
    np.testing.assert_array_equal(got, dj.similarity_mh(seqs, 4, 50))
    np.testing.assert_array_equal(
        got, oracle.minhash_similarity(seqs, 4, 50, 0))


def test_chip_smoke_imports_no_jax():
    """chip_smoke.py runs where JAX is not installed: no import of jax or
    of dynaalign_tpu anywhere in it, at its top or inside a function."""
    import ast

    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module)
    assert "dynaalign_torch" in {n.split(".")[0] for n in names}
    assert not {n for n in names
                if n.split(".")[0] in ("jax", "jaxlib", "dynaalign_tpu")}
