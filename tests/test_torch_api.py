"""The port's public surface on the CPU against the JAX package and the C++
oracle: all-pairs NW, host encoding, BLOSUM tables, datasets, errors, the
device rule, and the package's independence from JAX."""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402,F401

import dynaalign_tpu as dj  # noqa: E402
from dynaalign_tpu import blosum as jblosum  # noqa: E402
from dynaalign_tpu.encode import ALPHABET as JALPHABET  # noqa: E402
from dynaalign_tpu.encode import bucket_by_length as jbucket  # noqa: E402
from dynaalign_tpu.encode import encode as jencode  # noqa: E402
from dynaalign_tpu import oracle as joracle  # noqa: E402
from dynaalign_tpu.io import datasets as jdatasets  # noqa: E402

import dynaalign_torch as dt  # noqa: E402
from dynaalign_torch import blosum  # noqa: E402
from dynaalign_torch.encode import (  # noqa: E402
    ALPHABET,
    PAD_ID,
    InvalidSequenceError,
    bucket_by_length,
    decode,
    encode,
)
from dynaalign_torch.io import datasets  # noqa: E402

PKG_DIR = os.path.dirname(os.path.abspath(dt.__file__))
ENTRY_POINTS = [dt.similarity_nw, dt.similarity_nw_bucketed]


def _mixed():
    rng = np.random.default_rng(21)
    lens = np.concatenate([rng.integers(1, 20, 10), rng.integers(60, 140, 8)])
    seqs = ["".join(rng.choice(list(ALPHABET), size=k)) for k in lens]
    return seqs + ["A", "W*"]


SETS = {
    "evp160": lambda: datasets.load_sequences("evp_peparray", 160),
    "mixed": _mixed,
}


@pytest.mark.parametrize("fn", ENTRY_POINTS, ids=lambda f: f.__name__)
@pytest.mark.parametrize("name", sorted(SETS))
def test_all_pairs_equal_jax_and_oracle(name, fn):
    seqs = SETS[name]()
    got = fn(seqs, device="cpu")
    assert got.shape == (len(seqs), len(seqs)) and got.dtype == np.float64
    np.testing.assert_array_equal(got, dj.similarity_nw(seqs))
    np.testing.assert_array_equal(got, joracle.nw_similarity(seqs))


@pytest.mark.parametrize("gaps", [(5, 1), (12, 2)])
def test_all_pairs_matrix_and_gaps(gaps):
    seqs = _mixed()[:12]
    got = dt.similarity_nw(seqs, "BLOSUM45", *gaps, device="cpu", chunk=9)
    np.testing.assert_array_equal(
        got, joracle.nw_similarity(seqs, "BLOSUM45", *gaps)
    )


def test_port_oracle_equals_jax_oracle():
    from dynaalign_torch import oracle

    seqs = _mixed()[:10]
    for matrix, gaps in [("BLOSUM62", (10, 4)), ("BLOSUM90", (5, 1))]:
        np.testing.assert_array_equal(
            oracle.nw_similarity(seqs, matrix, *gaps),
            joracle.nw_similarity(seqs, matrix, *gaps),
        )
    assert oracle.nw_pair("ARND", "AR*") == joracle.nw_pair("ARND", "AR*")
    with pytest.raises(ValueError, match="Invalid substitution matrix"):
        oracle.nw_pair("A", "A", "PAM250")
    with pytest.raises(ValueError, match="Invalid amino acid"):
        oracle.nw_similarity(["AJ", "A"])


def test_h3n2_equals_oracle():
    seqs = datasets.load_sequences("h3n2sample", 16)
    got = dt.similarity_nw(seqs, device="cpu")
    np.testing.assert_array_equal(got, joracle.nw_similarity(seqs))
    assert np.all(np.diag(got) == 1.0)


def test_chunked_stream_equals_one_launch():
    seqs = _mixed()
    one = dt.similarity_nw(seqs, device="cpu", chunk=10**6)
    for fn in ENTRY_POINTS:
        np.testing.assert_array_equal(fn(seqs, device="cpu", chunk=64), one)


def test_lower_index_is_sequence_one():
    """Tie-breaking is not symmetric under a swap: (i, j) with i < j must
    align s_i as sequence 1, and the matrix holds that value both ways."""
    rng = np.random.default_rng(2)
    for _ in range(200):
        s1, s2 = ("".join(rng.choice(list("ACDW"), size=k))
                  for k in rng.integers(2, 9, 2))
        if joracle.nw_pair(s1, s2) != joracle.nw_pair(s2, s1):
            break
    else:
        pytest.fail("no orientation-sensitive pair found")
    for fn in ENTRY_POINTS:
        got = fn([s1, s2], device="cpu")
        assert got[0, 1] == got[1, 0] == joracle.nw_pair(s1, s2)
        got = fn([s2, s1], device="cpu")
        assert got[0, 1] == got[1, 0] == joracle.nw_pair(s2, s1)


@pytest.mark.parametrize("name", jblosum.MATRIX_NAMES)
def test_get_matrix_equals_jax(name):
    for padded in (True, False):
        got = blosum.get_matrix(name, padded=padded)
        assert got.dtype == torch.int32
        ref = jblosum.get_matrix(name, padded=padded)
        np.testing.assert_array_equal(got.numpy(), ref)
        np.testing.assert_array_equal(
            blosum.from_numpy(ref, "cpu").numpy(), ref
        )
    assert dt.MATRIX_NAMES == jblosum.MATRIX_NAMES


@pytest.mark.parametrize("kw", [{}, {"pad_to": 90}, {"pad_multiple": 8}])
def test_encode_equals_jax(kw):
    rng = np.random.default_rng(4)
    seqs = ["".join(rng.choice(list(ALPHABET), size=k))
            for k in rng.integers(1, 60, 20)]
    got, ref = encode(seqs, **kw), jencode(seqs, **kw)
    for field in ("ascii", "indices", "lengths"):
        np.testing.assert_array_equal(getattr(got, field), getattr(ref, field))
        assert getattr(got, field).dtype == getattr(ref, field).dtype
    assert decode(got.indices[3]) == seqs[3]
    assert (ALPHABET, PAD_ID) == (JALPHABET, 24)
    lazy = ["AJ", "OU"]
    np.testing.assert_array_equal(
        encode(lazy, validate=False).indices,
        jencode(lazy, validate=False).indices,
    )


def test_bucket_by_length_equals_jax():
    rng = np.random.default_rng(8)
    seqs = ["".join(rng.choice(list("ACDE"), size=k))
            for k in [1, 16, 17, 32, 33, 64, 100, 5, 300]]
    got = bucket_by_length(seqs)
    ref = jbucket(seqs)
    assert len(got) == len(ref)
    for (gp, ge), (rp, re_) in zip(got, ref):
        np.testing.assert_array_equal(gp, rp)
        np.testing.assert_array_equal(ge.indices, re_.indices)
    with pytest.raises(ValueError, match="max bucket edge"):
        bucket_by_length(["A" * 40], bucket_edges=(16, 32))


def test_bucketed_default_edges_equal_jax():
    """Both packages bucket with (15, 31, ..., 2047): both refuse a
    2,048-aa sequence with the same error, and agree on a mixed set."""
    from dynaalign_tpu.api import PALLAS_BUCKET_EDGES

    from dynaalign_torch import api

    assert api.BUCKET_EDGES == PALLAS_BUCKET_EDGES
    too_long = ["ARND", "A" * 2048]
    with pytest.raises(ValueError) as ours:
        dt.similarity_nw_bucketed(too_long, device="cpu")
    with pytest.raises(ValueError) as theirs:
        dj.similarity_nw_bucketed(too_long)
    assert str(ours.value) == str(theirs.value)
    assert "2047" in str(ours.value)
    rng = np.random.default_rng(9)
    seqs = ["".join(rng.choice(list(ALPHABET), size=k))
            for k in [3, 15, 16, 31, 7, 90, 127, 30]]
    got = dt.similarity_nw_bucketed(seqs, device="cpu")
    np.testing.assert_array_equal(got, dj.similarity_nw_bucketed(seqs,
                                                                 batch=8))
    np.testing.assert_array_equal(got, joracle.nw_similarity(seqs))


@pytest.mark.parametrize("name", ["evp_peparray", "h3n2sample"])
def test_load_sequences_equals_jax(name):
    assert datasets.load_sequences(name, 50) == jdatasets.load_sequences(
        name, 50
    )


@pytest.mark.parametrize("fn", ENTRY_POINTS, ids=lambda f: f.__name__)
@pytest.mark.parametrize("args, match", [
    (([],), "Input sequences vector cannot be empty"),
    ((["ARND"], "BLOSUM13"), "Invalid substitution matrix name: BLOSUM13"),
    ((["ARND", "AJRN"],), "Invalid amino acid 'J'"),
    ((["ARUN"],), "Invalid amino acid 'U'"),
    ((["ARND", "xO"],), "Invalid amino acid 'x'"),
])
def test_value_errors(fn, args, match):
    with pytest.raises(ValueError, match=match):
        fn(*args, device="cpu")


def test_invalid_sequence_error_is_value_error():
    with pytest.raises(InvalidSequenceError):
        encode(["AOA"])
    assert issubclass(InvalidSequenceError, ValueError)


@pytest.mark.parametrize("fn", ENTRY_POINTS, ids=lambda f: f.__name__)
def test_default_device_without_card_raises(fn, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fn(["ARND", "ARNE"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fn(["ARND", "ARNE"], device="cuda")


def test_nw_rescore_pairs_default_device_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dt.nw_rescore_pairs(["ARND", "ARNE"], [0], [1])


def test_import_does_not_load_jax():
    code = (
        "import dynaalign_torch, dynaalign_torch.models, "
        "dynaalign_torch.tools.probe_misalign, sys; "
        "assert not any(m == 'jax' or m.startswith('jax.') "
        "for m in sys.modules)"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   cwd=os.path.dirname(PKG_DIR))


def test_no_source_mentions_jax_or_the_jax_package():
    offenders = []
    for root, dirs, files in os.walk(PKG_DIR):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        for f in files:
            path = os.path.join(root, f)
            with open(path, "rb") as fh:
                data = fh.read()
            for word in (b"import jax", b"from jax", b"dynaalign_tpu"):
                if word in data:
                    offenders.append((path, word))
    assert offenders == []


@pytest.mark.parametrize("max_len", range(1105, 1126))
def test_no_routing_gap_near_the_width_limit(max_len, monkeypatch):
    """The JAX package sends max_len 1112 alone to its slow scan. The port
    pads as similarity_nw pads, and every padded width up to 1119 goes to
    nw_gotoh ("cuda"), 1120 and above to nw_gotoh_xl ("cuda_xl")."""
    from dynaalign_torch import api
    from dynaalign_torch.ops import MAX_MP1, pick_nw_backend
    from dynaalign_torch.ops.nw import NWResult

    widths = set()

    def record(a_idx, a_len, b_idx, b_len, sub, *, gap_open, gap_ext):
        widths.add((a_idx.shape[1], b_idx.shape[1]))
        ones = torch.ones(a_idx.shape[0], dtype=torch.int32)
        return NWResult(ones, ones)

    monkeypatch.setattr(api, "nw_batch", record)
    api.similarity_nw(["A" * max_len, "W" * 7, "ARND" * 3], device="cpu")
    assert widths == {(max_len, max_len)}
    want = "cuda" if max_len + 1 <= MAX_MP1 else "cuda_xl"
    assert want == ("cuda" if max_len <= 1119 else "cuda_xl")
    assert pick_nw_backend("cuda", *widths.pop()) == want


def test_root_has_every_name_of_the_jax_root():
    """In a fresh interpreter: every public name of dynaalign_tpu's root
    is a name of dynaalign_torch's, of the same kind (module or not)."""
    code = (
        "import types, dynaalign_tpu as dj, dynaalign_torch as dt; "
        "pub = lambda m: {n: isinstance(getattr(m, n), types.ModuleType) "
        "for n in dir(m) if not n.startswith('_')}; "
        "a, b = pub(dj), pub(dt); "
        "bad = sorted(n for n in a if b.get(n) is not a[n]); "
        "assert not bad, bad"
    )
    subprocess.run([sys.executable, "-c", code], check=True,
                   cwd=os.path.dirname(PKG_DIR),
                   env={**os.environ, "JAX_PLATFORMS": "cpu"})


def test_encode_is_the_module():
    import types

    import dynaalign_torch.encode as m

    assert isinstance(dt.encode, types.ModuleType) and dt.encode is m
    assert dt.encode_sequences is m.encode and dt.EncodedSeqs is m.EncodedSeqs
    assert isinstance(dj.encode, types.ModuleType)
    enc = dt.encode_sequences(["ARND", "A"])
    assert (enc.n, enc.max_len) == (2, 4) == (jencode(["ARND", "A"]).n,
                                             jencode(["ARND", "A"]).max_len)


# The JAX package's keywords that the port leaves out, by function, each
# with what takes its place in the port (None: a TPU knob with no
# counterpart).  README's port section lists the same.
DROPPED = {
    "similarity_nw": {"tile": "chunk"},
    "similarity_nw_bucketed": {"batch": "chunk"},
    "models.nw_rescore_pairs": {"batch": "chunk"},
    "oracle.nw_similarity": {"n_threads": None},
    "parallel.sharded_nw_allpairs": {"backend": None},
    "parallel.sharded_nw_allpairs_bucketed": {"backend": None},
    "parallel.bucketed_schedule_stats": {"backend": None},
    "parallel.plan_bucket_group": {"pallas_ok": None},
    "parallel.allpairs.pick_group_batch": {"pallas_ok": None},
}
# The keywords the port adds, by function: cluster_large_exact fills a
# caller's dict with the graph it clustered.
ADDED = {"cluster_large_exact": {"graph"}}
PUBLIC = sorted({
    *(n for n in dir(dj) if not n.startswith("_")
      and callable(getattr(dj, n)) and not n[0].isupper() or n in (
          "MinHashEngine", "Pipeline", "EncodedSeqs")),
    "models.hybrid_topk_edges", "models.nw_rescore_pairs",
    "oracle.nw_similarity", "oracle.minhash_similarity",
    "ops.nw.nw_pairs", "ops.topk_graph.minhash_topk",
    "ops.minhash.minhash_signatures",
    "cluster._native.louvain_native_available",
    *(f"parallel.{n}" for n in (
        "distributed_init", "make_mesh", "replicated", "row_sharded",
        "block_sharded", "sharded_signature_agreement",
        "sharded_minhash_similarity", "sharded_nw_allpairs",
        "sharded_nw_allpairs_bucketed", "sharded_minhash_topk",
        "plan_nw_allpairs", "nw_allpairs_schedule_stats", "plan_bucket_group",
        "bucketed_schedule_stats", "allpairs.pick_group_batch",
        "failures.clean_abort", "failures.check_devices_healthy")),
})


def _resolve(pkg: str, path: str):
    import importlib

    *mod, name = path.split(".")
    return getattr(importlib.import_module(".".join([pkg, *mod])), name)


@pytest.mark.parametrize("path", PUBLIC)
def test_keyword_set_equals_jax(path):
    """The port's keywords are the JAX function's, less DROPPED (with its
    replacements), plus ADDED, plus ``device`` where the port computes on
    a device."""
    import inspect

    def names(fn):
        return set(inspect.signature(fn).parameters)

    ours = names(_resolve("dynaalign_torch", path))
    theirs = names(_resolve("dynaalign_tpu", path))
    dropped = DROPPED.get(path, {})
    added = ADDED.get(path, set())
    want = (theirs - set(dropped)) | {r for r in dropped.values() if r}
    assert not added & theirs and added <= ours
    assert ours - {"device"} - added == want


def test_similarity_nw_progress_prints_one_line_per_launch(capsys):
    seqs = _mixed()
    quiet = dt.similarity_nw(seqs, device="cpu", chunk=64)
    assert capsys.readouterr().out == ""
    loud = dt.similarity_nw(seqs, progress=True, device="cpu", chunk=64)
    lines = capsys.readouterr().out.splitlines()
    n_pairs = len(seqs) * (len(seqs) + 1) // 2
    n_launch = -(-n_pairs // 64)
    assert lines == [f"nw: launch {k}/{n_launch} (64 pairs each)"
                     for k in range(1, n_launch + 1)]
    np.testing.assert_array_equal(loud, quiet)


def test_nw_pairs_equals_jax():
    from dynaalign_tpu.ops.nw import nw_pairs as jnw_pairs

    from dynaalign_torch.ops.nw import nw_pairs

    seqs = _mixed()
    enc = encode(seqs)
    a, b = np.arange(len(seqs)), np.arange(len(seqs))[::-1]
    args = (enc.indices[a], enc.lengths[a], enc.indices[b], enc.lengths[b])
    for kw in ({}, {"gap_open": 5, "gap_ext": 1}):
        got = nw_pairs(*args, blosum.get_matrix(), device="cpu", **kw)
        want = jnw_pairs(*args, jblosum.get_matrix(), **kw)
        assert got.dtype == np.float64
        np.testing.assert_array_equal(got, want)


def test_louvain_native_available():
    from dynaalign_torch.cluster._native import louvain_native_available

    assert louvain_native_available() is True
