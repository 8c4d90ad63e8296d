"""The port's long-pair NW path on the CPU: the plain version against the
JAX package at XL widths, the width routing, work table and launch sizing,
and the entry points on a set with a sequence past 1,119 aa.  The
``nw_gotoh_xl`` kernel source, run as threaded host C++:
``test_torch_xl_source.py`` and ``test_torch_xl_source_queue.py``.

Every comparison is exact (tolerance 0): the reference is integer DP with a
float64 division at the end.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import dynaalign_tpu as dj  # noqa: E402
from dynaalign_tpu import blosum as jblosum  # noqa: E402
from dynaalign_tpu import oracle as joracle  # noqa: E402
from dynaalign_tpu.models.pipeline import (  # noqa: E402
    nw_rescore_pairs as jax_rescore,
)
from dynaalign_tpu.ops.nw import nw_similarity_batch as jax_scan  # noqa: E402
from dynaalign_tpu.ops.nw_pallas import (  # noqa: E402
    nw_similarity_batch_pallas_xl,
)

import dynaalign_torch as dt  # noqa: E402
from dynaalign_torch import api, blosum, ops  # noqa: E402
from dynaalign_torch.encode import ALPHABET, encode  # noqa: E402
from dynaalign_torch.ops import nw_cuda  # noqa: E402
from dynaalign_torch.ops.nw import nw_similarity_batch  # noqa: E402
from dynaalign_torch.utils import profiling  # noqa: E402

def _seqs(rng, n, lo, hi):
    return ["".join(rng.choice(list(ALPHABET), size=k))
            for k in rng.integers(lo, hi + 1, size=n)]


def _batch(a_seqs, b_seqs, pad_a=None, pad_b=None):
    ea, eb = encode(a_seqs, pad_to=pad_a), encode(b_seqs, pad_to=pad_b)
    return ea.indices, ea.lengths, eb.indices, eb.lengths


def _plain(arrs, matrix="BLOSUM62", go=10, ge=4):
    res = nw_similarity_batch(*[torch.from_numpy(x) for x in arrs],
                              blosum.get_matrix(matrix), gap_open=go,
                              gap_ext=ge)
    return res.matches.numpy(), res.length.numpy()


def _jax(fn, arrs, matrix="BLOSUM62", go=10, ge=4, **kw):
    res = fn(*[jnp.asarray(x) for x in arrs],
             jnp.asarray(jblosum.get_matrix(matrix)),
             gap_open=go, gap_ext=ge, **kw)
    return np.asarray(res.matches), np.asarray(res.length)


def _ratio(res):
    with np.errstate(invalid="ignore", divide="ignore"):
        return res[0].astype(np.float64) / res[1]


def _assert_equal(got, ref):
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[1], ref[1])


@pytest.fixture(scope="module", autouse=True)
def _few_intra_op_threads():
    """At most 4 intra-op threads while this module runs: the host harness
    runs a std::thread per CUDA thread with a barrier a step, and stalls
    while torch's thread pools of this and other workers hold the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


def test_plain_equals_jax_scan_and_oracle_at_xl_widths():
    """4 pairs at 1,130-1,300 aa: padded m+1 > 1120, the _kernel_xl range."""
    rng = np.random.default_rng(30)
    a, b = _seqs(rng, 4, 1130, 1300), _seqs(rng, 4, 1130, 1300)
    arrs = _batch(a, b)
    assert arrs[0].shape[1] + 1 > ops.MAX_MP1
    got = _plain(arrs, "BLOSUM62", 12, 2)
    _assert_equal(got, _jax(jax_scan, arrs, "BLOSUM62", 12, 2))
    np.testing.assert_array_equal(
        _ratio(got),
        [joracle.nw_pair(x, y, "BLOSUM62", 12, 2) for x, y in zip(a, b)])


@pytest.mark.parametrize("gaps", [(10, 4), (12, 2)])
def test_plain_equals_jax_xl_kernel_interpret(gaps):
    """20-90 aa, odd batch, as tests/test_nw_pallas.py runs _kernel_xl."""
    rng = np.random.default_rng(31)
    seqs = _seqs(rng, 22, 20, 90)
    arrs = _batch(seqs[:11], seqs[11:])
    _assert_equal(
        _plain(arrs, "BLOSUM62", *gaps),
        _jax(nw_similarity_batch_pallas_xl, arrs, "BLOSUM62", *gaps,
             interpret=True))


# ---------------------------------------------------------------------------
# Routing, launch sizing and the entry points on the CPU
# ---------------------------------------------------------------------------

def test_xl_work_table_longest_first():
    """Pairs by a_len * b_len descending, equal products by index, each
    pair's strips consecutive and in order, one item for a pair without
    cells; the table's length is the sum of xl_strips."""
    strip = 10
    a_len, b_len = torch.tensor([[0, 25, 10, 5, 30, 0, 11, 20, 7, 10],
                                 [9, 4, 10, 0, 2, 0, 10, 5, 1, 10]],
                                dtype=torch.int32)
    strips = nw_cuda.xl_strips(a_len, b_len, strip)
    assert strips.tolist() == [1, 3, 1, 1, 3, 1, 2, 2, 1, 1]
    n_items = int(strips.sum())
    got = nw_cuda.xl_work_table(a_len, b_len, strip, n_items)
    assert got.dtype == torch.int32 and got.shape == (n_items, 2)
    cells = (a_len * b_len).tolist()
    order = sorted(range(10), key=lambda p: (-cells[p], p))
    assert order == [6, 1, 2, 7, 9, 4, 8, 0, 3, 5]  # 110, 100 x 4, 60, 7, 0s
    want = [(p, s) for p in order for s in range(strips[p])]
    assert [tuple(r) for r in got.tolist()] == want
    empty = torch.zeros(0, dtype=torch.int32)
    assert nw_cuda.xl_work_table(empty, empty, strip, 0).shape == (0, 2)


def test_xl_wrapper_on_cpu_runs_plain_without_launching():
    rng = np.random.default_rng(60)
    t = [torch.from_numpy(x) for x in _batch(_seqs(rng, 3, 1, 30),
                                             _seqs(rng, 3, 1, 30),
                                             ops.MAX_MP1, 40)]
    sub = blosum.get_matrix("BLOSUM45")
    profiling.reset()
    got = nw_cuda.nw_similarity_batch_cuda_xl(*t, sub, gap_open=5, gap_ext=1)
    ref = nw_similarity_batch(*t, sub, gap_open=5, gap_ext=1)
    launched = profiling.counters().keys() & {"nw_gotoh", "nw_gotoh_xl"}
    assert not launched
    assert torch.equal(got.matches, ref.matches)
    assert torch.equal(got.length, ref.length)
    with pytest.raises(TypeError, match="int32"):
        nw_cuda.nw_similarity_batch_cuda_xl(t[0].long(), *t[1:], sub)
    with pytest.raises(ValueError, match="no NW kernel"):
        nw_cuda.nw_similarity_batch_cuda_xl(*[x.to("meta") for x in t],
                                            sub.to("meta"))


def test_nw_batch_sends_wide_batches_to_the_xl_wrapper(monkeypatch):
    calls = []

    def spy(name, fn):
        def wrapped(*args, **kw):
            calls.append(name)
            return fn(*args, **kw)
        monkeypatch.setattr(ops, name, wrapped)

    spy("nw_similarity_batch_cuda", ops.nw_similarity_batch_cuda)
    spy("nw_similarity_batch_cuda_xl", ops.nw_similarity_batch_cuda_xl)
    pick = ops.pick_nw_backend  # routed as on a card; the data stay here
    monkeypatch.setattr(ops, "pick_nw_backend",
                        lambda dev, m, n: pick("cuda", m, n))
    rng = np.random.default_rng(61)
    sub = blosum.get_matrix()
    for pad, want in ((ops.MAX_MP1 - 1, "nw_similarity_batch_cuda"),
                      (ops.MAX_MP1, "nw_similarity_batch_cuda_xl")):
        t = [torch.from_numpy(x) for x in _batch(_seqs(rng, 2, 1, 9),
                                                 _seqs(rng, 2, 1, 9), pad, 9)]
        ref = nw_similarity_batch(*t, sub)
        got = ops.nw_batch(*t, sub)
        assert calls[-1] == want
        assert torch.equal(got.matches, ref.matches)


def test_launches_are_sized_in_bytes(monkeypatch):
    """h3n2 n=1000 keeps its 4 launches of 131,072 pairs; a small byte
    budget splits a pair list into launches under it."""
    per_pair = ops.pair_bytes(566, 566)
    assert api.LAUNCH_BYTES // per_pair >= api.DEFAULT_CHUNK
    assert -(-500_500 // api.DEFAULT_CHUNK) == 4
    assert api.LAUNCH_BYTES // ops.pair_bytes(12_288, 12_288) < \
        api.DEFAULT_CHUNK
    # nw_gotoh takes no scratch; nw_gotoh_xl a boundary row of 4 planes, 32
    # bytes of work table a pair and 24 an item (1,120 rows: 2 strips)
    assert ops.pair_bytes(1119, 10) == 4 * (1119 + 10 + 4)
    assert ops.pair_bytes(1120, 10) == \
        4 * (1120 + 10 + 4) + 16 * 11 + 32 + 24 * 2
    sizes = []
    real = api.nw_batch

    def counting(a_idx, *args, **kw):
        sizes.append(a_idx.shape[0])
        return real(a_idx, *args, **kw)

    monkeypatch.setattr(api, "nw_batch", counting)
    seqs = _seqs(np.random.default_rng(62), 12, 5, 20)
    ref = api.similarity_nw(seqs, device="cpu")
    width = max(len(s) for s in seqs)
    monkeypatch.setattr(api, "LAUNCH_BYTES",
                        10 * ops.pair_bytes(width, width) + 1)
    sizes.clear()
    np.testing.assert_array_equal(api.similarity_nw(seqs, device="cpu"), ref)
    assert sizes == [10] * 7 + [8]


def _long_set():
    """Short sequences around one of 1,125-1,200 aa."""
    rng = np.random.default_rng(70)
    short = _seqs(rng, 5, 4, 14)
    return short[:2] + _seqs(rng, 1, 1125, 1200) + short[2:]


@pytest.mark.parametrize("fn, kw", [("similarity_nw", {}),
                                    ("similarity_nw_bucketed", {"batch": 8})])
def test_entry_points_equal_jax_with_a_long_sequence(fn, kw):
    """(JAX's ``batch`` sizes its pair tiles; results do not depend on it.)"""
    seqs = _long_set()
    got = getattr(dt, fn)(seqs, device="cpu")
    np.testing.assert_array_equal(got, getattr(dj, fn)(seqs, **kw))
    np.testing.assert_array_equal(got, joracle.nw_similarity(seqs))


def test_nw_rescore_pairs_equals_jax_with_a_long_sequence():
    seqs = _long_set()
    pi = np.array([0, 2, 2, 5, 1, 2])
    pj = np.array([2, 0, 2, 2, 4, 3])
    got = dt.nw_rescore_pairs(seqs, pi, pj, device="cpu")
    assert got.dtype == np.float64 and got.shape == (6,)
    np.testing.assert_array_equal(got, jax_rescore(seqs, pi, pj, batch=8))
    np.testing.assert_array_equal(
        got, [joracle.nw_pair(seqs[i], seqs[j]) for i, j in zip(pi, pj)])


def test_nw_rescore_pairs_options_and_errors():
    seqs = _long_set()[:4] + ["WWW"]
    pi, pj = np.array([0, 3, 4]), np.array([4, 1, 0])
    got = dt.nw_rescore_pairs(seqs, pi, pj, matrix_name="BLOSUM45",
                              gap_open=5, gap_ext=1, device="cpu", chunk=2)
    np.testing.assert_array_equal(got, jax_rescore(
        seqs, pi, pj, matrix_name="BLOSUM45", gap_open=5, gap_ext=1,
        batch=8))
    empty = dt.nw_rescore_pairs(seqs, [], [], device="cpu")
    assert empty.shape == (0,) and empty.dtype == np.float64
    with pytest.raises(ValueError, match="differ in length"):
        dt.nw_rescore_pairs(seqs, [0, 1], [1], device="cpu")
    with pytest.raises(IndexError):
        dt.nw_rescore_pairs(seqs, [0], [5], device="cpu")
    with pytest.raises(ValueError, match="Invalid substitution matrix"):
        dt.nw_rescore_pairs(seqs, [0], [1], matrix_name="PAM1", device="cpu")
