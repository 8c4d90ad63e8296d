"""The port's long-pair NW path on the CPU: the plain version against the
JAX package at XL widths, the ``nw_gotoh_xl`` kernel source run as threaded
host C++, the width routing and launch sizing, and the entry points on a set
with a sequence past 1,119 aa.

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
from test_torch_harness import atomic_log, build_host, ptr  # noqa: E402

import dynaalign_torch as dt  # noqa: E402
from dynaalign_torch import api, blosum, ops  # noqa: E402
from dynaalign_torch.encode import ALPHABET, encode  # noqa: E402
from dynaalign_torch.io.datasets import load_sequences  # noqa: E402
from dynaalign_torch.ops import nw_cuda  # noqa: E402
from dynaalign_torch.ops.nw import nw_similarity_batch  # noqa: E402
from dynaalign_torch.utils import profiling  # noqa: E402

GAPS = [(10, 4), (5, 1), (12, 2)]
STRIP = nw_cuda.XL_STRIP  # DP rows per warp pass of nw_gotoh_xl.cu


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
# The kernel source, run as threaded host C++ (tests/test_torch_harness.py)
# ---------------------------------------------------------------------------

_XL_SHIM = r"""
#define __shared__ static
#include "nw_gotoh_xl.cu"
extern "C" int xl_warps() { return XL_WARPS; }
// nwd: 1 runs the packed instantiation (MT and LN in one word), 2 the
// two-word one; the launcher picks by M + N, here the test does.  sync: the
// queue counter, 31 words, then a progress word per item, all 0.  The
// launcher's grid, blocks of XL_WARPS warps, run in turn as the harness runs
// them.
extern "C" void nw_gotoh_xl_host(const int* a_idx, const int* a_len,
    const int* b_idx, const int* b_len, const int* sub, int B, int M, int N,
    int go, int ge, const int* items, int n_items, int* bnd, int* sync,
    int* mt, int* ln, int nwd) {
  harness::launch(nw_gotoh_xl_blocks(B, n_items), 32 * XL_WARPS, [&] {
    if (nwd == 1) {
      nw_gotoh_xl_kernel<1>(a_idx, a_len, b_idx, b_len, sub, B, M, N, go, ge,
                            items, n_items, bnd, sync, sync + 32, mt, ln);
    } else {
      nw_gotoh_xl_kernel<2>(a_idx, a_len, b_idx, b_len, sub, B, M, N, go, ge,
                            items, n_items, bnd, sync, sync + 32, mt, ln);
    }
  });
}
"""
# the list-order schedule the queue replaced, a variant of tools/nw_variants
_XL_LIST_SHIM = "#define XL_QUEUE 0\n" + _XL_SHIM
NWDS = [1, 2]  # path words: the packed and the two-word instantiation


@pytest.fixture(scope="module", autouse=True)
def _few_intra_op_threads():
    """At most 4 intra-op threads while this module runs: the host harness
    runs a std::thread per CUDA thread with a barrier a step, and stalls
    while torch's thread pools of this and other workers hold the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def xl_lib(tmp_path_factory):
    """The source as it stands: blocks of XL_WARPS = 2 warps, so that two
    strips of a pair run at once (a harness thread per CUDA thread: more
    warps cost the host more than they check)."""
    return build_host(tmp_path_factory.mktemp("xl_host"), "nw_gotoh_xl",
                      _XL_SHIM)


@pytest.fixture(scope="module")
def xl_lib4(tmp_path_factory):
    """Blocks of 4 warps."""
    return build_host(tmp_path_factory.mktemp("xl_host4"), "nw_gotoh_xl",
                      "#define XL_WARPS 4\n" + _XL_SHIM)


def _xl_runner(lib):
    fn = lib.nw_gotoh_xl_host
    fn.restype = None

    def run(arrs, matrix="BLOSUM62", go=10, ge=4, nwd=1):
        """``matrix``: a BLOSUM name or a [32, 32] table.  The work table
        is the wrapper's (nw_cuda.xl_work_table)."""
        a, la, b, lb = [np.ascontiguousarray(x, np.int32) for x in arrs]
        bsz, m = a.shape
        n = b.shape[1]
        if isinstance(matrix, str):
            matrix = jblosum.get_matrix(matrix)
        # the kernel takes the table transposed
        sub = np.ascontiguousarray(np.asarray(matrix).T, np.int32)
        tla, tlb = torch.from_numpy(la), torch.from_numpy(lb)
        strip = lib.nw_gotoh_xl_strip_rows()
        n_items = int(nw_cuda.xl_strips(tla, tlb, strip).sum())
        items = np.ascontiguousarray(
            nw_cuda.xl_work_table(tla, tlb, strip, n_items).numpy())
        bnd = np.full(nw_cuda.SCRATCH_PLANES["nw_gotoh_xl"] * (n + 1) * bsz,
                      -7, np.int32)
        sync = np.zeros(32 + n_items, np.int32)
        mt, ln = np.full(bsz, -7, np.int32), np.full(bsz, -7, np.int32)
        fn(ptr(a), ptr(la), ptr(b), ptr(lb), ptr(sub), bsz, m, n, go, ge,
           ptr(items), n_items, ptr(bnd), ptr(sync), ptr(mt), ptr(ln), nwd)
        return mt, ln

    return run


@pytest.fixture(scope="module")
def xl_host(xl_lib):
    return _xl_runner(xl_lib)


def test_xl_strip_mirrors_the_source(xl_lib):
    """nw_cuda.XL_STRIP, which it reads from the source, is 32 * XL_R, the
    strip height the built source reports for its work table."""
    import os
    import re

    from dynaalign_torch.ops import _build

    with open(os.path.join(_build.CSRC, "nw_gotoh_xl.cu")) as f:
        rows = int(re.search(r"#define XL_R (\d+)", f.read())[1])
    assert nw_cuda.XL_STRIP == 32 * rows == xl_lib.nw_gotoh_xl_strip_rows()


def test_xl_path_words_follow_the_width(xl_lib):
    """MT and LN share a word while padded M + N < 65,536."""
    words = xl_lib.nw_gotoh_xl_words
    assert [words(m, n) for m, n in ((1, 1), (32767, 32768), (65534, 1))] \
        == [1, 1, 1]
    assert [words(m, n) for m, n in ((32768, 32768), (65535, 1),
                                     (300, 80000), (40000, 40000))] \
        == [2, 2, 2, 2]


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


@pytest.mark.parametrize("nwd", NWDS)
def test_xl_source_reads_table_row_a_column_b(xl_host, nwd):
    """A table that is not symmetric: a cell scores sub[a_i][b_j]."""
    rng = np.random.default_rng(46)
    sub_np = np.array(jblosum.get_matrix("BLOSUM50"), np.int32)
    sub_np[:24, :24] += rng.integers(-3, 4, size=(24, 24), dtype=np.int32)
    assert (sub_np != sub_np.T).any()
    arrs = _batch(_seqs(rng, 6, 1, STRIP + 30), _seqs(rng, 6, 1, 60))
    ref = nw_similarity_batch(*[torch.from_numpy(x) for x in arrs],
                              torch.from_numpy(sub_np), gap_open=12,
                              gap_ext=2)
    _assert_equal(xl_host(arrs, sub_np, 12, 2, nwd=nwd),
                  (ref.matches.numpy(), ref.length.numpy()))


@pytest.mark.parametrize("gaps", GAPS)
@pytest.mark.parametrize("matrix", jblosum.MATRIX_NAMES)
def test_xl_source_equals_plain_fuzz(xl_host, matrix, gaps):
    rng = np.random.default_rng(
        40 + 3 * jblosum.MATRIX_NAMES.index(matrix) + GAPS.index(gaps))
    arrs = _batch(_seqs(rng, 6, 1, 80), _seqs(rng, 6, 1, 80))
    ref = _plain(arrs, matrix, *gaps)
    for nwd in NWDS:
        _assert_equal(xl_host(arrs, matrix, *gaps, nwd=nwd), ref)


@pytest.mark.parametrize("case", [
    (3, STRIP + 50, 2 * STRIP + 60, 20, 60),  # 2-3 strips, few columns
    (3, 20, 60, 300, 700),  # one strip, many columns
    (3, STRIP + 10, STRIP + 120, 280, 330),  # 2 strips, m != n
    # 1-4 columns: the traceback turns at column 1, where each lane's first
    # row takes its diagonal from the column-0 border
    (24, STRIP // 2, 2 * STRIP + 60, 1, 4),
])
@pytest.mark.parametrize("nwd", NWDS)
def test_xl_source_equals_plain_across_strips(xl_host, case, nwd):
    n, alo, ahi, blo, bhi = case
    rng = np.random.default_rng(alo + blo)
    arrs = _batch(_seqs(rng, n, alo, ahi), _seqs(rng, n, blo, bhi))
    _assert_equal(xl_host(arrs, "BLOSUM80", 5, 1, nwd=nwd),
                  _plain(arrs, "BLOSUM80", 5, 1))


@pytest.mark.parametrize("nwd", NWDS)
def test_xl_source_edge_lengths(xl_host, nwd):
    """Empty sides, the empty pair, length 1, a_len on and next to strip
    edges, padding past the lengths, and a batch that leaves the last
    block's warps idle (7 pairs, 2 warps per block)."""
    rng = np.random.default_rng(50)
    a_lens = [0, 5, 0, 1, STRIP - 1, STRIP, STRIP + 1, 2 * STRIP, 1, 9]
    b_lens = [7, 0, 0, 1, 12, 40, 3, 17, 30, 1]
    a = ["".join(rng.choice(list(ALPHABET), size=k)) for k in a_lens]
    b = ["".join(rng.choice(list(ALPHABET), size=k)) for k in b_lens]
    arrs = _batch(a, b, 2 * STRIP + 3, 45)
    got = xl_host(arrs, nwd=nwd)
    _assert_equal(got, _plain(arrs))
    assert (got[0][:3] == 0).all() and list(got[1][:3]) == [7, 5, 0]
    sims = _ratio(got)
    assert np.isnan(sims[2])
    np.testing.assert_array_equal(
        sims, [joracle.nw_pair(x, y) if x or y else np.nan
               for x, y in zip(a, b)])
    part = tuple(x[:7] for x in arrs)
    _assert_equal(xl_host(part, nwd=nwd), _plain(part))


@pytest.mark.parametrize("nwd", NWDS)
def test_xl_source_equals_oracle_on_h3n2_joins(xl_host, nwd):
    """3 pairs of two h3n2sample HA proteins joined (>= 1,132 aa)."""
    seqs = load_sequences("h3n2sample", 12)
    joins = [seqs[2 * k] + seqs[2 * k + 1] for k in range(6)]
    pairs = list(zip(joins[0::2], joins[1::2]))
    assert min(len(s) for s in joins) >= 1132
    got = xl_host(_batch([p[0] for p in pairs], [p[1] for p in pairs]),
                  nwd=nwd)
    np.testing.assert_array_equal(
        _ratio(got), [joracle.nw_pair(x, y) for x, y in pairs])


@pytest.mark.parametrize("nwd", NWDS)
def test_xl_source_tie_heavy(xl_host, nwd):
    """Low-complexity sequences under BLOSUM45 with gaps (5, 1), over two
    strips: ties between diag, ix and iy at many cells."""
    rng = np.random.default_rng(45)
    a = ["".join(rng.choice(list("AAG"), size=k))
         for k in (STRIP + 44, STRIP + 1, 40, 9)]
    b = ["".join(rng.choice(list("AGG"), size=k)) for k in (60, 35, 50, 3)]
    arrs = _batch(a, b)
    got = xl_host(arrs, "BLOSUM45", 5, 1, nwd=nwd)
    _assert_equal(got, _plain(arrs, "BLOSUM45", 5, 1))
    np.testing.assert_array_equal(
        _ratio(got), [joracle.nw_pair(x, y, "BLOSUM45", 5, 1)
                      for x, y in zip(a, b)])


def _strings(rng, lens, letters=ALPHABET):
    return ["".join(rng.choice(list(letters), size=k)) for k in lens]


@pytest.mark.parametrize("nwd", NWDS)
def test_xl_source_skewed_batch_in_input_order(xl_host, nwd):
    """Lengths far apart, so that the longest-first table is no
    permutation of the input; the results come back in input order."""
    rng = np.random.default_rng(80)
    a_lens = [12, 3 * STRIP + 5, 40, 700, 2 * STRIP, 1, 90, STRIP + 1]
    b_lens = [30, 70, 5, 160, 33, 1, 120, 64]
    a, b = _strings(rng, a_lens), _strings(rng, b_lens)
    arrs = _batch(a, b)
    tl = [torch.tensor(x, dtype=torch.int32) for x in (a_lens, b_lens)]
    table = nw_cuda.xl_work_table(*tl, STRIP, int(nw_cuda.xl_strips(
        *tl, STRIP).sum()))
    firsts = table[table[:, 1] == 0, 0].tolist()
    assert firsts == [1, 3, 4, 7, 6, 0, 2, 5]  # not input order
    got = xl_host(arrs, "BLOSUM62", 12, 2, nwd=nwd)
    _assert_equal(got, _plain(arrs, "BLOSUM62", 12, 2))
    np.testing.assert_array_equal(
        _ratio(got),
        [joracle.nw_pair(x, y, "BLOSUM62", 12, 2) for x, y in zip(a, b)])


def _taken_by(log, items):
    """{item: the warp that dequeued it} from an atomicAdd log."""
    return {int(k): int(w) for k, w in log if k < items}


@pytest.mark.parametrize("nwd", NWDS)
def test_xl_source_strips_of_one_pair_run_on_different_warps(xl_lib4, nwd):
    """A pair of 6 strips among 16 pairs of one strip, in blocks of 4
    warps: its strips are the first 6 items, each warp takes one ticket, and
    strips s and s + 1 taken by two warps of one block ran at once (the
    harness runs a block's warps at once and the blocks in turn), s + 1
    waiting on s chunk by chunk."""
    rng = np.random.default_rng(81)
    a_lens = [*rng.integers(1, 90, size=8), 5 * STRIP + 37,
              *rng.integers(1, 90, size=8)]
    b_lens = [*rng.integers(1, 90, size=8), 100,
              *rng.integers(1, 90, size=8)]
    a, b = _strings(rng, a_lens), _strings(rng, b_lens)
    arrs = _batch(a, b)
    got = _xl_runner(xl_lib4)(arrs, "BLOSUM80", 5, 1, nwd=nwd)
    log = atomic_log(xl_lib4)
    _assert_equal(got, _plain(arrs, "BLOSUM80", 5, 1))
    assert _ratio(got)[8] == joracle.nw_pair(a[8], b[8], "BLOSUM80", 5, 1)
    taken = _taken_by(log, 6 + 16)
    warps = xl_lib4.xl_warps()
    assert warps == 4 and len(log) == 24  # a ticket a warp, 6 blocks
    assert sorted(taken) == list(range(22))
    assert len(set(taken.values())) == 22
    # block 0 takes strips 0-3, block 1 strips 4-5
    together = [s for s in range(5)
                if taken[s] // warps == taken[s + 1] // warps]
    assert together == [0, 1, 2, 4], taken


@pytest.mark.parametrize("nwd", NWDS)
def test_xl_source_empty_sides_among_strips(xl_host, nwd):
    """a_len = 0 and b_len = 0 pairs, one item each whatever the other
    side's length, inside a table of multi-strip pairs."""
    rng = np.random.default_rng(82)
    a_lens = [0, 2 * STRIP + 3, 2 * STRIP + 9, 0, STRIP + 4, 17, 0]
    b_lens = [45, 0, 40, 0, 31, 0, 1]
    a, b = _strings(rng, a_lens), _strings(rng, b_lens)
    arrs = _batch(a, b)
    tl = [torch.tensor(x, dtype=torch.int32) for x in (a_lens, b_lens)]
    assert nw_cuda.xl_strips(*tl, STRIP).tolist() == [1, 1, 3, 1, 2, 1, 1]
    got = xl_host(arrs, nwd=nwd)
    _assert_equal(got, _plain(arrs))
    assert list(got[0][[0, 1, 3, 5, 6]]) == [0] * 5
    assert list(got[1][[0, 1, 3, 5, 6]]) == [45, 2 * STRIP + 3, 0, 17, 1]


@pytest.mark.parametrize("nwd", NWDS)
def test_xl_source_does_not_transpose(xl_host, nwd):
    """(a, b) and (b, a) of the same tie-heavy sequences in one batch, a
    longer or shorter than b, over one to three strips: each keeps its own
    orientation, and some pairs give different (matches, length) the two
    ways, so a transposed pair would show."""
    rng = np.random.default_rng(77)
    xs = _strings(rng, [700, 660, 650, 1300, 90, 641], "AAG")
    ys = _strings(rng, [650, 640, 100, 1250, 85, 600], "AGG")
    arrs = _batch(xs + ys, ys + xs)
    got = xl_host(arrs, "BLOSUM45", 5, 1, nwd=nwd)
    ref = _plain(arrs, "BLOSUM45", 5, 1)
    _assert_equal(got, ref)
    assert (ref[0][:6] != ref[0][6:]).any()
    np.testing.assert_array_equal(
        _ratio(got), [joracle.nw_pair(x, y, "BLOSUM45", 5, 1)
                      for x, y in zip(xs + ys, ys + xs)])


def test_xl_source_empty_batch(xl_host):
    """B = 0: an empty table and a grid of no blocks."""
    arrs = (np.zeros((0, 4), np.int32), np.zeros(0, np.int32),
            np.zeros((0, 4), np.int32), np.zeros(0, np.int32))
    for nwd in NWDS:
        mt, ln = xl_host(arrs, nwd=nwd)
        assert mt.shape == ln.shape == (0,)


@pytest.mark.parametrize("nwd", NWDS)
def test_xl_list_order_variant_equals_plain(tmp_path_factory, nwd):
    """The schedule the queue replaced (XL_QUEUE=0, one warp a pair in list
    order), which tools/nw_variants.py times beside it, still computes the
    same function."""
    run = _xl_runner(build_host(tmp_path_factory.mktemp("xl_list"),
                                "nw_gotoh_xl", _XL_LIST_SHIM))
    rng = np.random.default_rng(83)
    arrs = _batch(_seqs(rng, 6, STRIP - 3, 2 * STRIP + 40),
                  _seqs(rng, 6, 1, 70))
    _assert_equal(run(arrs, "BLOSUM50", 12, 2, nwd=nwd),
                  _plain(arrs, "BLOSUM50", 12, 2))


# ---------------------------------------------------------------------------
# Routing, launch sizing and the entry points on the CPU
# ---------------------------------------------------------------------------

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
