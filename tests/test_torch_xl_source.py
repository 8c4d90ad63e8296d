"""The ``nw_gotoh_xl`` kernel source run as threaded host C++ (the harness of
``tests/test_torch_harness.py``), as on the card a queue of (pair, strip)
items from ``nw_cuda.xl_work_table``: the shim and its fixtures, the strip
height and path words the source reports, a table that is not symmetric,
the h3n2 joins, tie-heavy sequences and the empty batch, against the plain
version and the C++ oracle.  The queue under load is in
``test_torch_xl_source_queue.py``, which imports the shim and the fixtures
from here.

Two files, and their order of tests: ``--dist loadfile`` runs a file on one
worker, in order, and hands out files with more tests first.  The harness
(a thread per CUDA thread, a barrier a shuffle, waiting warps that yield)
slows by one to two orders of magnitude beside other workers' torch thread
pools, worst beside the small files that go last.  So the costly checks
fill the larger file, costliest first, and this file keeps the cheap ones.

Every comparison is exact (tolerance 0).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from dynaalign_tpu import blosum as jblosum  # noqa: E402
from dynaalign_tpu import oracle as joracle  # noqa: E402
from test_torch_harness import build_host, ptr  # noqa: E402
# _few_intra_op_threads: test_torch_xl.py's cap on torch's threads, here too
from test_torch_xl import (  # noqa: E402, F401
    _assert_equal,
    _batch,
    _few_intra_op_threads,
    _plain,
    _ratio,
    _seqs,
)

from dynaalign_torch.io.datasets import load_sequences  # noqa: E402
from dynaalign_torch.ops import nw_cuda  # noqa: E402
from dynaalign_torch.ops.nw import nw_similarity_batch  # noqa: E402

STRIP = nw_cuda.XL_STRIP  # DP rows per warp pass of nw_gotoh_xl.cu

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
  harness::launch(nw_gotoh_xl_blocks(n_items), 32 * XL_WARPS, [&] {
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
NWDS = [1, 2]  # path words: the packed and the two-word instantiation


@pytest.fixture(scope="module")
def xl_lib(tmp_path_factory):
    """The source as it stands: blocks of XL_WARPS = 2 warps, so that two
    strips of a pair run at once (a harness thread per CUDA thread: more
    warps cost the host more than they check)."""
    return build_host(tmp_path_factory.mktemp("xl_host"), "nw_gotoh_xl",
                      _XL_SHIM)


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


def test_xl_source_empty_batch(xl_host):
    """B = 0: an empty table and a grid of no blocks."""
    arrs = (np.zeros((0, 4), np.int32), np.zeros(0, np.int32),
            np.zeros((0, 4), np.int32), np.zeros(0, np.int32))
    for nwd in NWDS:
        mt, ln = xl_host(arrs, nwd=nwd)
        assert mt.shape == ln.shape == (0,)
