"""The ``nw_gotoh_xl`` kernel source as threaded host C++, the queue of strips
under load: the strips of one pair on different warps of a block of 4 (each
waiting on the one above), (a, b) beside (b, a), a skewed batch whose
results come back in input order, pairs across strips, lengths on strip
edges, empty sides among multi-strip pairs and fuzz over every table and gap
setting.  The shim, the fixtures and why the checks fill two files, costliest
first: ``test_torch_xl_source.py``.

Every comparison is exact (tolerance 0).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from dynaalign_tpu import blosum as jblosum  # noqa: E402
from dynaalign_tpu import oracle as joracle  # noqa: E402
from test_torch_harness import atomic_log, build_host  # noqa: E402
# _few_intra_op_threads: test_torch_xl.py's cap on torch's threads, here too
from test_torch_xl import (  # noqa: E402, F401
    _assert_equal,
    _batch,
    _few_intra_op_threads,
    _plain,
    _ratio,
    _seqs,
)
from test_torch_xl_source import (  # noqa: E402, F401
    _XL_SHIM,
    NWDS,
    STRIP,
    _xl_runner,
    xl_host,
    xl_lib,
)

from dynaalign_torch.encode import ALPHABET  # noqa: E402
from dynaalign_torch.ops import nw_cuda  # noqa: E402

GAPS = [(10, 4), (5, 1), (12, 2)]


@pytest.fixture(scope="module")
def xl_lib4(tmp_path_factory):
    """Blocks of 4 warps."""
    return build_host(tmp_path_factory.mktemp("xl_host4"), "nw_gotoh_xl",
                      "#define XL_WARPS 4\n" + _XL_SHIM)


def _strings(rng, lens, letters=ALPHABET):
    return ["".join(rng.choice(list(letters), size=k)) for k in lens]


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


@pytest.mark.parametrize("gaps", GAPS)
@pytest.mark.parametrize("matrix", jblosum.MATRIX_NAMES)
def test_xl_source_equals_plain_fuzz(xl_host, matrix, gaps):
    rng = np.random.default_rng(
        40 + 3 * jblosum.MATRIX_NAMES.index(matrix) + GAPS.index(gaps))
    arrs = _batch(_seqs(rng, 6, 1, 80), _seqs(rng, 6, 1, 80))
    ref = _plain(arrs, matrix, *gaps)
    for nwd in NWDS:
        _assert_equal(xl_host(arrs, matrix, *gaps, nwd=nwd), ref)
