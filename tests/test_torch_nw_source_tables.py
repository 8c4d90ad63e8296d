"""The ``nw_gotoh`` kernel source as threaded host C++, against the plain
version and the C++ oracle: h3n2 through every instantiation but 2, two
strips at the widest padded b, a table that is not symmetric, tie-heavy
sequences under BLOSUM45, and every table and gap setting.  The shim, the
fixture and why the checks fill two files, costliest first:
``test_torch_nw_source.py``.

Every comparison is exact: the reference is bit-exact.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from dynaalign_tpu import blosum as jblosum  # noqa: E402
# _few_intra_op_threads: test_torch_nw.py's cap on torch's threads, here too
from test_torch_nw import (  # noqa: E402, F401
    GAPS,
    _batch,
    _few_intra_op_threads,
    _oracle,
    _seqs,
)
from test_torch_nw_source import (  # noqa: E402, F401
    H3N2_HERE,
    INSTANCE_IDS,
    _assert_source_equals_plain,
    _equals_oracle_on_h3n2,
    host_kernel,
)

from dynaalign_torch.ops import MAX_MP1, nw_cuda  # noqa: E402
from dynaalign_torch.ops.nw import nw_similarity_batch  # noqa: E402


@pytest.mark.parametrize(
    "inst", [i for i in INSTANCE_IDS if i not in H3N2_HERE])
def test_kernel_source_equals_oracle_on_h3n2(host_kernel, inst):
    _equals_oracle_on_h3n2(host_kernel, inst)


def test_kernel_source_two_strips_at_full_width(host_kernel):
    """The last instantiation over two strips with the widest padded b
    (N = 1,119): 577-640 rows x 1,000-1,119 columns, m != n."""
    rng = np.random.default_rng(80)
    arrs = _batch(_seqs(rng, 2, 577, 640), _seqs(rng, 2, 1000, MAX_MP1 - 1),
                  None, MAX_MP1 - 1)
    assert nw_cuda.pick_instance(int(arrs[1].max())) == INSTANCE_IDS[-1]
    _assert_source_equals_plain(host_kernel, arrs, "BLOSUM62", 10, 4, None)


@pytest.mark.parametrize("inst", INSTANCE_IDS)
def test_kernel_source_reads_table_row_a_column_b(host_kernel, inst):
    """A table that is not symmetric: the score of a cell is sub[a_i][b_j],
    as in the plain version, not sub[b_j][a_i]."""
    g, r = nw_cuda.INSTANCES[inst]
    rng = np.random.default_rng(90 + inst)
    sub_np = np.array(jblosum.get_matrix("BLOSUM50"), np.int32)
    sub_np[:24, :24] += rng.integers(-3, 4, size=(24, 24), dtype=np.int32)
    assert (sub_np != sub_np.T).any()
    arrs = _batch(_seqs(rng, 40, 1, min(2 * g * r + 3, 120)),
                  _seqs(rng, 40, 1, 50))
    got = host_kernel(arrs, sub_np, 12, 2, inst)
    ref = nw_similarity_batch(*[torch.from_numpy(x) for x in arrs],
                              torch.from_numpy(sub_np), gap_open=12,
                              gap_ext=2)
    np.testing.assert_array_equal(got[0], ref.matches.numpy())
    np.testing.assert_array_equal(got[1], ref.length.numpy())
    flipped = host_kernel(arrs, sub_np.T, 12, 2, inst)
    assert (flipped[0] != got[0]).any() or (flipped[1] != got[1]).any()


@pytest.mark.parametrize("inst", INSTANCE_IDS)
def test_kernel_source_tie_heavy(host_kernel, inst):
    """Low-complexity sequences under BLOSUM45 with gaps (5, 1): many cells
    where diag == ix, diag == iy or ix == iy, so that a > in place of a >=
    in the D > U > L order changes the path."""
    rng = np.random.default_rng(70 + inst)
    hi = min(nw_cuda.INSTANCES[inst][0] * nw_cuda.INSTANCES[inst][1] + 9, 90)
    a = _seqs(rng, 32, 1, hi, "AAG")
    b = _seqs(rng, 32, 1, 60, "AGG")
    arrs = _batch(a, b)
    _assert_source_equals_plain(host_kernel, arrs, "BLOSUM45", 5, 1, inst)
    mt, ln = host_kernel(arrs, jblosum.get_matrix("BLOSUM45"), 5, 1, inst)
    with np.errstate(invalid="ignore", divide="ignore"):
        np.testing.assert_array_equal(
            mt.astype(np.float64) / ln,
            _oracle(list(zip(a, b)), "BLOSUM45", 5, 1))


@pytest.mark.parametrize("gaps", GAPS)
@pytest.mark.parametrize("matrix", jblosum.MATRIX_NAMES)
def test_kernel_source_equals_plain_tables_and_gaps(host_kernel, matrix,
                                                    gaps):
    """All six tables x three gap settings, each batch through the
    instantiation the wrapper picks for it (1-40 aa: the first three)."""
    rng = np.random.default_rng(
        20 + 3 * jblosum.MATRIX_NAMES.index(matrix) + GAPS.index(gaps))
    hi = (12, 32, 40)[GAPS.index(gaps)]
    arrs = _batch(_seqs(rng, 20, 1, hi), _seqs(rng, 20, 1, 40))
    _assert_source_equals_plain(host_kernel, arrs, matrix, *gaps, None)
