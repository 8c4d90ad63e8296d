"""The ``nw_gotoh`` kernel source compiled as host C++ and run threaded (the
harness of ``tests/test_torch_harness.py``): every instantiation of
NW_INSTANCES, with its dynamic shared memory sized by the source's own
function, against the plain version and the C++ oracle.  This checks the
kernel's DP arithmetic and its warp hand-offs here, where no nvcc exists.
Here: the shim and its fixture, the instantiations the wrapper reads, h3n2
through instantiation 2, 1-4 columns, a_len at and beside a strip's
capacity, and fuzz through every instantiation.  The rest is in
``test_torch_nw_source_tables.py``, which imports the shim and the fixture.

Two files, and their order of tests: ``--dist loadfile`` runs a file on one
worker, in order, and hands out files with more tests first.  The harness
(a thread per CUDA thread, a barrier a shuffle) slows by one to two orders
of magnitude beside other workers' torch thread pools, worst beside the
small files that go last.  So the checks fill two files of about 30 tests,
each costliest first.  The h3n2 check is cut by its cases: instantiation 2
(36 pairs, five strips each) is the longest and runs here, the others in
the tables file.

Every comparison is exact: the reference is bit-exact.
"""

import ctypes
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from dynaalign_tpu import blosum as jblosum  # noqa: E402
from test_torch_harness import build_host, ptr  # noqa: E402
# _few_intra_op_threads: test_torch_nw.py's cap on torch's threads, here too
from test_torch_nw import (  # noqa: E402, F401
    _batch,
    _few_intra_op_threads,
    _oracle,
    _port,
    _seqs,
)

from dynaalign_torch.encode import ALPHABET  # noqa: E402
from dynaalign_torch.ops import MAX_MP1, _build, nw_cuda  # noqa: E402

_HOST_SHIM = r"""
#define __shared__
#include "nw_gotoh.cu"
// past the card's 227 KB: here a short-strip instantiation also runs long
// pairs, which the wrapper never sends it
#define DYN_WORDS (1 << 20)
alignas(16) int nw_dyn[DYN_WORDS];

template <int G, int R>
static int run_as(const int* a_idx, const int* a_len, const int* b_idx,
                  const int* b_len, const int* sub, int B, int M, int N,
                  int go, int ge, int a_max, int* mt, int* ln) {
  int bnd_cols;
  const size_t words = nw_gotoh_smem_words<G, R>(a_max, N, &bnd_cols);
  if (words > DYN_WORDS) return -2;
  const int pairs = NW_THREADS / G;
  harness::launch((B + pairs - 1) / pairs, NW_THREADS, [&] {
    nw_gotoh_kernel<G, R>(a_idx, a_len, b_idx, b_len, sub, B, M, N, go, ge,
                          bnd_cols, mt, ln);
  }, nw_dyn, words);
  return 0;
}

extern "C" int nw_gotoh_host(const int* a_idx, const int* a_len,
    const int* b_idx, const int* b_len, const int* sub, int B, int M, int N,
    int go, int ge, int inst, int a_max, int* mt, int* ln) {
  switch (inst) {
#define CASE(I, G, R) case I: return run_as<G, R>(a_idx, a_len, b_idx, \
    b_len, sub, B, M, N, go, ge, a_max, mt, ln);
    NW_INSTANCES(CASE)
  }
  return -1;
}
"""

INSTANCE_IDS = list(range(len(nw_cuda.INSTANCES)))
H3N2_HERE = [2]  # the h3n2 cases of this file; the others: the tables file


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    fn = build_host(tmp_path_factory.mktemp("nw_host"), "nw_gotoh",
                    _HOST_SHIM).nw_gotoh_host
    fn.restype = ctypes.c_int

    def run(arrs, sub_np, go, ge, inst=None):
        """Through instantiation ``inst``; None: the one the wrapper would
        pick for the batch."""
        a, la, b, lb = [np.ascontiguousarray(x, np.int32) for x in arrs]
        bsz, m = a.shape
        n = b.shape[1]
        # the kernel takes the table transposed
        sub_c = np.ascontiguousarray(np.asarray(sub_np).T, np.int32)
        a_max = int(la.max()) if bsz else 0
        if inst is None:
            inst = nw_cuda.pick_instance(a_max)
        mt, ln = np.full(bsz, -7, np.int32), np.full(bsz, -7, np.int32)
        rc = fn(ptr(a), ptr(la), ptr(b), ptr(lb), ptr(sub_c), bsz, m, n, go,
                ge, inst, a_max, ptr(mt), ptr(ln))
        assert rc == 0, rc
        return mt, ln

    return run


def _assert_source_equals_plain(host_kernel, arrs, matrix, go, ge, inst):
    got = host_kernel(arrs, jblosum.get_matrix(matrix), go, ge, inst)
    ref = _port(arrs, matrix, go, ge)
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[1], ref[1])


def _equals_oracle_on_h3n2(host_kernel, inst):
    from dynaalign_torch.io.datasets import load_sequences

    seqs = load_sequences("h3n2sample", 4 if inst < 2 else 8)
    k = len(seqs)
    pairs = [(seqs[i], seqs[j]) for i in range(k) for j in range(i, k)]
    arrs = _batch([p[0] for p in pairs], [p[1] for p in pairs])
    mt, ln = host_kernel(arrs, jblosum.get_matrix("BLOSUM62"), 10, 4, inst)
    with np.errstate(invalid="ignore", divide="ignore"):
        sims = mt.astype(np.float64) / ln
    np.testing.assert_array_equal(sims, _oracle(pairs))


def test_instances_mirror_the_source():
    """ops/nw_cuda.py's INSTANCES, which it reads from csrc/nw_gotoh.cu's
    NW_INSTANCES, is that list, in order of capacity, and pick_instance
    takes the first that holds a_max."""
    import re

    with open(os.path.join(_build.CSRC, "nw_gotoh.cu")) as f:
        src = f.read().replace("\\\n", " ")
    line = re.search(r"#define NW_INSTANCES\(X\)(.*)", src).group(1)
    found = [tuple(map(int, t)) for t in
             re.findall(r"X\((\d+), (\d+), (\d+)\)", line)]
    assert [(k, *gr) for k, gr in enumerate(nw_cuda.INSTANCES)] == found
    caps = [g * r for g, r in nw_cuda.INSTANCES]
    assert caps == sorted(set(caps)) and 64 % max(
        g for g, _ in nw_cuda.INSTANCES) == 0
    assert 2 * caps[-1] >= MAX_MP1 - 1  # two strips reach the widest pair
    for k, cap in enumerate(caps):
        assert nw_cuda.pick_instance(cap) == k
        assert nw_cuda.pick_instance(cap + 1) == min(k + 1, len(caps) - 1)
    assert nw_cuda.pick_instance(0) == 0
    assert nw_cuda.pick_instance(MAX_MP1 - 1) == len(caps) - 1


@pytest.mark.parametrize("inst", H3N2_HERE)
def test_kernel_source_equals_oracle_on_h3n2(host_kernel, inst):
    _equals_oracle_on_h3n2(host_kernel, inst)


@pytest.mark.parametrize("inst", INSTANCE_IDS)
def test_kernel_source_narrow_columns(host_kernel, inst):
    """1-4 columns: the traceback turns at column 1, where each row takes
    its diagonal from the column-0 border; rows over one to three strips."""
    g, r = nw_cuda.INSTANCES[inst]
    cap = g * r
    rng = np.random.default_rng(60 + inst)
    arrs = _batch(_seqs(rng, 24, max(1, cap // 2), 2 * cap + cap // 2),
                  _seqs(rng, 24, 1, 4))
    _assert_source_equals_plain(host_kernel, arrs, "BLOSUM80", 5, 1, inst)


@pytest.mark.parametrize("inst", INSTANCE_IDS)
def test_kernel_source_capacity_edges(host_kernel, inst):
    """a_len at the strip's capacity G * R and one to either side (the last
    needs a second strip), at two strips and beyond, beside empty sides,
    the empty pair and length 1; 7 pairs leave most of the last block's
    groups idle."""
    g, r = nw_cuda.INSTANCES[inst]
    cap = g * r
    rng = np.random.default_rng(50 + inst)
    a_lens = [cap - 1, cap, cap + 1, 2 * cap, 2 * cap + 1, 0, 5, 0, 1, r,
              r + 1]
    b_lens = [12, 40, 3, 17, 9, 7, 0, 0, 1, 30, 2]
    a = ["".join(rng.choice(list(ALPHABET), size=k)) for k in a_lens]
    b = ["".join(rng.choice(list(ALPHABET), size=k)) for k in b_lens]
    arrs = _batch(a, b, 2 * cap + 3, 45)
    got = host_kernel(arrs, jblosum.get_matrix("BLOSUM62"), 10, 4, inst)
    ref = _port(arrs)
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[1], ref[1])
    assert list(got[0][5:8]) == [0, 0, 0] and list(got[1][5:8]) == [7, 5, 0]
    part = tuple(x[:7] for x in arrs)
    _assert_source_equals_plain(host_kernel, part, "BLOSUM62", 10, 4, inst)


@pytest.mark.parametrize("inst", INSTANCE_IDS)
@pytest.mark.parametrize("case", [
    ("BLOSUM62", (10, 4), 12, 80, 12, 80),
    ("BLOSUM45", (5, 1), 1, 40, 1, 40),
    ("BLOSUM100", (12, 2), 1, 3, 30, 70),  # m != n, length-1 rows
    ("BLOSUM90", (10, 4), 50, 90, 1, 10),
])
def test_kernel_source_equals_plain(host_kernel, case, inst):
    """Every instantiation runs every batch: one whose strip is shorter
    than a pair takes several strips."""
    matrix, (go, ge), alo, ahi, blo, bhi = case
    rng = np.random.default_rng(11)
    arrs = _batch(_seqs(rng, 24, alo, ahi), _seqs(rng, 24, blo, bhi))
    _assert_source_equals_plain(host_kernel, arrs, matrix, go, ge, inst)
