"""The port's batched NW (plain version, kernel source, wrapper, dispatch,
build) against the JAX package and the C++ oracle, on the CPU.

Every comparison is exact: the reference is bit-exact.
"""

import ctypes
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from dynaalign_tpu import blosum as jblosum  # noqa: E402
from dynaalign_tpu import oracle as joracle  # noqa: E402
from dynaalign_tpu.ops.nw import nw_similarity_batch as jax_scan  # noqa: E402
from dynaalign_tpu.ops.nw_pallas import (  # noqa: E402
    nw_similarity_batch_pallas,
)
from test_torch_harness import build_host, ptr  # noqa: E402

from dynaalign_torch import blosum  # noqa: E402
from dynaalign_torch.encode import ALPHABET, encode  # noqa: E402
from dynaalign_torch.ops import (  # noqa: E402
    MAX_MP1,
    _build,
    nw_batch,
    nw_batch_tiled,
    nw_cuda,
    pick_nw_backend,
)
from dynaalign_torch.ops.nw import NWResult, nw_similarity_batch  # noqa: E402
from dynaalign_torch.utils import profiling  # noqa: E402

AA20 = "ARNDCQEGHILKMFPSTWYV"
GAPS = [(10, 4), (5, 1), (12, 2)]


@pytest.fixture(scope="module", autouse=True)
def _few_intra_op_threads():
    """At most 4 intra-op threads while this module runs: the host harness
    runs a std::thread per CUDA thread with a barrier a step, and stalls
    while torch's thread pools of this and other workers hold the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


def _seqs(rng, n, lo, hi, alphabet=ALPHABET):
    return ["".join(rng.choice(list(alphabet), size=k))
            for k in rng.integers(lo, hi + 1, size=n)]


def _batch(a_seqs, b_seqs, pad_a=None, pad_b=None):
    """numpy int32 (a, a_len, b, b_len), PAD_ID-padded."""
    ea, eb = encode(a_seqs, pad_to=pad_a), encode(b_seqs, pad_to=pad_b)
    return ea.indices, ea.lengths, eb.indices, eb.lengths


def _port(arrs, matrix="BLOSUM62", go=10, ge=4):
    t = [torch.from_numpy(x) for x in arrs]
    sub = blosum.from_numpy(jblosum.get_matrix(matrix), "cpu")
    res = nw_similarity_batch(*t, sub, gap_open=go, gap_ext=ge)
    return res.matches.numpy(), res.length.numpy()


def _jax(fn, arrs, matrix="BLOSUM62", go=10, ge=4, **kw):
    res = fn(*[jnp.asarray(x) for x in arrs],
             jnp.asarray(jblosum.get_matrix(matrix)),
             gap_open=go, gap_ext=ge, **kw)
    return np.asarray(res.matches), np.asarray(res.length)


def _oracle(pairs, matrix="BLOSUM62", go=10, ge=4):
    return np.array([joracle.nw_pair(a, b, matrix, go, ge) for a, b in pairs])


@pytest.mark.parametrize("gaps", GAPS)
@pytest.mark.parametrize("matrix", jblosum.MATRIX_NAMES)
def test_plain_equals_jax_scan_and_pallas(matrix, gaps):
    """12-80 aa fuzz, pad 87 (m+1 = 88, sublane-aligned for Pallas)."""
    go, ge = gaps
    rng = np.random.default_rng(
        10 * jblosum.MATRIX_NAMES.index(matrix) + GAPS.index(gaps))
    seqs = _seqs(rng, 16, 12, 80)
    arrs = _batch(seqs[:8], seqs[8:], 87, 87)
    got = _port(arrs, matrix, go, ge)
    for ref in (
        _jax(jax_scan, arrs, matrix, go, ge),
        _jax(nw_similarity_batch_pallas, arrs, matrix, go, ge,
             interpret=True),
    ):
        np.testing.assert_array_equal(got[0], ref[0])
        np.testing.assert_array_equal(got[1], ref[1])


@pytest.mark.parametrize("case", ["ambiguity", "length1", "unequal"])
def test_plain_equals_oracle(case):
    """B/Z/X/* codes, length-1 sequences, and m != n padded widths."""
    rng = np.random.default_rng(7)
    if case == "ambiguity":
        a = _seqs(rng, 12, 5, 40, "BZX*AR")
        b = _seqs(rng, 12, 5, 40, "BZX*ND")
    elif case == "length1":
        a = ["A", "W", "*", "B", "AR", "W"] + _seqs(rng, 4, 1, 3)
        b = ["A", "A", "*", "WWWW", "R", "CWC"] + _seqs(rng, 4, 1, 3)
    else:
        a = _seqs(rng, 10, 3, 20)
        b = _seqs(rng, 10, 30, 70)
    mt, ln = _port(_batch(a, b, None, 75 if case == "unequal" else None))
    sims = NWResult(torch.from_numpy(mt), torch.from_numpy(ln)).similarity()
    np.testing.assert_array_equal(sims, _oracle(list(zip(a, b))))


def test_unequal_widths_equal_jax_scan():
    rng = np.random.default_rng(3)
    arrs = _batch(_seqs(rng, 6, 1, 30), _seqs(rng, 6, 40, 90), 31, 95)
    for got, ref in zip(_port(arrs, "BLOSUM80", 5, 1),
                        _jax(jax_scan, arrs, "BLOSUM80", 5, 1)):
        np.testing.assert_array_equal(got, ref)


def test_empty_pair_is_nan_like_jax():
    arrs = (np.full((2, 3), 24, np.int32), np.array([0, 0], np.int32),
            np.full((2, 3), 24, np.int32), np.array([0, 2], np.int32))
    arrs[2][1, :2] = [0, 1]
    got, ref = _port(arrs), _jax(jax_scan, arrs)
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[1], ref[1])
    sims = NWResult(*[torch.from_numpy(x) for x in got]).similarity()
    assert np.isnan(sims[0]) and sims[1] == 0.0
    assert sims.dtype == np.float64


# The kernel source compiled as host C++ and run threaded (the harness of
# tests/test_torch_harness.py): every instantiation of NW_INSTANCES, with
# its dynamic shared memory sized by the source's own function.  This checks
# the kernel's DP arithmetic and its warp hand-offs here, where no nvcc
# exists.
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


@pytest.mark.parametrize("inst", INSTANCE_IDS)
def test_kernel_source_equals_oracle_on_h3n2(host_kernel, inst):
    from dynaalign_torch.io.datasets import load_sequences

    seqs = load_sequences("h3n2sample", 4 if inst < 2 else 8)
    k = len(seqs)
    pairs = [(seqs[i], seqs[j]) for i in range(k) for j in range(i, k)]
    arrs = _batch([p[0] for p in pairs], [p[1] for p in pairs])
    mt, ln = host_kernel(arrs, jblosum.get_matrix("BLOSUM62"), 10, 4, inst)
    with np.errstate(invalid="ignore", divide="ignore"):
        sims = mt.astype(np.float64) / ln
    np.testing.assert_array_equal(sims, _oracle(pairs))


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


def test_kernel_source_two_strips_at_full_width(host_kernel):
    """The last instantiation over two strips with the widest padded b
    (N = 1,119): 577-640 rows x 1,000-1,119 columns, m != n."""
    rng = np.random.default_rng(80)
    arrs = _batch(_seqs(rng, 2, 577, 640), _seqs(rng, 2, 1000, MAX_MP1 - 1),
                  None, MAX_MP1 - 1)
    assert nw_cuda.pick_instance(int(arrs[1].max())) == INSTANCE_IDS[-1]
    _assert_source_equals_plain(host_kernel, arrs, "BLOSUM62", 10, 4, None)


def test_dispatch_routes_by_device():
    """CPU -> the plain version; on a card nw_gotoh up to padded
    max(m, n)+1 = MAX_MP1, nw_gotoh_xl past it, at any width (past the TPU
    kernel's 12,288 and its 32,767 packing budget too), never raising."""
    assert pick_nw_backend("cpu", 5000, 5000) == "torch"
    assert pick_nw_backend("cpu", 20_000, 30) == "torch"
    assert pick_nw_backend("cuda", 566, 566) == "cuda"
    assert pick_nw_backend(torch.device("cuda", 0), MAX_MP1 - 1, 15) == "cuda"
    assert pick_nw_backend("cuda", MAX_MP1 - 1, MAX_MP1 - 1) == "cuda"
    assert pick_nw_backend("cuda", MAX_MP1, MAX_MP1) == "cuda_xl"
    assert pick_nw_backend("cuda", 15, MAX_MP1) == "cuda_xl"
    assert pick_nw_backend("cuda", MAX_MP1, 15) == "cuda_xl"
    for width in (12_287, 12_288, 16_407, 40_000):
        assert pick_nw_backend("cuda", width, width) == "cuda_xl"
    assert pick_nw_backend("cuda", 12_300, 17_000) == "cuda_xl"


def test_nw_batch_and_tiled_on_cpu_equal_plain():
    rng = np.random.default_rng(5)
    arrs = _batch(_seqs(rng, 6, 2, 30), _seqs(rng, 6, 2, 30), 31, 31)
    t = [torch.from_numpy(x) for x in arrs]
    sub = blosum.get_matrix("BLOSUM50")
    ref = nw_similarity_batch(*t, sub)
    got = nw_batch(*t, sub)
    tiled = nw_batch_tiled(*[x.reshape(2, 3, *x.shape[1:]) for x in t], sub)
    assert tiled.matches.shape == (2, 3)
    for res in (got, NWResult(tiled.matches.reshape(-1),
                              tiled.length.reshape(-1))):
        assert torch.equal(res.matches, ref.matches)
        assert torch.equal(res.length, ref.length)


def test_wrapper_on_cpu_runs_plain_without_launching():
    rng = np.random.default_rng(6)
    t = [torch.from_numpy(x)
         for x in _batch(_seqs(rng, 4, 1, 20), _seqs(rng, 4, 1, 20))]
    sub = blosum.get_matrix()
    profiling.reset()
    got = nw_cuda.nw_similarity_batch_cuda(*t, sub, gap_open=5, gap_ext=1)
    ref = nw_similarity_batch(*t, sub, gap_open=5, gap_ext=1)
    assert "nw_gotoh" not in profiling.counters()
    assert torch.equal(got.matches, ref.matches)
    assert torch.equal(got.length, ref.length)


def _good():
    a = torch.zeros((4, 6), dtype=torch.int32)
    n = torch.full((4,), 6, dtype=torch.int32)
    return [a, n, a.clone(), n.clone(), blosum.get_matrix()]


@pytest.mark.parametrize("bad, err", [
    (lambda x: x.__setitem__(0, x[0].long()), TypeError),
    (lambda x: x.__setitem__(1, x[1][:3]), ValueError),
    (lambda x: x.__setitem__(2, x[2].t().contiguous().t()), ValueError),
    (lambda x: x.__setitem__(2, x[2][:2]), ValueError),
    (lambda x: x.__setitem__(4, x[4][:24, :24].contiguous()), ValueError),
    (lambda x: x.__setitem__(0, x[0].numpy()), TypeError),
    (lambda x: x[1].__setitem__(2, 7), ValueError),  # a_len > M
    (lambda x: x[3].__setitem__(0, 7), ValueError),  # b_len > N
    (lambda x: x[1].__setitem__(3, -1), ValueError),
    (lambda x: x[3].__setitem__(1, -1), ValueError),
    (lambda x: x[4].__setitem__((0, 0), 128), ValueError),  # past int8
    (lambda x: x[4].__setitem__((3, 5), -129), ValueError),
    (lambda x: x[0].__setitem__((1, 2), 25), ValueError),  # past PAD
    (lambda x: x[2].__setitem__((3, 0), -1), ValueError),
])
def test_wrapper_rejects_bad_inputs(bad, err):
    args = _good()
    bad(args)
    with pytest.raises(err):
        nw_cuda.nw_similarity_batch_cuda(*args)


@pytest.mark.parametrize("gaps", [(-1, 4), (10, -1), ((1 << 20) + 1, 4)])
def test_wrapper_rejects_gaps_out_of_range(gaps):
    """The kernels' sentinel arithmetic is proven for gaps in [0, 2**20]."""
    with pytest.raises(ValueError, match="gap penalties"):
        nw_cuda.nw_similarity_batch_cuda(*_good(), gap_open=gaps[0],
                                         gap_ext=gaps[1])
    with pytest.raises(ValueError, match="gap penalties"):
        nw_cuda.nw_similarity_batch_cuda_xl(*_good(), gap_open=gaps[0],
                                            gap_ext=gaps[1])


def test_wrapper_rejects_other_devices():
    args = [x.to("meta") for x in _good()]
    with pytest.raises(ValueError, match="no NW kernel"):
        nw_cuda.nw_similarity_batch_cuda(*args)
    with pytest.raises(ValueError, match="no NW kernel"):
        nw_batch(*args)


def test_launch_pointers_are_void_p():
    """ctypes passes an undeclared int as 32 bits and cuts a pointer."""
    # nw_gotoh_xl: path words, the work table and its length, scratch,
    # queue counter, progress words, outputs, stream
    types = nw_cuda.LAUNCH_ARGTYPES
    assert len(types) == 19
    for i in (0, 1, 2, 3, 4, 11, 13, 14, 15, 16, 17, 18):
        assert types[i] is ctypes.c_void_p
    for i in (*range(5, 11), 12):
        assert types[i] is ctypes.c_int
    types = nw_cuda.LAUNCH_ARGTYPES_NW  # nw_gotoh: instance, a_max, no scratch
    assert len(types) == 15
    for i in (0, 1, 2, 3, 4, 12, 13, 14):
        assert types[i] is ctypes.c_void_p
    for i in range(5, 12):
        assert types[i] is ctypes.c_int


def test_build_targets_hopper_and_hashes_source(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "nvcc_path", lambda: "nvcc")
    names = _build.sources()
    assert names == ["minhash_topk", "nw_gotoh", "nw_gotoh_xl", "probe_shift"]
    targets = [_build.target(name) for name in names]
    assert len(set(targets)) == len(names)  # each source its own library
    for name, tgt in zip(names, targets):
        assert os.path.basename(tgt).startswith(f"{name}-")
        cmd = _build.nvcc_command(name, "out.so")
        assert "arch=compute_90a,code=sm_90a" in cmd
        assert cmd[-1] == os.path.join(_build.CSRC, f"{name}.cu")
    monkeypatch.setattr(_build, "CSRC", str(tmp_path))
    src = tmp_path / "k.cu"
    src.write_text("// v1\n")
    first = _build.target("k")
    src.write_text("// v2\n")
    second = _build.target("k")
    assert second != first
    header = tmp_path / "cell.cuh"  # any csrc/*.cuh may be included
    header.write_text("// h1\n")
    third = _build.target("k")
    header.write_text("// h2\n")
    assert len({first, second, third, _build.target("k")}) == 4
    (tmp_path / "notes.txt").write_text("not a header\n")
    assert _build.target("k") == _build.target("k") != third
    header.write_text("// h1\n")
    assert _build.target("k") == third
    assert os.path.dirname(first) == _build.BUILD_DIR
    cmd = _build.nvcc_command("k", "out.so")
    assert "arch=compute_90a,code=sm_90a" in cmd
    for flag in ("-std=c++17", "-O3", "-shared", "-fPIC"):
        assert flag in cmd


_FAKE_NVCC = """#!/bin/sh
# writes its -o file after a pause; fails on a source named bad.cu
out=""; prev=""
for a in "$@"; do [ "$prev" = "-o" ] && out="$a"; prev="$a"; done
sleep 1
case "$a" in *bad.cu) echo "bad.cu(1): error"; exit 1;; esac
echo "ptxas info: built $a"
echo lib > "$out"
"""


def test_build_all_runs_nvcc_in_parallel_and_raises(tmp_path, monkeypatch):
    import time

    nvcc = tmp_path / "nvcc"
    nvcc.write_text(_FAKE_NVCC)
    nvcc.chmod(0o755)
    csrc, build_dir = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    for name in ("a", "b", "c"):
        (csrc / f"{name}.cu").write_text(f"// {name}\n")
    monkeypatch.setattr(_build, "nvcc_path", lambda: str(nvcc))
    monkeypatch.setattr(_build, "CSRC", str(csrc))
    monkeypatch.setattr(_build, "BUILD_DIR", str(build_dir))
    t0 = time.perf_counter()
    built = _build.build_all()
    assert time.perf_counter() - t0 < 2.5  # three 1 s builds, together
    assert sorted(built) == ["a", "b", "c"]
    for name, b in built.items():
        assert b.path == _build.target(name) and os.path.exists(b.path)
        assert f"{name}.cu" in b.log
    assert all(b.log == "" for b in _build.build_all().values())  # reused
    (csrc / "bad.cu").write_text("// bad\n")
    (csrc / "a.cu").write_text("// a, edited\n")
    with pytest.raises(RuntimeError, match="nvcc failed on bad.cu"):
        _build.build_all()
    assert os.path.exists(_build.target("a"))  # the others still finished
    assert not any(f.endswith(".tmp") for f in os.listdir(build_dir)
                   if "a-" in f)


def test_build_without_nvcc_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc_path()
