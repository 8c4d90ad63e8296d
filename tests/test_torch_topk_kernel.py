"""The top-k kernel ``csrc/minhash_topk.cu`` on the CPU: its source run as
threaded host C++ (the harness of ``tests/test_torch_harness.py``) against
the plain version, ``topk_graph._topk_block`` on a CPU tensor, and against
the JAX package's ``_topk_kernel``, entry for entry; and the wrapper's
routing, checks and counters.  The card's own tests of the kernel are in
``tests/test_torch_cuda.py``."""

import ctypes
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from test_torch_harness import build_host, ptr  # noqa: E402

from dynaalign_tpu.ops import topk_graph as jtopk  # noqa: E402

from dynaalign_torch.ops import _build, topk_cuda, topk_graph  # noqa: E402
from dynaalign_torch.utils import profiling  # noqa: E402

_HOST_SHIM = r"""
#define __shared__
#include "minhash_topk.cu"
#define DYN_WORDS (MH_SMEM_MAX / 4)
alignas(16) int mh_dyn[DYN_WORDS];

// The whole grid of one launch; hc <= 0 takes the launcher's stage slots.
// Returns the stage slots run, or -2 past a block's shared memory.
extern "C" int minhash_topk_host(const int* sig, int N, int H, int start,
                                 int stop, int k, int hc, int* cnt,
                                 int* idx) {
  if (hc <= 0) hc = mh_stage_slots(H, k);
  const size_t words = mh_smem_words(H, hc, k);
  if (words > DYN_WORDS) return -2;
  const int blocks = (stop - start + MH_RT - 1) / MH_RT;
  harness::launch(blocks, MH_THREADS, [&] {
    minhash_topk_kernel(sig, N, H, start, stop, k, hc, cnt, idx);
  }, mh_dyn, words);
  return hc;
}

// rows a block, columns a tile, threads a block
extern "C" void minhash_topk_consts(int* out) {
  out[0] = MH_RT;
  out[1] = MH_TC;
  out[2] = MH_THREADS;
}
"""


@pytest.fixture(scope="module")
def host_topk(tmp_path_factory):
    lib = build_host(tmp_path_factory.mktemp("topk_host"), "minhash_topk",
                     _HOST_SHIM)
    fn = lib.minhash_topk_host
    fn.restype = ctypes.c_int

    def run(sigs: np.ndarray, start: int, stop: int, k: int, hc: int = 0):
        bits = np.ascontiguousarray(sigs, np.uint32).view(np.int32)
        n, h = bits.shape
        cnt = np.full((stop - start, k), -7, np.int32)
        idx = np.full((stop - start, k), -7, np.int32)
        got = fn(ptr(bits), n, h, start, stop, k, hc, ptr(cnt), ptr(idx))
        assert got > 0, got
        return cnt, idx

    run.consts = np.zeros(3, np.int32)
    lib.minhash_topk_consts.restype = None
    lib.minhash_topk_consts(ptr(run.consts))
    return run


def _plain(sigs: np.ndarray, start: int, stop: int, k: int):
    t = torch.from_numpy(np.ascontiguousarray(sigs, np.uint32).view(np.int32))
    c, i = topk_graph._topk_block(t, start, stop, k)
    return c.numpy(), i.numpy()


def _jax(sigs: np.ndarray, start: int, stop: int, k: int):
    """The JAX package's ``_topk_kernel`` over every row in one block, cut
    to rows start:stop: (counts, indices), the row itself at count -1."""
    c, i = jtopk._topk_kernel(jnp.asarray(sigs, jnp.uint32), k=k,
                              block=len(sigs))
    return np.asarray(c)[start:stop], np.asarray(i)[start:stop]


def _tiny(seed, n, h, values=3):
    """Signatures from a tiny value set: equal counts everywhere."""
    return np.random.default_rng(seed).integers(
        0, values, size=(n, h)).astype(np.uint32)


def _sparse(seed, n, h, planted=40):
    """Distinct random signatures with a few rows copied slot by slot into
    others: most rows have fewer positive counts than k, so the lists end
    in columns of count 0."""
    rng = np.random.default_rng(seed)
    sigs = rng.integers(0, 2**32, size=(n, h), dtype=np.uint64).astype(
        np.uint32)
    for _ in range(planted):
        a, b = rng.integers(n, size=2)
        take = rng.random(h) < rng.random()
        sigs[b, take] = sigs[a, take]
    return sigs


def _rising(n, h):
    """Column j agrees with row i on min(p_i, p_j) slots, p rising with the
    index: every later column beats the lists so far, so each tile merges."""
    p = np.arange(n) * (h + 1) // n
    sigs = (np.arange(n, dtype=np.uint32)[:, None] * np.uint32(h)
            + np.arange(h, dtype=np.uint32)[None, :] + np.uint32(1000))
    sigs[np.arange(h)[None, :] < p[:, None]] = 7
    return sigs


CASES = {
    # name: (signatures, start, stop, k, stage slots (0: the launcher's))
    "ties_k1": (_tiny(1, 150, 8), 0, 150, 1, 0),
    "ties_k7": (_tiny(2, 150, 8), 0, 150, 7, 0),
    "ties_k32": (_tiny(3, 200, 6), 0, 200, 32, 0),
    "ties_k64": (_tiny(4, 260, 5), 0, 260, 64, 0),
    "ties_k_max": (_tiny(5, 300, 4), 0, 300, 256, 0),
    # a first tile leaves k + 1 keys: merged, or the next tile overflows
    "ties_k127": (_tiny(20, 300, 4), 0, 300, 127, 0),
    "ties_k_is_n_minus_1": (_tiny(6, 150, 8), 0, 150, 149, 0),
    "all_equal": (np.full((200, 5), 9, np.uint32), 0, 200, 32, 0),
    "n1": (_tiny(7, 1, 4), 0, 1, 1, 0),
    "n2": (_tiny(8, 2, 4), 0, 2, 1, 0),
    "n3_k2": (_tiny(9, 3, 4), 0, 3, 2, 0),
    "k_is_n": (_tiny(10, 40, 4), 0, 40, 40, 0),
    "zero_fill": (_sparse(11, 200, 50), 0, 200, 32, 0),
    "n_hash_1": (_tiny(12, 130, 1), 0, 130, 9, 0),
    "n_hash_50": (_tiny(13, 130, 50, values=2), 0, 130, 32, 0),
    "n_hash_255": (_tiny(14, 130, 255, values=2), 0, 130, 32, 0),
    "n_hash_255_all_equal": (np.zeros((70, 255), np.uint32), 0, 70, 16, 0),
    "start_offset": (_tiny(15, 300, 6), 70, 230, 16, 0),
    "start_to_end": (_tiny(16, 300, 6), 236, 300, 64, 0),
    "stage_chunks": (_tiny(17, 200, 50, values=2), 0, 200, 32, 16),
    "stage_chunk_of_one": (_tiny(18, 140, 3), 10, 90, 5, 1),
    "sign_bit": (_tiny(19, 150, 6) + np.uint32(0x7FFFFFFF), 0, 150, 4, 0),
    "rising": (_rising(300, 8), 0, 300, 8, 0),
    "rising_k_max": (_rising(400, 6), 0, 400, 256, 0),
}


@pytest.mark.parametrize("case", list(CASES))
def test_kernel_source_equals_plain(host_topk, case):
    """Counts and indices entry for entry, in the plain version's order,
    and the JAX package's: equal counts lowest index first, the zero fill,
    the row itself last at count -1 where k = N."""
    sigs, start, stop, k, hc = CASES[case]
    cnt, idx = host_topk(sigs, start, stop, k, hc)
    want_c, want_i = _plain(sigs, start, stop, k)
    np.testing.assert_array_equal(cnt, want_c)
    np.testing.assert_array_equal(idx, want_i)
    jax_c, jax_i = _jax(sigs, start, stop, k)
    np.testing.assert_array_equal(cnt, jax_c)
    np.testing.assert_array_equal(idx, jax_i)


def test_kernel_geometry_of_the_source(host_topk):
    """The design the source's comment states: 64 rows a block, tiles of
    128 columns, 256 threads, 16 x 16 of 4 rows by 8 columns."""
    rt, tc, threads = host_topk.consts.tolist()
    assert (rt, tc, threads) == (64, 128, 256)
    assert (rt // 4) * (tc // 8) == threads


def test_limits_are_the_sources():
    with open(f"{_build.CSRC}/minhash_topk.cu") as f:
        src = f.read()
    defines = dict(re.findall(r"#define (MH_\w+) (\d+)\b", src))
    assert topk_cuda.MAX_K == int(defines["MH_KMAX"]) == 256
    assert topk_cuda.MAX_N_HASH == int(defines["MH_HMAX"]) == 255
    assert topk_cuda.MAX_N == int(defines["MH_NMAX"]) == 2**24 - 1


@pytest.mark.parametrize("n, n_hash, k, takes", [
    (100_000, 50, 32, True),
    (100_000, 50, 256, True),
    (100_000, 50, 257, False),
    (100_000, 255, 32, True),
    (100_000, 256, 32, False),
    (1, 1, 1, True),
    (2**24 - 1, 50, 32, True),
    (2**24, 50, 32, False),
])
def test_kernel_takes_reads_k_n_hash_and_n(n, n_hash, k, takes):
    assert topk_cuda.kernel_takes(n, n_hash, k) is takes


@pytest.mark.parametrize("n, h", [(10, 50), (8, 300)])
def test_cpu_tensor_takes_the_plain_path(n, h):
    """On the CPU every call is the plain version's, in row blocks of
    ``block``: its rows count under topk.block.plain_rows, none under
    kernel_rows, also where the kernel's limits would take the call on a
    card, and nothing launches."""
    sigs = torch.from_numpy(_tiny(n, n, h).view(np.int32))
    profiling.reset()
    topk_graph._topk_block(sigs, 2, 7, 3, block=2)
    topk_graph.minhash_topk(sigs, k=3)
    c = profiling.counters()
    assert c["topk.block.plain_rows"] == 5 + n
    assert c["topk.block.kernel_rows"] == 0
    assert c["topk.block"] == 3 + 1
    assert "minhash_topk" not in c


@pytest.mark.parametrize("start, stop, block", [
    (0, 9, 1), (0, 9, 4), (3, 8, 2), (4, 4, None), (9, 9, 3)])
def test_plain_row_blocks_give_one_result(start, stop, block):
    """Whatever the row block, the plain path gives the rows of one block
    over start:stop, an empty range [0, k]."""
    sigs = torch.from_numpy(_tiny(4, 9, 5).view(np.int32))
    got_c, got_i = topk_graph._topk_block(sigs, start, stop, 4, block)
    want_c, want_i = topk_graph._topk_plain(sigs, start, stop, 4)
    assert got_c.shape == (stop - start, 4) and got_c.dtype == torch.int64
    assert torch.equal(got_c, want_c) and torch.equal(got_i, want_i)


@pytest.mark.parametrize("bad, match", [
    (lambda s: s.to(torch.int64), "int32"),
    (lambda s: s[0], "int32"),
    (lambda s: s[:, :, None], "int32"),
])
def test_check_raises_on_what_no_version_takes(bad, match):
    sigs = torch.from_numpy(_tiny(1, 8, 4).view(np.int32))
    with pytest.raises(ValueError, match=match):
        topk_graph._topk_block(bad(sigs), 0, 2, 1)


@pytest.mark.parametrize("start, stop, k, match", [
    (-1, 3, 2, "out of range"), (3, 2, 2, "out of range"),
    (0, 9, 2, "out of range"), (0, 8, 0, "k must"), (0, 8, 9, "k must"),
])
def test_check_raises_on_rows_and_k(start, stop, k, match):
    sigs = torch.from_numpy(_tiny(2, 8, 4).view(np.int32))
    profiling.reset()
    with pytest.raises(ValueError, match=match):
        topk_graph._topk_block(sigs, start, stop, k)
    assert "topk.block" not in profiling.counters()


@pytest.mark.parametrize("n, n_hash, k", [
    (300, 4, 257), (8, 256, 2), (2**24, 1, 1)])
def test_kernel_wrapper_raises_past_its_limits(n, n_hash, k):
    """Past the kernel's limits topk_rows raises before a launch (and
    before the library is built): no other version runs on the card."""
    sigs = torch.zeros((1, n_hash), dtype=torch.int32).expand(n, n_hash)
    profiling.reset()
    with pytest.raises(ValueError, match="device='cpu' takes any"):
        topk_cuda.topk_rows(sigs, 0, 1, k)
    assert "minhash_topk" not in profiling.counters()
