"""The port on the card: the CUDA kernels (nw_gotoh, nw_gotoh_xl,
probe_shift) against their plain versions and the C++ oracle, and the
MinHash, top-k, clustering and hybrid entry points against the oracle and
their own ``device="cpu"`` results.  Without a card every test skips.  On a machine with one (and no JAX, whose import in
conftest.py would fail):

    python -m pytest --noconftest -m gpu tests/test_torch_cuda.py
"""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from dynaalign_torch import blosum, oracle, similarity_nw  # noqa: E402
from dynaalign_torch import nw_rescore_pairs  # noqa: E402
from dynaalign_torch import similarity_nw_bucketed  # noqa: E402
from dynaalign_torch.encode import ALPHABET, encode  # noqa: E402
from dynaalign_torch.io.datasets import load_sequences  # noqa: E402
from dynaalign_torch.ops import MAX_MP1, nw_batch, nw_cuda  # noqa: E402
from dynaalign_torch.ops.nw import nw_similarity_batch  # noqa: E402
from dynaalign_torch.ops import topk_cuda  # noqa: E402
from dynaalign_torch.ops.topk_graph import _topk_block  # noqa: E402
from dynaalign_torch.utils import profiling  # noqa: E402
from test_torch_topk_kernel import _rising, _sparse, _tiny  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _batch(dev, seed, n, alo, ahi, blo, bhi, pad_a=None, pad_b=None,
           letters=(ALPHABET, ALPHABET)):
    rng = np.random.default_rng(seed)

    def seqs(lo, hi, alphabet):
        return ["".join(rng.choice(list(alphabet), size=k))
                for k in rng.integers(lo, hi + 1, size=n)]

    ea = encode(seqs(alo, ahi, letters[0]), pad_to=pad_a)
    eb = encode(seqs(blo, bhi, letters[1]), pad_to=pad_b)
    return [torch.from_numpy(x).to(dev)
            for x in (ea.indices, ea.lengths, eb.indices, eb.lengths)]


def _assert_kernel_equals_plain(args, sub, go=10, ge=4,
                                wrapper=nw_cuda.nw_similarity_batch_cuda):
    got = wrapper(*args, sub, gap_open=go, gap_ext=ge)
    ref = nw_similarity_batch(*args, sub, gap_open=go, gap_ext=ge)
    torch.cuda.synchronize()
    assert torch.equal(got.matches, ref.matches)
    assert torch.equal(got.length, ref.length)


@pytest.mark.parametrize("gaps", [(10, 4), (5, 1), (12, 2)])
@pytest.mark.parametrize("matrix", blosum.MATRIX_NAMES)
def test_kernel_equals_plain_fuzz(cuda, matrix, gaps):
    args = _batch(cuda, 1, 1000, 1, 80, 1, 80)
    _assert_kernel_equals_plain(args, blosum.get_matrix(matrix, device=cuda),
                                *gaps)


@pytest.mark.parametrize("shape", [
    (300, 1, 40, 200, 566),  # m != n
    (300, 500, 566, 1, 30),
    (64, 1000, MAX_MP1 - 1, 900, MAX_MP1 - 1),  # the largest padded width
])
def test_kernel_equals_plain_shapes(cuda, shape):
    n, alo, ahi, blo, bhi = shape
    args = _batch(cuda, 2, n, alo, ahi, blo, bhi)
    _assert_kernel_equals_plain(args, blosum.get_matrix(device=cuda))


@pytest.mark.parametrize("inst", range(len(nw_cuda.INSTANCES)))
def test_kernel_instances_equal_plain(cuda, inst):
    """Each instantiation of nw_gotoh at its strip's capacity (the longest
    a_len picks it), on 1-4 columns and on a tie-heavy low-complexity
    batch under BLOSUM45 with gaps (5, 1)."""
    g, r = nw_cuda.INSTANCES[inst]
    cap = g * r
    lo = 1 + (nw_cuda.INSTANCES[inst - 1][0] * nw_cuda.INSTANCES[inst - 1][1]
              if inst else 0)
    sub = blosum.get_matrix("BLOSUM45", device=cuda)
    for seed, blo, bhi, letters in ((10, 1, 90, (ALPHABET, ALPHABET)),
                                    (11, 1, 4, (ALPHABET, ALPHABET)),
                                    (12, 1, cap + 20, ("AAG", "AGG"))):
        args = _batch(cuda, seed + 3 * inst, 512, lo, cap, blo, bhi,
                      pad_a=cap, letters=letters)
        args[1][:2] = cap  # the capacity itself, whatever the draw
        profiling.reset()
        _assert_kernel_equals_plain(args, sub, 5, 1)
        assert nw_cuda.launches()[2] == [inst]


def test_kernel_two_strips_equal_plain(cuda):
    """577-1,119 rows: the last instantiation over two strips, its
    boundary row in shared memory, at the widest padded b."""
    args = _batch(cuda, 13, 96, 577, MAX_MP1 - 1, 1, MAX_MP1 - 1,
                  pad_a=MAX_MP1 - 1, pad_b=MAX_MP1 - 1)
    profiling.reset()
    _assert_kernel_equals_plain(args, blosum.get_matrix(device=cuda), 12, 2)
    assert nw_cuda.launches()[2] == [len(nw_cuda.INSTANCES) - 1]


def test_kernel_rejects_widths_past_its_range(cuda):
    args = _batch(cuda, 14, 2, 5, 10, 5, 10, pad_a=MAX_MP1, pad_b=20)
    with pytest.raises(ValueError, match="nw_gotoh takes padded"):
        nw_cuda.nw_similarity_batch_cuda(*args,
                                         blosum.get_matrix(device=cuda))


def test_similarity_nw_equals_oracle_through_kernel(cuda):
    seqs = load_sequences("evp_peparray", 160)
    profiling.reset()
    got = similarity_nw(seqs)
    assert nw_cuda.launches()[0] > 0
    np.testing.assert_array_equal(got, oracle.nw_similarity(seqs))
    h3n2 = load_sequences("h3n2sample", 24)
    np.testing.assert_array_equal(similarity_nw(h3n2),
                                  oracle.nw_similarity(h3n2))


def test_bucketed_equals_oracle(cuda):
    seqs = (load_sequences("evp_peparray", 40)
            + load_sequences("h3n2sample", 12))
    np.testing.assert_array_equal(similarity_nw_bucketed(seqs, chunk=100),
                                  oracle.nw_similarity(seqs))


def test_xl_range_runs_nw_gotoh_xl(cuda):
    """Padded m+1 = MAX_MP1 + 1 goes to nw_gotoh_xl and equals the plain
    version; a 1,120-aa sequence runs through similarity_nw."""
    args = _batch(cuda, 3, 2, 5, 10, 5, 10, pad_a=MAX_MP1, pad_b=MAX_MP1)
    sub = blosum.get_matrix(device=cuda)
    profiling.reset()
    got = nw_batch(*args, sub)
    ref = nw_similarity_batch(*args, sub)
    assert nw_cuda.launches()[:2] == (0, 1)
    assert torch.equal(got.matches, ref.matches)
    assert torch.equal(got.length, ref.length)
    seqs = ["A" * MAX_MP1, "ARND"]
    np.testing.assert_array_equal(similarity_nw(seqs),
                                  oracle.nw_similarity(seqs))


@pytest.mark.parametrize("gaps", [(10, 4), (5, 1), (12, 2)])
@pytest.mark.parametrize("matrix", blosum.MATRIX_NAMES)
def test_xl_kernel_equals_plain_fuzz(cuda, matrix, gaps):
    args = _batch(cuda, 6, 1000, 1, 80, 1, 80)
    _assert_kernel_equals_plain(args, blosum.get_matrix(matrix, device=cuda),
                                *gaps,
                                wrapper=nw_cuda.nw_similarity_batch_cuda_xl)


@pytest.mark.parametrize("shape", [
    (256, 1121, 2000, 1121, 2000),
    (64, 40, 200, 3000, 5000),  # m != n
    (64, nw_cuda.XL_STRIP - 1, nw_cuda.XL_STRIP + 1, 511, 513),  # strip edge
    (2, 13000, 13000, 13000, 13000),  # past every TPU ceiling
])
def test_xl_kernel_equals_plain_shapes(cuda, shape):
    n, alo, ahi, blo, bhi = shape
    args = _batch(cuda, 7, n, alo, ahi, blo, bhi)
    _assert_kernel_equals_plain(args, blosum.get_matrix(device=cuda),
                                wrapper=nw_cuda.nw_similarity_batch_cuda_xl)


@pytest.mark.parametrize("shape", [
    (512, 1, 80, 1, 80),
    (64, nw_cuda.XL_STRIP - 1, nw_cuda.XL_STRIP + 1, 511, 513),
    (64, 1, 2 * nw_cuda.XL_STRIP + 100, 1, 300),
])
def test_xl_two_word_instantiation_equals_plain(cuda, shape):
    """MT and LN as two words, which the launcher takes from padded M + N =
    65,536 on: asked for by name, small batches run through it."""
    def two_words(*args, gap_open, gap_ext):
        return nw_cuda._run("nw_gotoh_xl", *args, gap_open, gap_ext,
                            xl_words=2)

    n, alo, ahi, blo, bhi = shape
    args = _batch(cuda, 15, n, alo, ahi, blo, bhi, letters=("AAGR", "AGGR"))
    _assert_kernel_equals_plain(args, blosum.get_matrix("BLOSUM45",
                                                        device=cuda), 5, 1,
                                wrapper=two_words)


def test_nw_rescore_pairs_two_words_at_real_width(cuda):
    """300 x 40,000 aa: padded M + N = 80,000, past the packing limit."""
    rng = np.random.default_rng(16)
    seqs = ["".join(rng.choice(list(ALPHABET[:20]), size=k))
            for k in (300, 40000, 257, 39000)]
    pi, pj = np.array([0, 2, 0]), np.array([1, 3, 3])
    profiling.reset()
    got = nw_rescore_pairs(seqs, pi, pj)
    assert nw_cuda.launches()[1] == 1
    np.testing.assert_array_equal(
        got, [oracle.nw_pair(seqs[i], seqs[j]) for i, j in zip(pi, pj)])


def test_bucketed_mixed_set_launches_both_kernels(cuda):
    ha = load_sequences("h3n2sample", 18)
    seqs = (load_sequences("evp_peparray", 20) + ha[:10]
            + [ha[10 + 2 * k] + ha[11 + 2 * k] for k in range(4)])
    profiling.reset()
    got = similarity_nw_bucketed(seqs)
    assert min(nw_cuda.launches()[:2]) > 0
    np.testing.assert_array_equal(got, similarity_nw(seqs))
    np.testing.assert_array_equal(got, oracle.nw_similarity(seqs))


def test_nw_rescore_pairs_past_tpu_ceilings(cuda):
    rng = np.random.default_rng(8)
    seqs = ["".join(rng.choice(list(ALPHABET[:20]), size=k))
            for k in (13000, 13000, 12300, 17000)]
    pi, pj = np.array([0, 2, 1]), np.array([1, 3, 1])
    got = nw_rescore_pairs(seqs, pi, pj)
    np.testing.assert_array_equal(
        got, [oracle.nw_pair(seqs[i], seqs[j]) for i, j in zip(pi, pj)])


def _skewed(dev, seed):
    """One pair of 4 strips and two of 2 among 120 short pairs, with empty
    sides: nw_gotoh_xl's queue runs the long pairs' strips on several
    warps at once."""
    rng = np.random.default_rng(seed)
    strip = nw_cuda.XL_STRIP
    a_lens = [3 * strip + 70, 0, strip + 5, 9, 2 * strip - 1, 0,
              *rng.integers(1, 300, size=120)]
    b_lens = [2900, 40, 1500, 0, 700, 0, *rng.integers(1, 300, size=120)]
    ea = encode(["".join(rng.choice(list(ALPHABET[:20]), size=k))
                 for k in a_lens])
    eb = encode(["".join(rng.choice(list(ALPHABET[:20]), size=k))
                 for k in b_lens])
    return [torch.from_numpy(x).to(dev)
            for x in (ea.indices, ea.lengths, eb.indices, eb.lengths)]


@pytest.mark.parametrize("words", [0, 2])
def test_xl_queue_skewed_batch_equals_plain(cuda, words):
    """The queue of strips on a length-skewed batch, both instantiations
    (0: the launcher's pick by width, one word here; 2: two words)."""
    def xl(*args, gap_open, gap_ext):
        return nw_cuda._run("nw_gotoh_xl", *args, gap_open, gap_ext,
                            xl_words=words)

    args = _skewed(cuda, 20)
    profiling.reset()
    _assert_kernel_equals_plain(args, blosum.get_matrix(device=cuda),
                                wrapper=xl)
    assert nw_cuda.launches()[:2] == (0, 1)
    assert profiling.counters()["nw_gotoh_xl.items"] == (
        4 + 1 + 2 + 1 + 2 + 1 + 120)


def test_xl_queue_repeated_launches_are_identical(cuda):
    """20 launches of one skewed batch give one result, the plain
    version's: a memory-ordering race between the strips of a pair would
    show as drift from run to run."""
    args = _skewed(cuda, 21)
    sub = blosum.get_matrix("BLOSUM80", device=cuda)
    ref = nw_similarity_batch(*args, sub, gap_open=12, gap_ext=2)
    for _ in range(20):
        got = nw_cuda.nw_similarity_batch_cuda_xl(*args, sub, gap_open=12,
                                                  gap_ext=2)
        assert torch.equal(got.matches, ref.matches)
        assert torch.equal(got.length, ref.length)


def test_nw_rescore_pairs_8000_equals_oracle(cuda):
    """Two pairs of 8,000 x 8,000 aa: 13 strips each on as many warps."""
    rng = np.random.default_rng(22)
    seqs = ["".join(rng.choice(list(ALPHABET[:20]), size=8000))
            for _ in range(4)]
    pi, pj = np.array([0, 2]), np.array([1, 3])
    profiling.reset()
    got = nw_rescore_pairs(seqs, pi, pj)
    assert nw_cuda.launches()[1] == 1
    assert profiling.counters()["nw_gotoh_xl.items"] == 2 * 13
    np.testing.assert_array_equal(
        got, [oracle.nw_pair(seqs[i], seqs[j]) for i, j in zip(pi, pj)])


_MEMCHECK_BATCH = """
import numpy as np, torch
from dynaalign_torch import blosum
from dynaalign_torch.encode import encode
from dynaalign_torch.ops import nw_cuda
from dynaalign_torch.ops.nw import nw_similarity_batch
dev, strip = torch.device("cuda"), nw_cuda.XL_STRIP
rng = np.random.default_rng(4)
lens = ([2 * strip + 70, 0, strip + 5, 9, 0, *rng.integers(1, 200, 20)],
        [300, 40, 150, 0, 0, *rng.integers(1, 200, 20)])
enc = [encode(["".join(rng.choice(list("ARNDCQEGHILKMFPSTWYV"), size=k))
               for k in ls]) for ls in lens]
args = [torch.from_numpy(x).to(dev) for e in enc for x in (e.indices,
                                                           e.lengths)]
sub = blosum.get_matrix(device=dev)
ref = nw_similarity_batch(*args, sub)
for words in (0, 2):
    got = nw_cuda._run("nw_gotoh_xl", *args, sub, 10, 4, xl_words=words)
    print("words", words, "equal", torch.equal(got.matches, ref.matches)
          and torch.equal(got.length, ref.length))
"""


def _memcheck(tool, script):
    """(exit code, output) of ``script`` under compute-sanitizer's memcheck,
    with the repository on the path."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run(
        [tool, "--tool", "memcheck", "--error-exitcode", "3",
         sys.executable, str(script)],
        capture_output=True, text=True, timeout=900,
        env=dict(os.environ, PYTHONPATH=root))
    return proc.returncode, proc.stdout + proc.stderr


def test_xl_queue_under_memcheck(cuda, tmp_path):
    """compute-sanitizer's memcheck, where the toolkit has it and it can
    instrument a CUDA program here, on a small skewed batch through both
    instantiations: no out-of-bounds or misaligned access in the queue, its
    table or the boundary rows."""
    tool = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "compute-sanitizer")
    if not os.path.exists(tool):
        pytest.skip("compute-sanitizer is not in the CUDA toolkit here")
    probe = tmp_path / "memcheck_probe.py"
    probe.write_text("import torch\n"
                     "print(int(torch.ones(4, device='cuda').sum()))\n")
    rc, out = _memcheck(tool, probe)
    if rc != 0:  # the tool cannot run any CUDA program on this machine
        pytest.skip("compute-sanitizer fails on a program that only copies "
                    f"4 floats to the card: {out.strip()[-300:]}")
    script = tmp_path / "memcheck_batch.py"
    script.write_text(_MEMCHECK_BATCH)
    rc, out = _memcheck(tool, script)
    assert rc == 0, out[-4000:]
    assert "ERROR SUMMARY: 0 errors" in out
    assert out.count("equal True") == 2


@pytest.mark.parametrize("kind", ["base", "shfl", "mis"])
def test_probe_kernel_equals_plain(cuda, kind):
    """Every step count the unroll over the 8 window offsets treats apart:
    none, fewer than 8, a multiple of 8, and 2,001 = 250 * 8 + 1."""
    from dynaalign_torch.tools import probe_misalign as probe

    for s in (3, 11):
        seed = probe.seed_plane(cuda, s)
        for n_steps in (0, 1, 7, 64, 2001):
            got = probe.probe_shift(seed, kind, n_steps)
            torch.cuda.synchronize()
            ref = probe.probe_plain(seed.cpu(), kind, n_steps)
            assert torch.equal(got.cpu(), ref), (s, n_steps)


def test_probe_launch_covers_128_sms(cuda):
    """The occupancy calculator holds one probe block an SM, and every
    block is resident at once, so the grid runs on as many SMs as it has
    blocks: at least 128."""
    from dynaalign_torch.tools import probe_misalign as probe

    for kind in probe.KINDS:
        g = probe.geometry(kind)
        assert g["blocks"] == probe.BLOCKS and g["threads"] == 32
        assert g["blocks_per_sm"] == 1
        assert g["blocks"] <= g["sms"]
        assert g["sms_covered"] == g["blocks"] >= 128


def test_wrapper_rejects_int64_on_card(cuda):
    args = _batch(cuda, 4, 4, 1, 10, 1, 10)
    args[0] = args[0].long()
    with pytest.raises(TypeError, match="int32"):
        nw_cuda.nw_similarity_batch_cuda(*args, blosum.get_matrix(device=cuda))


def test_wrapper_rejects_scores_past_int8_on_card(cuda):
    args = _batch(cuda, 17, 4, 1, 10, 1, 10)
    sub = blosum.get_matrix(device=cuda).clone()
    sub[0, 0] = 128
    with pytest.raises(ValueError, match="sub must lie"):
        nw_cuda.nw_similarity_batch_cuda(*args, sub)


@pytest.mark.parametrize("wrapper", [nw_cuda.nw_similarity_batch_cuda,
                                     nw_cuda.nw_similarity_batch_cuda_xl])
def test_kernels_read_table_row_a_column_b(cuda, wrapper):
    """A table that is not symmetric gives the plain version's result."""
    sub = blosum.get_matrix(device=cuda).clone()
    sub[:24, :24] += torch.from_numpy(np.random.default_rng(18).integers(
        -3, 4, size=(24, 24), dtype=np.int32)).to(cuda)
    assert not torch.equal(sub, sub.T)
    for ahi in (12, 566, 700):
        args = _batch(cuda, 19, 256, 1, ahi, 1, 300)
        _assert_kernel_equals_plain(args, sub, wrapper=wrapper)


def test_wrapper_rejects_symbols_past_pad_on_card(cuda):
    args = _batch(cuda, 20, 4, 1, 10, 1, 10)
    args[2][1, 0] = 25
    with pytest.raises(ValueError, match="alphabet indices"):
        nw_cuda.nw_similarity_batch_cuda(*args, blosum.get_matrix(device=cuda))


def test_wrapper_rejects_length_past_width_on_card(cuda):
    args = _batch(cuda, 5, 4, 1, 10, 1, 10)
    args[1][0] = args[0].shape[1] + 1
    with pytest.raises(ValueError, match="lengths out of range"):
        nw_cuda.nw_similarity_batch_cuda(*args, blosum.get_matrix(device=cuda))


# --- MinHash, top-k, clustering and the hybrid pipelines on the card ---


def _mh_seqs(seed, n, lo, hi):
    rng = np.random.default_rng(seed)
    return ["".join(rng.choice(list(ALPHABET[:20]), size=k))
            for k in rng.integers(lo, hi + 1, size=n)]


@pytest.mark.parametrize("k", range(1, 10))
def test_signatures_equal_oracle_on_card(cuda, k):
    from dynaalign_torch.ops import minhash

    seqs = _mh_seqs(k, 200, 0, 80)
    enc = encode(seqs, validate=False)
    sigs = minhash.minhash_signatures(enc.ascii, enc.lengths, k=k,
                                      n_hash=70, seed=2**31 + k, chunk=64)
    assert sigs.device.type == "cuda" and sigs.dtype == torch.int32
    np.testing.assert_array_equal(
        minhash.signatures_to_numpy(sigs),
        oracle.minhash_signatures(seqs, k, 70, 2**31 + k))


@pytest.mark.parametrize("k, n_hash", [(2, 50), (4, 50), (4, 300)])
def test_similarity_mh_on_card(cuda, k, n_hash):
    from dynaalign_torch import MinHashEngine, similarity_mh

    seqs = load_sequences("evp_peparray", 300) + ["", "AR"]
    got = similarity_mh(seqs, k, n_hash, seed=5)
    np.testing.assert_array_equal(
        got, oracle.minhash_similarity(seqs, k, n_hash, 5))
    np.testing.assert_array_equal(
        got, similarity_mh(seqs, k, n_hash, seed=5, device="cpu"))
    np.testing.assert_array_equal(
        got, similarity_mh(seqs, k, n_hash, seed=5, chunk=50, block=33))
    for cache in (True, False):
        eng = MinHashEngine(seqs, k, n_hash, seed=5, cache_counts=cache)
        np.testing.assert_array_equal(eng(seqs[40:90]), got[40:90, 40:90])


@pytest.mark.parametrize("n_hash", [50, 300])
def test_similarity_mh_pooled_divide_on_card(cuda, n_hash):
    """2,002 sequences, over counts_to_similarity's pool cut: the card's
    narrowed counts and pooled divide equal the CPU path, the oracle and
    MinHashEngine (both count caches) bit for bit."""
    from dynaalign_torch import MinHashEngine, similarity_mh
    from dynaalign_torch.ops import minhash

    seqs = _mh_seqs(11, 2000, 8, 60) + ["", "AR"]
    assert len(seqs) ** 2 * 8 >= 2 * minhash.SIMILARITY_BLOCK_BYTES
    profiling.reset()
    got = similarity_mh(seqs, 2, n_hash, seed=9)
    c = profiling.counters()
    assert c["mh.fetch.bytes"] == len(seqs) ** 2 * (1 if n_hash < 256 else 2)
    assert (c["mh.similarity.workers"] > 0) == (torch.get_num_threads() > 1)
    want = similarity_mh(seqs, 2, n_hash, seed=9, device="cpu")
    assert got.tobytes() == want.tobytes()
    np.testing.assert_array_equal(
        got, oracle.minhash_similarity(seqs, 2, n_hash, 9))
    rows = np.random.default_rng(n_hash).permutation(len(seqs))[:900]
    for cache in (True, False):
        eng = MinHashEngine(seqs, 2, n_hash, seed=9, cache_counts=cache)
        assert eng(seqs).tobytes() == got.tobytes()
        sub = eng([seqs[i] for i in rows])
        assert sub.tobytes() == got[np.ix_(rows, rows)].tobytes()


def test_agreement_counts_int32_on_card(cuda):
    from dynaalign_torch.ops import minhash

    sigs = np.random.default_rng(3).integers(
        0, 4, size=(500, 300)).astype(np.uint32) + np.uint32(0x7FFFFFFE)
    got = minhash.signature_agreement_counts(sigs, block=77)
    assert got.dtype == torch.int32 and got.device.type == "cuda"
    np.testing.assert_array_equal(
        got.cpu().numpy(), (sigs[:, None, :] == sigs[None, :, :]).sum(-1))


@pytest.mark.parametrize("n, h, k, block", [(96, 8, 7, 32), (61, 5, 60, None),
                                            (1, 4, 3, None), (2, 4, 3, 1)])
def test_topk_tie_order_on_card(cuda, n, h, k, block):
    from dynaalign_torch.ops.topk_graph import minhash_topk

    sigs = np.random.default_rng(7).integers(0, 3, size=(n, h)).astype(
        np.uint32)
    vals, idx = minhash_topk(sigs, k=k, block=block)
    cvals, cidx = minhash_topk(sigs, k=k, block=block, device="cpu")
    np.testing.assert_array_equal(idx, cidx)
    np.testing.assert_array_equal(vals, cvals)
    counts = (sigs[:, None, :] == sigs[None, :, :]).sum(-1).astype(np.int64)
    np.fill_diagonal(counts, -1)
    if n > 1:
        for i in range(n):
            np.testing.assert_array_equal(
                idx[i], np.argsort(-counts[i], kind="stable")[: idx.shape[1]])


# Inputs of the top-k kernel against the plain version: (signatures,
# start, stop, k).
_TOPK_CASES = {
    "ties_k1": (_tiny(21, 3000, 8), 0, 3000, 1),
    "ties_k32": (_tiny(22, 3000, 6), 0, 3000, 32),
    "ties_k64": (_tiny(23, 3000, 5), 0, 3000, 64),
    "ties_k_max": (_tiny(24, 3000, 4), 0, 3000, topk_cuda.MAX_K),
    "all_equal": (np.full((1000, 5), 9, np.uint32), 0, 1000, 32),
    "n1": (_tiny(26, 1, 4), 0, 1, 1),
    "n2": (_tiny(27, 2, 4), 0, 2, 1),
    "k_is_n_minus_1": (_tiny(28, 200, 8), 0, 200, 199),
    "zero_fill": (_sparse(29, 5000, 50, planted=400), 0, 5000, 32),
    "n_hash_1": (_tiny(30, 2000, 1), 0, 2000, 32),
    "n_hash_50": (_tiny(31, 2000, 50, values=2), 0, 2000, 32),
    "n_hash_255": (_tiny(32, 1000, 255, values=2), 0, 1000, 32),
    "start_offset": (_tiny(33, 3000, 6), 700, 2300, 16),
    "rising": (_rising(3000, 8), 0, 3000, 8),
}


@pytest.mark.parametrize("case", list(_TOPK_CASES))
def test_topk_kernel_equals_plain_on_card(cuda, case):
    """_topk_block on the card equals it on the CPU, counts and indices
    entry for entry, in one kernel launch for all the rows."""
    sigs, start, stop, k = _TOPK_CASES[case]
    host = torch.from_numpy(sigs.view(np.int32))
    profiling.reset()
    got_c, got_i = _topk_block(host.to(cuda), start, stop, k, block=64)
    torch.cuda.synchronize()
    c = profiling.counters()
    assert c["minhash_topk"] == c["topk.block"] == 1
    assert c["minhash_topk.rows"] == c["topk.block.kernel_rows"] == (
        stop - start)
    assert c["topk.block.plain_rows"] == 0
    want_c, want_i = _topk_block(host, start, stop, k)
    assert got_c.device.type == "cuda" and got_c.dtype == torch.int64
    np.testing.assert_array_equal(got_c.cpu().numpy(), want_c.numpy())
    np.testing.assert_array_equal(got_i.cpu().numpy(), want_i.numpy())


@pytest.mark.parametrize("n_hash, k", [
    (4, topk_cuda.MAX_K + 1), (topk_cuda.MAX_N_HASH + 1, 32)],
    ids=["ties_k_past_max", "n_hash_past_max"])
def test_topk_kernel_raises_past_its_limits_on_card(cuda, n_hash, k):
    """Past the kernel's k or n_hash the card raises before a launch: no
    other version runs there; the CPU takes the call."""
    host = torch.from_numpy(_tiny(25, 700, n_hash).view(np.int32))
    profiling.reset()
    with pytest.raises(ValueError, match="device='cpu' takes any"):
        _topk_block(host.to(cuda), 0, 700, k)
    torch.cuda.synchronize()
    assert profiling.counters() == {}
    c, i = _topk_block(host, 0, 700, k)
    assert c.shape == i.shape == (700, k)


def test_topk_kernel_equals_benchmark_reference_on_peptides(cuda):
    """minhash_topk on the first 4,096 of data/peptides_100k.npz (the
    cluster cell's warm call) in one kernel launch, against the benchmark's
    plain reference, portbench/reference/cluster.topk_counts: the same
    (row, column, count) entries."""
    import json

    from portbench.reference import cluster as ref_cluster
    from portbench.reference import minhash as ref_minhash

    from dynaalign_torch.ops import minhash
    from dynaalign_torch.ops.topk_graph import minhash_topk

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with np.load(os.path.join(root, "data", "peptides_100k.npz")) as z:
        seqs = [str(x) for x in z["sequence"][:4096]]
    with open(os.path.join(root, "portbench", "configs",
                           "cluster_exact_top32.json")) as f:
        s = json.load(f)["settings"]
    enc = encode(seqs, validate=False)
    sigs = minhash.minhash_signatures(enc.ascii, enc.lengths, k=s["k"],
                                      n_hash=s["n_hash"], seed=s["seed"])
    rsigs = ref_minhash.signatures(seqs, s["k"], s["n_hash"], s["seed"],
                                   cuda)
    assert torch.equal(sigs.long() & 0xFFFFFFFF, rsigs)
    profiling.reset()
    vals, idx = minhash_topk(sigs, k=s["top_k"])
    c = profiling.counters()
    assert c["topk.block"] == c["minhash_topk"] == 1
    assert c["topk.block.plain_rows"] == 0
    assert c["topk.block.kernel_rows"] == len(seqs)
    n, k = idx.shape
    rows = np.repeat(np.arange(n), k)
    order = np.lexsort((idx.ravel(), rows))
    r_rows, r_cols, r_cnt = ref_cluster.topk_counts(rsigs, s["top_k"])
    np.testing.assert_array_equal(rows[order], r_rows)
    np.testing.assert_array_equal(idx.ravel()[order], r_cols)
    np.testing.assert_array_equal(
        np.rint(vals.ravel()[order] * s["n_hash"]).astype(np.int64), r_cnt)


def test_clustering_on_card_equals_cpu(cuda):
    from dynaalign_torch import cluster_large, clusterbreak

    seqs = load_sequences("evp_peparray", 200)
    got = clusterbreak(seqs, verbose=False)
    ref = clusterbreak(seqs, verbose=False, device="cpu")
    np.testing.assert_array_equal(got.clustered_seq, ref.clustered_seq)
    assert got.filtered_seq == ref.filtered_seq and got.n_calls == ref.n_calls
    big = load_sequences("allunique", 1500)
    np.testing.assert_array_equal(
        cluster_large(big, top_k=16), cluster_large(big, top_k=16,
                                                    device="cpu"))


def test_hybrid_on_card(cuda):
    """The hybrid pipelines launch the NW kernels, and equal their CPU
    results; sparse equals dense at top_k = N - 1."""
    from dynaalign_torch import (
        cluster_large_exact, similarity_hybrid, similarity_hybrid_sparse,
    )

    seqs = load_sequences("h3n2sample", 60)
    profiling.reset()
    dense = similarity_hybrid(seqs, prefilter_threshold=0.5)
    assert nw_cuda.launches()[0] > 0 and nw_cuda.launches()[1] == 0
    np.testing.assert_array_equal(
        dense, similarity_hybrid(seqs, prefilter_threshold=0.5,
                                 device="cpu"))
    sp = similarity_hybrid_sparse(seqs, top_k=59, prefilter_threshold=0.5)
    np.testing.assert_array_equal(sp.toarray(), dense)
    long = [seqs[2 * k] + seqs[2 * k + 1] + seqs[2 * k] for k in range(6)]
    profiling.reset()
    ldense = similarity_hybrid(long)
    assert nw_cuda.launches()[1] > 0 and nw_cuda.launches()[0] == 0
    full = similarity_nw(long)
    kept = (ldense != 0) & ~np.eye(6, dtype=bool)
    assert kept.any()
    np.testing.assert_array_equal(ldense[kept], full[kept])
    pep = load_sequences("allunique", 1200)
    np.testing.assert_array_equal(
        cluster_large_exact(pep, top_k=16),
        cluster_large_exact(pep, top_k=16, device="cpu"))


@pytest.mark.parametrize("engine", ["mh", "nw"])
def test_pipeline_on_card_equals_cpu(cuda, engine):
    """The Pipeline's clusters and consensus on the card equal its
    device="cpu" run; the nw engine launches nw_gotoh."""
    from dynaalign_torch import Pipeline
    from dynaalign_torch.config import (
        ClusterBreakConfig, MinHashConfig, PipelineConfig,
    )

    seqs = load_sequences("evp_peparray", 200)
    cfg = PipelineConfig(similarity=engine,
                         minhash=MinHashConfig(k=2, n_hash=50),
                         clusterbreak=ClusterBreakConfig(size_max=30,
                                                         size_min=2))
    profiling.reset()
    got = Pipeline(cfg).run(seqs)
    assert (nw_cuda.launches()[0] > 0) == (engine == "nw")
    ref = Pipeline(cfg, device="cpu").run(seqs)
    np.testing.assert_array_equal(got.clusters.clustered_seq,
                                  ref.clusters.clustered_seq)
    assert got.clusters.filtered_seq == ref.clusters.filtered_seq
    assert got.clusters.converged == ref.clusters.converged
    assert got.consensus.tolist() == ref.consensus.tolist()


def test_cli_similarity_nw_on_card(cuda, tmp_path):
    """python -m dynaalign_torch similarity --engine nw, on the card by
    default, writes similarity_nw's matrix."""
    import os
    import subprocess
    import sys

    from dynaalign_torch.io.seqio import write_fasta

    seqs = load_sequences("h3n2sample", 40)
    fa = tmp_path / "in.fasta"
    write_fasta(str(fa), [f"s{i}" for i in range(len(seqs))], seqs)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run([sys.executable, "-m", "dynaalign_torch", "similarity",
                    "--input", str(fa), "--engine", "nw", "--output",
                    str(tmp_path / "sim.npz")], check=True, cwd=root)
    with np.load(tmp_path / "sim.npz") as z:
        np.testing.assert_array_equal(z["similarity"], similarity_nw(seqs))


def test_trace_records_the_card(cuda, tmp_path):
    """utils.profiling.trace captures the card: nw_gotoh's launches show
    with device time, and the Chrome trace is written."""
    from dynaalign_torch.utils.profiling import trace

    seqs = load_sequences("h3n2sample", 64)
    similarity_nw(seqs)
    with trace(str(tmp_path / "tr")) as prof:
        similarity_nw(seqs)
        torch.cuda.synchronize()
    dev_us = {e.key: e.self_device_time_total for e in prof.key_averages()}
    assert any("nw_gotoh" in k and us > 0 for k, us in dev_us.items()), dev_us
    assert (tmp_path / "tr" / "trace.json").stat().st_size > 0


def test_spans_lie_inside_their_trace_events_on_card(cuda, tmp_path):
    """test_torch_profiling.py's clock check with the card's activity in
    the trace: every span of similarity_nw and similarity_mh inside its own
    user_annotation event (ts * 1000 + baseTimeNanoseconds), within 1 ms."""
    from test_torch_profiling import spans_within_events

    from dynaalign_torch import similarity_mh

    seqs = load_sequences("h3n2sample", 64)
    similarity_nw(seqs)
    similarity_mh(seqs)
    with profiling.trace(str(tmp_path)):
        similarity_nw(seqs)
        similarity_mh(seqs)
        torch.cuda.synchronize()
    assert spans_within_events(str(tmp_path / "trace.json")) == len(
        profiling.spans())
    assert nw_cuda.launches()[0] > 0
    assert {"nw.fetch", "nw_gotoh.check", "mh.fetch"} <= {
        s.name for s in profiling.spans()}


def test_sharded_functions_on_card_equal_single_device(cuda):
    """parallel/'s sharded functions on the mesh of this process alone (no process
    group) launch the card's kernels and equal the single-device calls."""
    from dynaalign_torch import cluster_large, similarity_mh
    from dynaalign_torch import parallel
    from dynaalign_torch.ops import minhash
    from dynaalign_torch.ops.topk_graph import minhash_topk

    mesh = parallel.make_mesh()
    assert mesh.device.type == "cuda" and mesh.group is None
    sub = blosum.get_matrix().numpy()
    seqs = load_sequences("h3n2sample", limit=120)
    mixed = load_sequences("evp_peparray", 40) + [
        "".join(seqs[i:i + 3]) for i in range(0, 30, 3)]
    enc = encode(seqs)
    profiling.reset()
    got = parallel.sharded_nw_allpairs(enc.indices, enc.lengths, sub,
                                       mesh=mesh)
    assert nw_cuda.launches()[0] > 0
    assert got.tobytes() == similarity_nw(seqs).tobytes()
    got = parallel.sharded_nw_allpairs_bucketed(mixed, sub, mesh=mesh)
    assert nw_cuda.launches()[1] > 0
    assert got.tobytes() == similarity_nw_bucketed(mixed).tobytes()
    menc = encode(seqs, validate=False)
    got = parallel.sharded_minhash_similarity(menc.ascii, menc.lengths,
                                              mesh=mesh)
    assert got.tobytes() == similarity_mh(seqs).tobytes()
    peps = load_sequences("allunique", limit=3000)
    penc = encode(peps, validate=False)
    sigs = minhash.minhash_signatures(penc.ascii, penc.lengths)
    got = parallel.sharded_minhash_topk(minhash.signatures_to_numpy(sigs),
                                        16, mesh=mesh)
    want = minhash_topk(sigs, 16)
    assert all(g.tobytes() == w.tobytes() for g, w in zip(got, want))
    np.testing.assert_array_equal(cluster_large(peps, mesh=mesh),
                                  cluster_large(peps))
