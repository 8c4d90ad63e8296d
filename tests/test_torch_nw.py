"""The port's batched NW (plain version, wrapper, dispatch, build) against
the JAX package and the C++ oracle, on the CPU.  The kernel source, run as
threaded host C++: ``test_torch_nw_source.py`` and
``test_torch_nw_source_tables.py``.

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
