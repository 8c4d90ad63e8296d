"""The port's parallel/ on the CPU: real gloo process groups of 2 (1x2) and
4 (2x2) ranks, each rank a process of this file run as a script.

Every sharded function's result, on every rank, is held byte for byte against
the port's single-device function, the JAX package's sharded function on a
mesh of as many virtual devices (run here, in the test process), and the
C++ oracle (or, for agreement counts and top-k lists, a plain host count
and a stable host sort).  Also: the mesh's shape and factoring, the mesh of
one process, a sub-mesh of half the ranks, ``mesh=`` on ``cluster_large``
and ``cluster_large_exact``, and that importing ``parallel`` loads no JAX
and starts no process group.

Run alone: ``python -m pytest tests/test_torch_parallel.py -q``.  The
ranks meet through a ``file://`` store under the test's temporary
directory (no port to collide under xdist), and a world that does not
finish in ``TIMEOUT`` seconds is killed and fails.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

WORLDS = (2, 4)
TIMEOUT = 120
AA20 = "ARNDCQEGHILKMFPSTWYV"
MH = dict(k=3, n_hash=32, seed=9)


def _seqs(seed, n, lo, hi):
    rng = np.random.default_rng(seed)
    return ["".join(rng.choice(list(AA20), size=int(k)))
            for k in rng.integers(lo, hi + 1, size=n)]


def _mixed():
    short, long_ = _seqs(30, 14, 10, 14), _seqs(31, 9, 50, 90)
    return [s for pair in zip(short, long_ + long_[:5]) for s in pair]


def _clustered(seed, n, h):
    """Signatures in 20 families with 10% of slots mutated: real structure
    and ties (the JAX package's sharded top-k test data)."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 1 << 31, size=(20, h), dtype=np.uint32)
    sigs = base[rng.integers(0, 20, size=n)]
    mut = rng.random((n, h)) < 0.1
    return np.where(mut, rng.integers(0, 1 << 31, size=(n, h)),
                    sigs).astype(np.uint32)


def _tie_canary():
    return np.random.default_rng(7).integers(0, 3, size=(96, 8)).astype(
        np.uint32)


# case -> (sequences, the sharded function's keyword arguments)
NW_CASES = {
    "nw": (lambda: _seqs(20, 25, 5, 40), dict(tile=8)),
    # tile=8 over 41 sequences: 21 tiles in two segments at 2 and 4 ranks
    "nw_segments": (lambda: _seqs(21, 41, 5, 40),
                    dict(tile=8, max_tiles_per_dispatch=8)),
    "nw_one_tile": (lambda: _seqs(22, 5, 1, 9), dict(tile=16)),
}
BUCKETED_CASES = {
    "bucketed_mixed": (_mixed, dict(bucket_edges=(15, 31, 63, 127),
                                     batch=32)),
    "bucketed_single": (lambda: _seqs(23, 10, 20, 30), dict(batch=16)),
}
MH_CASES = {
    "agreement": lambda: _seqs(24, 37, 8, 30),
    "minhash": lambda: _seqs(25, 30, 8, 40),
    "minhash_short": lambda: _seqs(26, 3, 1, 6) + ["", "AR"],
}
TOPK_CASES = {  # signatures, k, block
    "topk": (lambda: _clustered(8, 300, 50), 16, 64),
    "topk_wide": (lambda: _clustered(9, 133, 200), 33, None),
    "topk_tie_canary": (_tie_canary, 7, 32),
}
CASES = [*NW_CASES, *BUCKETED_CASES, *MH_CASES, *TOPK_CASES]


def _signatures(seqs):
    from dynaalign_torch.encode import encode
    from dynaalign_torch.ops import minhash

    enc = encode(seqs, validate=False)
    return minhash.signatures_to_numpy(minhash.minhash_signatures(
        enc.ascii, enc.lengths, device="cpu", **MH))


def run_case(name, mesh):
    """The port's sharded function on case ``name``, as a tuple of arrays
    (None on a rank outside ``mesh``)."""
    from dynaalign_torch import blosum, parallel
    from dynaalign_torch.encode import encode

    sub = blosum.get_matrix("BLOSUM62").numpy()
    if name in NW_CASES:
        seqs, kw = NW_CASES[name]
        enc = encode(seqs())
        out = parallel.sharded_nw_allpairs(enc.indices, enc.lengths, sub,
                                           mesh=mesh, **kw)
    elif name in BUCKETED_CASES:
        seqs, kw = BUCKETED_CASES[name]
        out = parallel.sharded_nw_allpairs_bucketed(seqs(), sub, mesh=mesh,
                                                    **kw)
    elif name == "agreement":
        out = parallel.sharded_signature_agreement(
            _signatures(MH_CASES[name]()), mesh)
    elif name in MH_CASES:
        enc = encode(MH_CASES[name](), validate=False)
        out = parallel.sharded_minhash_similarity(enc.ascii, enc.lengths,
                                                  mesh=mesh, **MH)
    else:
        sigs, k, block = TOPK_CASES[name]
        out = parallel.sharded_minhash_topk(sigs(), k, mesh=mesh,
                                            block=block)
    return out if out is None or isinstance(out, tuple) else (out,)


def _evp(n):
    from dynaalign_torch.io.datasets import load_sequences

    return load_sequences("evp_peparray", n)


def _worker(rank, world, store, out_dir):
    """One rank: every case on the whole world, the sub-mesh of the first
    half of the ranks, and cluster_large(_exact) with and without a mesh;
    the results go to ``out_dir/rank<rank>.npz``."""
    from dynaalign_torch import cluster_large, cluster_large_exact, parallel
    from dynaalign_torch.parallel.failures import clean_abort

    torch.set_num_threads(1)
    with clean_abort():
        parallel.distributed_init(f"file://{store}", world, rank,
                                  device="cpu")
        res = {}
        for n in sorted({1, 2, world}):
            m = parallel.make_mesh(n_devices=n, device="cpu")
            res[f"shape{n}"] = np.array([m.shape["rows"], m.shape["cols"]])
        mesh = parallel.make_mesh(device="cpu")
        res["coords"] = np.array(mesh.coords)
        for name in CASES:
            for i, a in enumerate(run_case(name, mesh)):
                res[f"{name}/{i}"] = a
        half = parallel.make_mesh(n_devices=world // 2, device="cpu")
        out = run_case("nw", half)
        if out is not None:
            res["half/0"] = out[0]
        evp = _evp(200)
        for fn in (cluster_large, cluster_large_exact):
            res[f"{fn.__name__}/mesh"] = fn(evp, mesh=mesh, device="cpu")
            res[f"{fn.__name__}/none"] = fn(evp, device="cpu")
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)
        torch.distributed.destroy_process_group()


def launch(world, tmp, argv_of_rank, timeout=TIMEOUT):
    """Start ``world`` processes (``argv_of_rank(rank)``), wait for all of
    them at most ``timeout`` seconds together, kill every one on expiry;
    returns [(returncode, output)] by rank."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen(argv_of_rank(r), env=env, cwd=tmp,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        pytest.fail(f"a world of {world} ranks hung past {timeout} s")
    return [(p.returncode, out) for p, out in zip(procs, outs)]


@pytest.fixture(scope="module", params=WORLDS, ids=lambda w: f"world{w}")
def world(request, tmp_path_factory):
    """(world size, [results of each rank]) of one run of the workers."""
    w = request.param
    tmp = tmp_path_factory.mktemp(f"world{w}")
    store = tmp / "store"
    ran = launch(w, tmp, lambda r: [sys.executable, __file__, str(r), str(w),
                                    str(store), str(tmp)])
    for r, (rc, out) in enumerate(ran):
        assert rc == 0, f"rank {r} of {w} failed:\n{out}"
    return w, [dict(np.load(tmp / f"rank{r}.npz")) for r in range(w)]


def _got(world, name):
    """The case's result on rank 0, after checking every rank holds the
    same bytes."""
    w, ranks = world
    parts = sorted(k for k in ranks[0] if k.startswith(f"{name}/"))
    assert parts, f"no result for {name}"
    for r in range(1, w):
        for k in parts:
            assert ranks[r][k].dtype == ranks[0][k].dtype
            np.testing.assert_array_equal(ranks[r][k], ranks[0][k])
    return tuple(ranks[0][k] for k in parts)


def _single_device(name):
    import dynaalign_torch as dt
    from dynaalign_torch.ops import minhash, topk_graph

    if name in NW_CASES:
        return (dt.similarity_nw(NW_CASES[name][0](), device="cpu"),)
    if name in BUCKETED_CASES:
        seqs, kw = BUCKETED_CASES[name]
        edges = {k: v for k, v in kw.items() if k == "bucket_edges"}
        return (dt.similarity_nw_bucketed(seqs(), device="cpu", **edges),)
    if name == "agreement":
        return (minhash.signature_agreement_counts(
            _signatures(MH_CASES[name]()), device="cpu").numpy(),)
    if name in MH_CASES:
        return (dt.similarity_mh(MH_CASES[name](), device="cpu", **MH),)
    sigs, k, block = TOPK_CASES[name]
    return topk_graph.minhash_topk(sigs(), k, block=block, device="cpu")


def _jax_sharded(name, w):
    from dynaalign_tpu import blosum as jblosum
    from dynaalign_tpu import parallel as jpar
    from dynaalign_tpu.encode import encode as jencode

    mesh = jpar.make_mesh(n_devices=w)
    sub = jblosum.get_matrix("BLOSUM62")
    if name in NW_CASES:
        seqs, kw = NW_CASES[name]
        enc = jencode(seqs())
        return (jpar.sharded_nw_allpairs(enc.indices, enc.lengths, sub,
                                         mesh=mesh, **kw),)
    if name in BUCKETED_CASES:
        seqs, kw = BUCKETED_CASES[name]
        return (jpar.sharded_nw_allpairs_bucketed(seqs(), sub, mesh=mesh,
                                                  **kw),)
    if name == "agreement":
        return (jpar.sharded_signature_agreement(
            _signatures(MH_CASES[name]()), mesh),)
    if name in MH_CASES:
        enc = jencode(MH_CASES[name](), validate=False)
        return (jpar.sharded_minhash_similarity(enc.ascii, enc.lengths,
                                                mesh=mesh, **MH),)
    sigs, k, _ = TOPK_CASES[name]
    return jpar.sharded_minhash_topk(sigs(), k, mesh=mesh)


def _stable_topk(sigs, k):
    n, h = sigs.shape
    counts = (sigs[:, None, :] == sigs[None, :, :]).sum(-1).astype(np.int64)
    np.fill_diagonal(counts, -1)
    idx = np.stack([np.argsort(-counts[i], kind="stable")[:k]
                    for i in range(n)])
    vals = np.take_along_axis(counts, idx, axis=1)
    return np.maximum(vals, 0) / float(h), idx.astype(np.int32)


def _reference(name):
    """The C++ oracle's result, or the plain host count / stable sort."""
    from dynaalign_torch import oracle

    if name in NW_CASES:
        return (oracle.nw_similarity(NW_CASES[name][0]()),)
    if name in BUCKETED_CASES:
        return (oracle.nw_similarity(BUCKETED_CASES[name][0]()),)
    if name == "agreement":
        seqs = MH_CASES[name]()
        sims = oracle.minhash_similarity(seqs, MH["k"], MH["n_hash"],
                                         MH["seed"])
        # counts / n_hash, exact at n_hash = 32
        counts = (sims * MH["n_hash"]).astype(np.int32)
        np.fill_diagonal(counts, MH["n_hash"])  # a row agrees with itself
        return (counts,)
    if name in MH_CASES:
        return (oracle.minhash_similarity(MH_CASES[name](), MH["k"],
                                          MH["n_hash"], MH["seed"]),)
    sigs, k, _ = TOPK_CASES[name]
    return _stable_topk(sigs(), k)


def _assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.tobytes() == w.tobytes()


@pytest.mark.parametrize("name", CASES)
def test_sharded_equals_single_device(world, name):
    _assert_same(_got(world, name), _single_device(name))


@pytest.mark.parametrize("name", CASES)
def test_sharded_equals_jax_sharded(world, name):
    _assert_same(_got(world, name), _jax_sharded(name, world[0]))


@pytest.mark.parametrize("name", CASES)
def test_sharded_equals_oracle(world, name):
    _assert_same(_got(world, name), _reference(name))


def test_mesh_shapes(world):
    w, ranks = world
    want = {1: (1, 1), 2: (1, 2), 4: (2, 2)}
    for r in range(w):
        for n in sorted({1, 2, w}):
            assert tuple(ranks[r][f"shape{n}"]) == want[n]
        assert tuple(ranks[r]["coords"]) == divmod(r, want[w][1])


def test_sub_mesh_of_half_the_ranks(world):
    """make_mesh(n_devices=w // 2): its ranks hold the whole result, the
    others run nothing and get None."""
    w, ranks = world
    want = _reference("nw")[0]
    for r in range(w):
        if r < w // 2:
            assert ranks[r]["half/0"].tobytes() == want.tobytes()
        else:
            assert "half/0" not in ranks[r]


@pytest.mark.parametrize("fn", ["cluster_large", "cluster_large_exact"])
def test_cluster_mesh_equals_no_mesh(world, fn):
    import dynaalign_torch as dt

    w, ranks = world
    want = getattr(dt, fn)(_evp(200), device="cpu")
    for r in range(w):
        np.testing.assert_array_equal(ranks[r][f"{fn}/mesh"], want)
        np.testing.assert_array_equal(ranks[r][f"{fn}/none"], want)


@pytest.mark.parametrize("n, shape", [(1, (1, 1)), (2, (1, 2)), (4, (2, 2)),
                                      (8, (2, 4)), (6, (2, 3)), (7, (1, 7))])
def test_near_square_factors_equal_jax(n, shape):
    from dynaalign_tpu.parallel.mesh import _near_square_factors as jfactors

    from dynaalign_torch.parallel.mesh import _near_square_factors

    assert _near_square_factors(n) == jfactors(n) == shape


def test_one_process_mesh():
    """No process group: a 1x1 mesh of this process, whole placements,
    no collective; a larger mesh asks for distributed_init."""
    from dynaalign_torch import parallel
    from dynaalign_torch.parallel.mesh import Placement

    assert not torch.distributed.is_initialized()
    mesh = parallel.make_mesh(device="cpu")
    assert mesh.shape == {"rows": 1, "cols": 1} and mesh.group is None
    assert mesh.coords == (0, 0) and mesh.device == torch.device("cpu")
    for place in (parallel.replicated, parallel.row_sharded,
                  parallel.block_sharded):
        assert isinstance(place(mesh), Placement)
        assert place(mesh).local(5, 3) == (slice(0, 5), slice(0, 3))
    for kw in ({"n_devices": 2}, {"devices": [0, 1]}):
        with pytest.raises(ValueError, match="distributed_init"):
            parallel.make_mesh(device="cpu", **kw)
    assert parallel.distributed_init(device="cpu") is None  # no environment
    with pytest.raises(ValueError, match="not both"):
        parallel.sharded_minhash_topk(_tie_canary(), 3, mesh=mesh,
                                      device="cpu")
    for name in ("nw", "bucketed_single", "minhash", "topk"):
        _assert_same(run_case(name, mesh), _single_device(name))


def test_placements_split_like_the_flattened_mesh():
    """Shares are contiguous runs of ceil(n / parts), over the mesh's rows
    for row_sharded and over rows and columns for block_sharded."""
    from dynaalign_torch.parallel.mesh import Mesh, Placement

    grid = np.arange(6).reshape(2, 3)
    spans = []
    for rank in range(6):
        mesh = Mesh(grid, rank, torch.device("cpu"))
        rows, cols = Placement(mesh, rows=True, cols=True).local(10, 7)
        spans.append(((rows.start, rows.stop), (cols.start, cols.stop)))
        flat_rows, _ = Placement(mesh.flat(), rows=True).local(10)
        assert (flat_rows.start, flat_rows.stop) == (
            min(2 * rank, 10), min(2 * rank + 2, 10))
    assert spans[4] == ((5, 10), (3, 6)) and spans[2] == ((0, 5), (6, 7))
    outside = Mesh(grid, 9, torch.device("cpu"))
    assert Placement(outside).local(4) is None and outside.index is None


def test_import_starts_nothing_and_loads_no_jax():
    code = (
        "import sys, torch.distributed as d, dynaalign_torch.parallel; "
        "assert not d.is_initialized(); "
        "assert not any(m == 'jax' or m.startswith('jax.') "
        "for m in sys.modules)"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   cwd=os.path.dirname(os.path.dirname(__file__)),
                   timeout=TIMEOUT)


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
