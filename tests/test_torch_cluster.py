"""The port's clustering layer on the CPU against the JAX package: graph
utilities, Louvain (native pass against the numpy pass), netcluster,
louvain_mod and clusterbreak with checkpoint resume.  Tolerance 0."""

import dataclasses
import importlib
import os
import subprocess
import sys

import numpy as np
import pytest
from scipy import sparse

torch = pytest.importorskip("torch")

import jax  # noqa: E402,F401

import dynaalign_tpu as dj  # noqa: E402
from dynaalign_tpu import cluster as jcluster  # noqa: E402
from dynaalign_tpu import config as jconfig  # noqa: E402

import dynaalign_torch as dt  # noqa: E402
from dynaalign_torch import cluster, config  # noqa: E402
from dynaalign_torch.cluster import _native  # noqa: E402
from dynaalign_torch.io.datasets import load_sequences  # noqa: E402
from dynaalign_torch.utils import native  # noqa: E402

# the package re-exports functions under its submodules' names
cb_mod = importlib.import_module("dynaalign_torch.cluster.clusterbreak")
louvain_mod_ = importlib.import_module("dynaalign_torch.cluster.louvain")


def block_matrix():
    # two obvious communities (reference example, R/clusterbreak.R:25-30)
    return np.array([[1, 1, 0, 0], [1, 1, 0, 0], [0, 0, 1, 1], [0, 0, 1, 1]],
                    dtype=float)


def three_blocks(n_per=10, p_in=0.9, p_out=0.05, seed=0):
    rng = np.random.default_rng(seed)
    n = 3 * n_per
    labels = np.repeat(np.arange(3), n_per)
    sim = np.zeros((n, n))
    for i in range(n):
        for j in range(i + 1, n):
            p = p_in if labels[i] == labels[j] else p_out
            if rng.random() < p:
                sim[i, j] = sim[j, i] = rng.uniform(0.5, 1.0)
    np.fill_diagonal(sim, 1.0)
    return sim, labels


def planted_sparse(n_comm, n_per, intra, inter, seed):
    """Sparse planted-partition graph: every node draws ``intra`` random
    same-community edges and ``inter`` cross-community edges.  Returns
    (symmetric CSR adjacency with unit diagonal, labels)."""
    rng = np.random.default_rng(seed)
    n = n_comm * n_per
    labels = np.repeat(np.arange(n_comm), n_per)
    src = np.repeat(np.arange(n), intra)
    dst = labels[src] * n_per + rng.integers(0, n_per, size=len(src))
    xsrc = np.repeat(np.arange(n), inter)
    xdst = rng.integers(0, n, size=len(xsrc))
    w = np.concatenate([rng.uniform(0.5, 1.0, len(src)),
                        rng.uniform(0.1, 0.4, len(xsrc))])
    adj = sparse.csr_matrix(
        (w, (np.concatenate([src, xsrc]), np.concatenate([dst, xdst]))),
        shape=(n, n))
    adj = adj.maximum(adj.T)
    adj.setdiag(1.0)
    return adj.tocsr(), labels


GRAPHS = {
    "two_blocks": lambda: sparse.csr_matrix(block_matrix()),
    "three_blocks": lambda: sparse.csr_matrix(three_blocks(30, seed=2)[0]),
    "noisy_blocks": lambda: sparse.csr_matrix(
        three_blocks(13, p_in=0.6, p_out=0.2, seed=7)[0]),
    "planted": lambda: planted_sparse(10, 80, intra=6, inter=2, seed=4)[0],
    "dense_array": lambda: three_blocks(seed=3)[0],
    "no_edges": lambda: sparse.csr_matrix((5, 5)),
}


@pytest.mark.parametrize("resolution, seed", [(1.0, 0), (1.05, 1), (0.7, 42)])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_louvain_equals_jax(name, resolution, seed):
    adj = GRAPHS[name]()
    got = cluster.louvain(adj, resolution=resolution, seed=seed)
    want = jcluster.louvain(adj, resolution=resolution, seed=seed)
    np.testing.assert_array_equal(got.membership, want.membership)
    assert got.membership.dtype == np.int64
    assert got.modularity == want.modularity
    assert got.n_levels == want.n_levels
    assert isinstance(got, cluster.LouvainResult)
    assert cluster.modularity(adj, got.membership, resolution) == (
        jcluster.modularity(adj, want.membership, resolution))


@pytest.mark.parametrize("name", ["planted", "three_blocks"])
def test_louvain_synchronous_sweep_equals_jax(name):
    """The vectorised first sweep that sets over 20,000 nodes take, forced
    on a small graph."""
    adj = GRAPHS[name]()
    got = cluster.louvain(adj, resolution=1.05, seed=5, sync_threshold=0)
    want = jcluster.louvain(adj, resolution=1.05, seed=5, sync_threshold=0)
    np.testing.assert_array_equal(got.membership, want.membership)
    assert got.modularity == want.modularity
    assert louvain_mod_._SYNC_THRESHOLD == 20_000


@pytest.mark.parametrize("resolution", [1.0, 1.05])
@pytest.mark.parametrize("name", ["three_blocks", "noisy_blocks", "planted"])
def test_louvain_native_pass_equals_numpy_pass(name, resolution, monkeypatch):
    """cpp/louvain_pass.cpp reproduces the numpy greedy pass exactly: same
    memberships, same modularity.  louvain() always runs the native one."""
    adj = GRAPHS[name]()
    assert louvain_mod_._greedy_pass is _native.native_louvain_pass
    got = cluster.louvain(adj, resolution=resolution, seed=3)
    monkeypatch.setattr(louvain_mod_, "_greedy_pass", louvain_mod_._numpy_pass)
    want = cluster.louvain(adj, resolution=resolution, seed=3)
    np.testing.assert_array_equal(got.membership, want.membership)
    assert got.modularity == want.modularity


def test_one_pass_native_equals_numpy_in_place():
    adj = GRAPHS["planted"]()
    indptr = adj.indptr.astype(np.int64)
    indices = adj.indices.astype(np.int64)
    data = adj.data.astype(np.float64)
    strengths = np.asarray(adj.sum(axis=1)).ravel() + adj.diagonal()
    n = adj.shape[0]
    order = np.random.default_rng(0).permutation(n).astype(np.int64)
    state = []
    for fn in (_native.native_louvain_pass, louvain_mod_._numpy_pass):
        comm, sum_tot = np.arange(n, dtype=np.int64), strengths.copy()
        moved = fn(indptr, indices, data, strengths, float(strengths.sum()),
                   1.05, order, comm, sum_tot)
        state.append((moved, comm, sum_tot))
    assert state[0][0] is True and state[1][0] is True
    np.testing.assert_array_equal(state[0][1], state[1][1])
    np.testing.assert_array_equal(state[0][2], state[1][2])


def test_native_pass_checks_its_arrays():
    ok = dict(
        indptr=np.array([0, 0], dtype=np.int64),
        indices=np.array([], dtype=np.int64),
        data=np.array([], dtype=np.float64), strengths=np.array([1.0]),
        two_m=2.0, gamma=1.0, order=np.array([0], dtype=np.int64),
        comm=np.array([0], dtype=np.int64), sum_tot=np.array([1.0]),
    )
    assert _native.native_louvain_pass(**ok) is False
    for name, bad in [("indptr", ok["indptr"].astype(np.int32)),
                      ("order", np.array([0, 0], dtype=np.int64)),
                      ("sum_tot", np.array([1.0], dtype=np.float32))]:
        with pytest.raises(ValueError, match=name):
            _native.native_louvain_pass(**{**ok, name: bad})


def test_failed_native_build_raises(monkeypatch, tmp_path):
    """No quiet fallback: a source the compiler refuses raises, and so does
    louvain when its library cannot be built."""
    (tmp_path / "broken.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(native, "CPP_DIR", str(tmp_path))
    with pytest.raises(subprocess.CalledProcessError):
        native.build_library("broken", ("broken.cpp",))
    _native._lib.cache_clear()
    try:
        with pytest.raises(FileNotFoundError):
            cluster.louvain(GRAPHS["two_blocks"]())
    finally:
        _native._lib.cache_clear()


def test_native_build_flags_keep_strict_iso():
    assert native.CXX_FLAGS == ("-O3", "-march=native", "-fPIC",
                                "-std=c++17", "-shared")
    so = native.build_library("louvain", ("louvain_pass.cpp",))
    assert os.path.basename(os.path.dirname(so)) == "louvain"
    assert os.path.exists(so)


@pytest.mark.parametrize("p", [0.0, 0.5, 0.8, 1.0])
def test_graph_utilities_equal_jax(p):
    sim = three_blocks(seed=1)[0]
    assert cluster.quantile_threshold(sim, p) == (
        jcluster.quantile_threshold(sim, p))
    np.testing.assert_array_equal(cluster.threshold_matrix(sim, p),
                                  jcluster.threshold_matrix(sim, p))
    skew = np.triu(sim) + 0.5 * np.tril(sim, -1)
    for mode, mat in (("upper", skew), ("undirected", sim)):
        for keep_diag in (True, False):
            got = cluster.adjacency_from_matrix(mat, mode, keep_diag)
            want = jcluster.adjacency_from_matrix(mat, mode, keep_diag)
            np.testing.assert_array_equal(got.toarray(), want.toarray())
    assert cluster.quantile_threshold(np.ones((1, 1)), p) == 0.0
    with pytest.raises(ValueError, match="square"):
        cluster.adjacency_from_matrix(np.zeros((3, 4)))
    with pytest.raises(ValueError, match="unknown mode"):
        cluster.adjacency_from_matrix(sim, mode="lower")


def test_quantile_threshold_matches_r_type7():
    sim = np.array([[1.0, 0.2, 0.4], [0.2, 1.0, 0.6], [0.4, 0.6, 1.0]])
    assert cluster.quantile_threshold(sim, 0.5) == pytest.approx(0.4)
    assert cluster.quantile_threshold(sim, 0.8) == pytest.approx(0.52)


def test_netcluster_equals_jax_and_validates():
    out = cluster.netcluster(block_matrix())
    np.testing.assert_array_equal(out, jcluster.netcluster(block_matrix()))
    assert out[0] == out[1] and out[2] == out[3] and out[0] != out[2]
    assert out.min() >= 1  # 1-based like igraph membership
    sim = three_blocks(seed=5)[0]
    np.testing.assert_array_equal(
        cluster.netcluster(sim, resolution=1.2, seed=4),
        jcluster.netcluster(sim, resolution=1.2, seed=4))
    np.testing.assert_array_equal(cluster.netcluster(
        block_matrix(), cluster_func=lambda g: np.array([1, 1, 2, 2])),
        [1, 1, 2, 2])
    with pytest.raises(ValueError, match="square"):
        cluster.netcluster(np.zeros((3, 4)))
    with pytest.raises(ValueError, match="numeric vector"):
        cluster.netcluster(block_matrix(),
                           cluster_func=lambda g: np.zeros((2, 2)))


def test_louvain_mod_equals_jax():
    adj = sparse.csr_matrix(three_blocks(seed=1)[0])
    kw = dict(res=1.0, res_range_perc=0.2, res_step=0.1, itr=2, seed=3)
    got, want = cluster.louvain_mod(adj, **kw), jcluster.louvain_mod(adj, **kw)
    assert set(got) == {"cluster", "resolution", "modularity"}
    np.testing.assert_array_equal(got["cluster"], want["cluster"])
    assert got["resolution"] == want["resolution"]
    assert got["modularity"] == want["modularity"]
    one = cluster.louvain_mod(adj, 1.05)
    np.testing.assert_array_equal(one["cluster"],
                                  jcluster.louvain_mod(adj, 1.05)["cluster"])


def _same_result(got, want):
    np.testing.assert_array_equal(got.clustered_seq, want.clustered_seq)
    assert got.filtered_seq == want.filtered_seq
    assert got.n_calls == want.n_calls
    assert got.converged == want.converged


@pytest.mark.parametrize("kw", [
    {},
    {"thresh_p": 0.6, "size_max": 20, "size_min": 2, "resolution": 1.0,
     "seed": 2},
])
def test_clusterbreak_default_engine_equals_jax_on_evp(kw, capsys):
    seqs = load_sequences("evp_peparray", 200)
    got = dt.clusterbreak(seqs, device="cpu", verbose=False, **kw)
    want = dj.clusterbreak(seqs, verbose=False, **kw)
    _same_result(got, want)
    assert isinstance(got, dt.ClusterBreakResult)
    assert set(got.as_dict()) == {"clustered_seq", "filtered_seq"}
    assert got.clustered_seq.shape[1] == 2
    assert len(got.clustered_seq) + len(got.filtered_seq) == len(seqs)
    assert capsys.readouterr().out == ""
    # the default engine against per-subset similarity_mh calls
    per_call = dt.clusterbreak(
        seqs, verbose=False, **kw,
        sim_fn=lambda x: dt.similarity_mh(x, k=2, n_hash=50,
                                          seed=kw.get("seed", 0),
                                          device="cpu"))
    _same_result(got, per_call)


def test_clusterbreak_reports_like_jax(capsys):
    seqs = load_sequences("evp_peparray", 60)
    dt.clusterbreak(seqs, device="cpu")
    ours = capsys.readouterr().out
    dj.clusterbreak(seqs)
    assert ours == capsys.readouterr().out
    assert "Clustering complete:" in ours


def test_clusterbreak_with_injected_functions_needs_no_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    seqs = load_sequences("evp_peparray", 40)
    eng = dt.MinHashEngine(seqs, k=2, n_hash=50, device="cpu")
    fn = lambda g: np.arange(g.shape[0]) % 3 + 1  # noqa: E731
    got = dt.clusterbreak(seqs, sim_fn=eng, cluster_fn=fn, verbose=False)
    want = dj.clusterbreak(seqs, sim_fn=eng, cluster_fn=fn, verbose=False)
    _same_result(got, want)


def test_clusterbreak_validation_and_max_itr():
    with pytest.raises(ValueError, match="size_max"):
        dt.clusterbreak(["AA"], size_max=2, size_min=3, device="cpu")
    with pytest.raises(ValueError, match="empty"):
        dt.clusterbreak([], device="cpu")
    rng = np.random.default_rng(1)
    seqs = ["".join(rng.choice(list("ARND"), size=8)) for _ in range(30)]

    def two_blocks(x):
        n, h = len(x), len(x) // 2
        sim = np.full((n, n), 0.05)
        sim[:h, :h] = 0.9
        sim[h:, h:] = 0.9
        np.fill_diagonal(sim, 1.0)
        return sim

    kw = dict(size_max=4, size_min=1, max_itr=3, verbose=False,
              sim_fn=two_blocks)
    got = dt.clusterbreak(seqs, **kw)
    assert not got.converged
    _same_result(got, dj.clusterbreak(seqs, **kw))


def test_clusterbreak_leaves_a_cached_matrix_unchanged():
    """A user sim_fn that hands back one cached writable matrix per subset
    gets every one back unchanged across the recursion (a second run reads
    the cache alone), and the labels equal the JAX package's clusterbreak
    on the same input; only the in-package engines are thresholded in
    place."""
    seqs = load_sequences("evp_peparray", 200)
    kw = dict(size_max=8, size_min=2, verbose=False)
    cache = {}

    def cached(x):
        key = tuple(x)
        if key not in cache:
            cache[key] = dt.similarity_mh(x, k=2, n_hash=50, device="cpu")
        return cache[key]

    got = dt.clusterbreak(seqs, sim_fn=cached, **kw)
    assert got.n_calls > 4 and len(cache) == got.n_calls
    for key, sim in cache.items():
        assert sim.flags.writeable
        np.testing.assert_array_equal(
            sim, dt.similarity_mh(list(key), k=2, n_hash=50, device="cpu"))
    _same_result(dt.clusterbreak(seqs, sim_fn=cached, **kw), got)
    _same_result(dt.Pipeline(sim_fn=cached).cluster(seqs, **kw), got)
    _same_result(got, dj.clusterbreak(
        seqs, sim_fn=lambda x: dj.similarity_mh(x, k=2, n_hash=50), **kw))
    _same_result(got, dt.clusterbreak(seqs, device="cpu", **kw))
    assert cb_mod._fresh_each_call(dt.Pipeline(device="cpu").similarity)
    assert not cb_mod._fresh_each_call(dt.Pipeline(sim_fn=cached).similarity)
    assert not cb_mod._fresh_each_call(cached)


def test_clusterbreak_checkpoint_resume(tmp_path):
    """A run interrupted after its checkpoint resumes to the same result
    as an uninterrupted run, and as the JAX package's."""
    seqs = load_sequences("evp_peparray", 200)
    kw = dict(size_max=8, size_min=2, verbose=False)
    want = dt.clusterbreak(seqs, device="cpu", **kw)
    assert want.n_calls > 4
    path = str(tmp_path / "cb.ckpt")
    eng = dt.MinHashEngine(seqs, k=2, n_hash=50, device="cpu")
    calls = []

    def dies_on_fourth(x):
        calls.append(len(x))
        if len(calls) == 4:
            raise KeyboardInterrupt
        return eng(x)

    with pytest.raises(KeyboardInterrupt):
        dt.clusterbreak(seqs, sim_fn=dies_on_fourth, checkpoint_path=path,
                        checkpoint_every=1, **kw)
    assert os.path.exists(path)
    state = cb_mod._load_checkpoint(path)
    assert state["itr"] == 3 and state["input_fingerprint"][0] == 200
    with pytest.raises(ValueError, match="does not match"):
        dt.clusterbreak(seqs[:50], device="cpu", checkpoint_path=path, **kw)
    # the JAX package resumes from the port's checkpoint, and the port too
    with open(path, "rb") as f:
        saved = f.read()
    jres = dj.clusterbreak(seqs, checkpoint_path=path, **kw)
    with open(path, "wb") as f:
        f.write(saved)
    got = dt.clusterbreak(seqs, device="cpu", checkpoint_path=path, **kw)
    assert not os.path.exists(path)  # cleared when the run completes
    _same_result(got, want)
    _same_result(jres, want)
    _same_result(want, dj.clusterbreak(seqs, **kw))


def test_config_dataclasses_equal_jax():
    names = ["MinHashConfig", "NWConfig", "ClusterBreakConfig",
             "ConsensusConfig", "HybridConfig", "PipelineConfig"]
    for name in names:
        ours, theirs = getattr(config, name)(), getattr(jconfig, name)()
        assert dataclasses.is_dataclass(ours)
        flat = lambda d: {k: (dataclasses.asdict(v)  # noqa: E731
                              if dataclasses.is_dataclass(v) else v)
                          for k, v in dataclasses.asdict(d).items()}
        assert flat(ours) == flat(theirs)
        with pytest.raises(dataclasses.FrozenInstanceError):
            ours.__class__.__setattr__(ours, "x", 1)
    assert config.HybridConfig(top_k=8).top_k == 8


def test_logging_helpers(capsys):
    from dynaalign_torch.utils import get_logger, log_message

    log_message("hello", "WARNING")
    out = capsys.readouterr().out
    assert out.endswith("WARNING: hello\n") and out.startswith("[")
    logger = get_logger()
    assert logger.name == "dynaalign_torch" and get_logger() is logger


def test_clusterbreak_default_device_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dt.clusterbreak(["ARNDCQ", "ARNDCE", "WWYYPP"], verbose=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dt.clusterbreak(["ARNDCQ", "ARNDCE", "WWYYPP"], verbose=False,
                        device="cuda")


def test_cluster_modules_do_not_load_jax():
    code = (
        "import dynaalign_torch, dynaalign_torch.cluster, "
        "dynaalign_torch.config, dynaalign_torch.ops.topk_graph, "
        "dynaalign_torch.ops.minhash, dynaalign_torch.utils.native, sys; "
        "assert not any(m == 'jax' or m.startswith('jax.') "
        "for m in sys.modules)"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    root = os.path.dirname(os.path.dirname(os.path.abspath(dt.__file__)))
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   cwd=root)
