"""The port's Pipeline on the CPU against the JAX package's: every
similarity engine on planted families and on evp_peparray[:120], injected
sim_fn / cluster_fn, and the device rule.  Tolerance 0."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402,F401

from dynaalign_tpu import config as jconfig  # noqa: E402
from dynaalign_tpu import models as jmodels  # noqa: E402

import dynaalign_torch as dt  # noqa: E402
from dynaalign_torch import config  # noqa: E402
from dynaalign_torch.io.datasets import load_sequences  # noqa: E402

AAS = list("ARNDCQEGHILKMFPSTWYV")
ENGINES = ["mh", "nw", "nw_bucketed", "hybrid"]


def _family_seqs(seed, n_fam=3, per=8, length=18, muts=2):
    rng = np.random.default_rng(seed)
    seqs = []
    for b in ["".join(rng.choice(AAS, size=length)) for _ in range(n_fam)]:
        for _ in range(per):
            s = list(b)
            for _ in range(muts):
                s[rng.integers(length)] = rng.choice(AAS)
            seqs.append("".join(s))
    return seqs


def _configs(mod, engine, data):
    """The same PipelineConfig built from either package's config module."""
    if data == "families":
        mh = mod.MinHashConfig(k=2, n_hash=64, seed=1)
        cb = mod.ClusterBreakConfig(thresh_p=0.6, size_max=15, size_min=2)
    else:  # the README quick-start configuration on a subset
        mh = mod.MinHashConfig(k=2, n_hash=50)
        cb = mod.ClusterBreakConfig(thresh_p=0.8, size_max=30, size_min=2,
                                    max_itr=50)
    return mod.PipelineConfig(similarity=engine, minhash=mh, clusterbreak=cb,
                              hybrid=mod.HybridConfig(0.7))


DATA = {
    "families": lambda: _family_seqs(0),
    "evp120": lambda: load_sequences("evp_peparray", 120),
}


def _same(got, want):
    assert isinstance(got, dt.PipelineResult)
    assert got.similarity is None and want.similarity is None
    np.testing.assert_array_equal(got.clusters.clustered_seq,
                                  want.clusters.clustered_seq)
    assert got.clusters.filtered_seq == want.clusters.filtered_seq
    assert got.clusters.converged == want.clusters.converged
    assert got.clusters.n_calls == want.clusters.n_calls
    assert got.consensus.dtype == object
    assert got.consensus.tolist() == want.consensus.tolist()


@pytest.mark.parametrize("data", sorted(DATA))
@pytest.mark.parametrize("engine", ENGINES)
def test_pipeline_equals_jax(engine, data):
    seqs = DATA[data]()
    got = dt.Pipeline(_configs(config, engine, data), device="cpu").run(seqs)
    want = jmodels.Pipeline(_configs(jconfig, engine, data)).run(seqs)
    _same(got, want)
    n = len(seqs)
    assert len(got.clusters.clustered_seq) + len(
        got.clusters.filtered_seq) == n
    assert len(got.consensus) == len(
        set(got.clusters.clustered_seq[:, 1].tolist()))


@pytest.mark.parametrize("engine", ENGINES)
def test_pipeline_similarity_equals_jax(engine):
    seqs = _family_seqs(2, n_fam=2, per=6)
    got = dt.Pipeline(_configs(config, engine, "families"),
                      device="cpu").similarity(seqs)
    want = jmodels.Pipeline(_configs(jconfig, engine, "families")
                            ).similarity(seqs)
    assert got.dtype == np.float64
    np.testing.assert_array_equal(got, want)


def test_pipeline_injected_functions_equal_jax(monkeypatch):
    """sim_fn replaces every similarity call and cluster_fn the Louvain
    step, in both packages alike; neither needs the card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    seqs = _family_seqs(4, n_fam=3, per=7)
    eng = dt.MinHashEngine(seqs, k=2, n_hash=48, device="cpu")
    calls = []

    def sim_fn(x):
        calls.append(len(x))
        return eng(x)

    def cluster_fn(g):
        return np.arange(g.shape[0]) % 3 + 1

    cfg_t = config.PipelineConfig(clusterbreak=config.ClusterBreakConfig(
        size_max=6, size_min=2))
    cfg_j = jconfig.PipelineConfig(clusterbreak=jconfig.ClusterBreakConfig(
        size_max=6, size_min=2))
    for kw in ({"sim_fn": sim_fn}, {"sim_fn": sim_fn,
                                    "cluster_fn": cluster_fn}):
        got = dt.Pipeline(cfg_t, **kw).run(seqs)
        want = jmodels.Pipeline(cfg_j, **kw).run(seqs)
        _same(got, want)
    assert calls and calls[0] == len(seqs)
    np.testing.assert_array_equal(
        dt.Pipeline(cfg_t, sim_fn=sim_fn).similarity(seqs), eng(seqs))


def test_pipeline_cluster_overrides_and_empty_consensus():
    seqs = _family_seqs(5)
    pipe = dt.Pipeline(_configs(config, "mh", "families"), device="cpu")
    jpipe = jmodels.Pipeline(_configs(jconfig, "mh", "families"))
    for kw in ({"size_max": 5, "size_min": 4}, {"thresh_p": 0.3}):
        got, want = pipe.cluster(seqs, **kw), jpipe.cluster(seqs, **kw)
        np.testing.assert_array_equal(got.clustered_seq, want.clustered_seq)
        assert got.filtered_seq == want.filtered_seq
    # everything filtered: no consensus rows, shape (0, 2)
    out = pipe.run(seqs, size_min=30, size_max=40)
    assert out.consensus.shape == (0, 2)
    assert len(out.clusters.filtered_seq) == len(seqs)
    assert out.consensus.shape == jpipe.run(
        seqs, size_min=30, size_max=40).consensus.shape


def test_pipeline_consensus_uses_its_config():
    seqs = _family_seqs(6)
    cfg = config.PipelineConfig(
        minhash=config.MinHashConfig(k=2, n_hash=64),
        clusterbreak=config.ClusterBreakConfig(thresh_p=0.6, size_max=15,
                                               size_min=2),
        consensus=config.ConsensusConfig("BLOSUM45", 0.3))
    pipe = dt.Pipeline(cfg, device="cpu")
    clusters = pipe.cluster(seqs)
    got = pipe.consensus(clusters)
    want = dt.cluster_consensus(clusters.clustered_seq,
                                matrix_name="BLOSUM45", threshold=0.3)
    assert got.tolist() == want.tolist()


def test_pipeline_unknown_engine_and_device_rule(monkeypatch):
    cfg = config.PipelineConfig(similarity="smith-waterman")
    with pytest.raises(ValueError, match="unknown similarity engine"):
        dt.Pipeline(cfg, device="cpu").similarity(["ARND", "ARNE"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for dev in (None, "cuda"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            dt.Pipeline(device=dev).run(_family_seqs(7, n_fam=1, per=5))
    assert dt.Pipeline().device is None
    assert dt.Pipeline().config == config.PipelineConfig()
