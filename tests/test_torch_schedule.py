"""The port's NW planners against the JAX package's on every case of
tests/test_schedule_stats.py, and the sharded NW functions against the plans:
each rank of a mesh launches exactly the real pairs its share of the plan
holds, and the ranks together launch every upper-triangle pair once.

A rank is simulated here by a Mesh with no process group: it computes its
share and sums nothing."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402,F401

from dynaalign_tpu.parallel import allpairs as jap  # noqa: E402

from dynaalign_torch import blosum  # noqa: E402
from dynaalign_torch.encode import encode  # noqa: E402
from dynaalign_torch.parallel import allpairs as ap  # noqa: E402
from dynaalign_torch.parallel.mesh import (  # noqa: E402
    Mesh,
    _near_square_factors,
)

UNIFORM = [(1000, 16, 8), (1000, 16, 4), (257, 16, 8), (8103, 16, 8),
           (100, 8, 2)]


def _mixed_panel(n_short=300, n_long=100, seed=0):
    """tests/test_schedule_stats.py's panel."""
    rng = np.random.default_rng(seed)
    aas = list("ARNDCQEGHILKMFPSTWYV")
    seqs = ["".join(rng.choice(aas, size=12)) for _ in range(n_short)]
    seqs += [
        "".join(rng.choice(aas, size=int(rng.integers(500, 580))))
        for _ in range(n_long)
    ]
    return seqs


@pytest.mark.parametrize("n,tile,ndev", UNIFORM)
def test_uniform_stats_equal_jax(n, tile, ndev):
    s = ap.nw_allpairs_schedule_stats(n, tile, ndev)
    assert s == jap.nw_allpairs_schedule_stats(n, tile, ndev)
    assert s["tile_spread"] == 0 and s["balance"] == 1.0
    if n >= 1000:
        assert s["pad_efficiency"] >= 0.9


@pytest.mark.parametrize("n,tile,ndev,cap", [
    (100, 16, 8, 1024), (41, 8, 2, 8), (41, 8, 4, 16), (1000, 16, 1, 1024),
    (1000, 16, 8, 64), (3, 16, 4, 1024),
])
def test_uniform_plan_equals_jax(n, tile, ndev, cap):
    got = ap.plan_nw_allpairs(n, tile, ndev, cap)
    want = jap.plan_nw_allpairs(n, tile, ndev, cap)
    assert got[0] == want[0] and got[3:] == want[3:]
    for a, b in zip(got[1:3], want[1:3]):
        np.testing.assert_array_equal(a, b)
    tiles, order, inv_order, group, seg = got
    nb = -(-n // tile)
    assert {(i, j) for i in range(nb) for j in range(i, nb)} <= set(tiles)
    np.testing.assert_array_equal(np.arange(len(tiles))[order][inv_order],
                                  np.arange(len(tiles)))
    assert len(tiles) % seg == 0 and seg % (ndev * group) == 0


@pytest.mark.parametrize("ndev", [2, 4, 8])
def test_bucketed_stats_equal_jax(ndev):
    s = ap.bucketed_schedule_stats(_mixed_panel(), ndev=ndev)
    assert s == jap.bucketed_schedule_stats(_mixed_panel(), ndev=ndev)
    assert s["area_spread"] == 0.0 and s["balance"] == 1.0
    assert s["pad_efficiency"] >= 0.8


def test_group_batch_equals_jax_without_the_lane_rule():
    for npairs in (1, 7, 31, 32, 33, 100, 255, 256, 257, 1000, 5000):
        for ndev in (1, 2, 3, 4, 8):
            for max_batch in (16, 32, 64, 200, 256, 512):
                want = jap.pick_group_batch(npairs, ndev, max_batch, False)
                assert ap.pick_group_batch(npairs, ndev, max_batch) == want
                assert ap.plan_bucket_group(npairs, ndev, max_batch) == \
                    jap.plan_bucket_group(npairs, ndev, max_batch, False)


def _launched(monkeypatch):
    """Record the (row, column) sequence pairs each _pairs_nw call gets;
    report matches = length = 1."""
    calls = []

    def record(idx_a, len_a, idx_b, len_b, rows, cols, *args):
        calls.append((rows.numpy().copy(), cols.numpy().copy()))
        ones = np.ones(rows.numel(), dtype=np.int32)
        return ones, ones

    monkeypatch.setattr(ap, "_pairs_nw", record)
    return calls


def _rank_mesh(ndev, rank):
    return Mesh(np.arange(ndev).reshape(_near_square_factors(ndev)), rank,
                torch.device("cpu"))


@pytest.mark.parametrize("n,tile,ndev,cap", [
    (41, 8, 2, 8), (41, 8, 4, 16), (100, 8, 8, 1024), (37, 4, 3, 12),
    (5, 16, 4, 1024),
])
def test_uniform_sharding_runs_the_plan(n, tile, ndev, cap, monkeypatch):
    """Rank d launches the real pairs of the d-th chunk of each segment:
    its tiles' pairs with i <= j < n, nothing of a dummy tile, and the
    ranks cover the upper triangle exactly once."""
    calls = _launched(monkeypatch)
    enc = encode(["A" * (1 + i % 7) for i in range(n)])
    sub = blosum.get_matrix().numpy()
    tiles, order, _, _, seg = ap.plan_nw_allpairs(n, tile, ndev, cap)
    nb = -(-n // tile)
    seen = []
    for d in range(ndev):
        calls.clear()
        ap.sharded_nw_allpairs(enc.indices, enc.lengths, sub, tile=tile,
                               max_tiles_per_dispatch=cap,
                               mesh=_rank_mesh(ndev, d))
        got = {(int(i), int(j)) for r, c in calls for i, j in zip(r, c)}
        assert sum(len(r) for r, _ in calls) == len(got)
        want = set()
        for s in range(len(tiles) // seg):
            chunk = seg // ndev
            for t in order[s * seg + d * chunk : s * seg + (d + 1) * chunk]:
                if t >= nb * (nb + 1) // 2:
                    continue  # a dummy tile
                bi, bj = tiles[t]
                want |= {(i, j)
                         for i in range(bi * tile, min(bi * tile + tile, n))
                         for j in range(bj * tile, min(bj * tile + tile, n))
                         if i <= j}
        assert got == want
        seen.extend(got)
    assert sorted(seen) == [(i, j) for i in range(n) for j in range(i, n)]


@pytest.mark.parametrize("ndev,batch", [(2, 32), (3, 16), (4, 256)])
def test_bucketed_sharding_runs_the_plan(ndev, batch, monkeypatch):
    """In every bucket-pair group, rank d launches batch t (of
    plan_bucket_group's size) when t % ndev == d, and no padding pair."""
    calls = _launched(monkeypatch)
    rng = np.random.default_rng(3)
    seqs = ["A" * int(k) for k in rng.integers(1, 70, size=60)]
    sub = blosum.get_matrix().numpy()
    edges = (15, 31, 63, 127)
    counts = {}
    for d in range(ndev):
        calls.clear()
        ap.sharded_nw_allpairs_bucketed(seqs, sub, bucket_edges=edges,
                                        batch=batch,
                                        mesh=_rank_mesh(ndev, d))
        counts[d] = [len(r) for r, _ in calls]
    which = np.searchsorted(edges, [len(s) for s in seqs])
    iu = np.triu_indices(len(seqs))
    group = which[iu[0]] * len(edges) + which[iu[1]]
    for d in range(ndev):
        want = []
        for g in np.unique(group):
            npairs = int((group == g).sum())
            batch_g, t_batches, _ = ap.plan_bucket_group(npairs, ndev, batch)
            mine = sum(min(batch_g, max(npairs - t * batch_g, 0))
                       for t in range(d, t_batches, ndev))
            if mine:
                want.append(mine)
        assert counts[d] == want
    assert sum(map(sum, counts.values())) == len(iu[0])
