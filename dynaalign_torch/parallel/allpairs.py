"""All-pairs similarity across the ranks of a mesh (the distributed core).

Every rank runs its share through the port's single-device code on its own
device, writes it into a zero-filled tensor of the whole result, and the
mesh's process group sums those tensors with one ``all_reduce``: each entry
is written by exactly one rank, so the sum is exact and every rank ends
with the whole result, equal byte for byte to the single-device call.
NCCL sums tensors on the card, gloo sums host tensors.

* **MinHash**: signatures are built row-sharded over the flattened mesh and
  shared; each (row, column) rank counts its [N/pr, N/pc] block of the
  agreement matrix (:func:`sharded_signature_agreement`).
* **NW**: :func:`plan_nw_allpairs` lays the upper-triangle pair tiles out
  in dispatch segments, each split into one contiguous chunk per rank;
  :func:`sharded_nw_allpairs` launches the real pairs of its chunks (no
  padding pairs, no dummy tiles) through ``api._pairs_nw``, so the padded
  width picks ``nw_gotoh`` or ``nw_gotoh_xl``.  The bucketed form deals
  each bucket-pair group's batches round-robin (:func:`plan_bucket_group`).
* **Top-k**: rows are split over the flattened mesh; each rank keeps the
  top-k of its whole rows (:func:`sharded_minhash_topk`).

The planners are the JAX package's, in numpy, with their outputs; the
sharded functions execute them, so the statistics describe the real
split.  Ranks outside the mesh run nothing and get None.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..api import BUCKET_EDGES, DEFAULT_CHUNK, _fill, _pairs_nw, _ratio
from ..encode import bucket_by_length
from ..ops.minhash import (
    as_signatures,
    block_counts,
    counts_to_similarity,
    minhash_signatures,
    row_block,
)
from ..ops.topk_graph import _topk_block, _topk_lists
from .mesh import Mesh, block_sharded, make_mesh, row_sharded

__all__ = [
    "sharded_signature_agreement",
    "sharded_minhash_similarity",
    "sharded_nw_allpairs",
    "sharded_nw_allpairs_bucketed",
    "plan_nw_allpairs",
    "nw_allpairs_schedule_stats",
    "plan_bucket_group",
    "bucketed_schedule_stats",
    "sharded_minhash_topk",
]

# tiles (or pair batches) one rank takes as a run within a segment; the
# JAX package's default (its DYNAALIGN_NW_GROUP is not read)
_SHARDED_GROUP = 8


def plan_bucket_group(
    npairs: int, ndev: int, max_batch: int
) -> tuple[int, int, int]:
    """(batch_g, t_batches, group_g) for one bucket-pair group: the
    quantities sharded_nw_allpairs_bucketed deals out.  t_batches * batch_g
    slots (>= npairs) are planned; only the npairs
    real ones."""
    batch_g = pick_group_batch(npairs, ndev, max_batch)
    t_batches = max(-(-npairs // batch_g), 1)
    group_g = min(_SHARDED_GROUP, max(t_batches // ndev, 1))
    t_batches = -(-t_batches // (ndev * group_g)) * ndev * group_g
    return batch_g, t_batches, group_g


def bucketed_schedule_stats(
    sequences, *, ndev: int, bucket_edges=None, batch: int = 256,
) -> dict:
    """Static per-rank load statistics for the bucketed NW schedule.

    Per group every batch has equal padded cost (area = the two bucket
    edges' padded product), and t_batches is a whole multiple of
    ndev * group_g, so per-rank batch counts are equal within every group.
    Reports the per-rank area totals and the area-weighted pad-efficiency
    (real pair area / planned slot area).
    """
    seqs = list(sequences)
    n = len(seqs)
    if bucket_edges is None:
        bucket_edges = BUCKET_EDGES
    buckets = bucket_by_length(seqs, bucket_edges=tuple(bucket_edges))
    which = np.zeros(n, dtype=np.int64)
    for b, (pos, _) in enumerate(buckets):
        which[pos] = b
    iu = np.triu_indices(n)
    groups: dict[tuple[int, int], int] = {}
    for gi, gj in zip(which[iu[0]], which[iu[1]]):
        key = (int(gi), int(gj))
        groups[key] = groups.get(key, 0) + 1
    per_dev_area = np.zeros(ndev, dtype=np.float64)
    real_area = 0.0
    slot_area = 0.0
    for (ba, bb), npairs in groups.items():
        area = float(buckets[ba][1].max_len) * float(buckets[bb][1].max_len)
        batch_g, t_batches, _ = plan_bucket_group(npairs, ndev, batch)
        per_dev_area += (t_batches // ndev) * batch_g * area
        real_area += npairs * area
        slot_area += t_batches * batch_g * area
    return {
        "ndev": ndev,
        "area_per_device": per_dev_area.tolist(),
        "area_spread": float(
            (per_dev_area.max() - per_dev_area.min())
            / max(per_dev_area.max(), 1.0)
        ),
        "balance": float(per_dev_area.mean() / per_dev_area.max()),
        "pad_efficiency": real_area / slot_area,
        "n_groups": len(groups),
    }


def pick_group_batch(npairs: int, ndev: int, max_batch: int) -> int:
    """Pair-batch size for one bucket-pair group: the largest candidate
    that minimises planned slots (the quantum is ndev * batch pairs, so
    small groups take smaller batches)."""

    def slots(b):
        return -(-npairs // (ndev * b)) * ndev * b

    cands = [b for b in (256, 128, 64, 32) if b <= max_batch] or [max_batch]
    best = min(slots(b) for b in cands)
    return next(b for b in cands if slots(b) == best)


def plan_nw_allpairs(
    n: int, tile: int, ndev: int, max_tiles_per_dispatch: int = 1024
):
    """The tile schedule sharded_nw_allpairs executes.

    Returns (tiles, order, inv_order, group, seg): the upper-triangle tile
    list padded with dummy (0, 0) tiles to whole segments, the
    within-segment rank interleave, its inverse, the run length and the
    segment length.  Rank d takes the d-th contiguous chunk of each
    segment of the reordered list.
    """
    nb = -(-n // tile)
    tiles = [(bi, bj) for bi in range(nb) for bj in range(bi, nb)]
    group = min(_SHARDED_GROUP, max(len(tiles) // ndev, 1))
    while len(tiles) % (ndev * group):
        tiles.append((0, 0))
    quantum = ndev * group
    seg = min(
        len(tiles), max(max_tiles_per_dispatch // quantum, 1) * quantum
    )
    while len(tiles) % seg:
        tiles.append((0, 0))
    order = np.concatenate([
        s * seg + np.argsort(np.arange(seg) % ndev, kind="stable")
        for s in range(len(tiles) // seg)
    ])
    inv_order = np.argsort(order, kind="stable")
    return tiles, order, inv_order, group, seg


def nw_allpairs_schedule_stats(
    n: int, tile: int, ndev: int, max_tiles_per_dispatch: int = 1024
) -> dict:
    """Static per-rank load statistics for the uniform NW schedule.

    Every rank takes seg / ndev tiles of each segment, so balance is the
    per-rank tile-count spread.  ``pad_efficiency`` is the fraction of
    planned pair slots that are real upper-triangle pairs (the rest:
    dummy tiles, the lower halves of diagonal tiles and indices past n,
    none of which is launched).
    """
    tiles, _, _, group, seg = plan_nw_allpairs(
        n, tile, ndev, max_tiles_per_dispatch
    )
    n_tiles = len(tiles)
    per_dev = np.full(ndev, (n_tiles // seg) * (seg // ndev), dtype=np.int64)
    return {
        "ndev": ndev,
        "tiles_per_device": per_dev.tolist(),
        "tile_spread": int(per_dev.max() - per_dev.min()),
        "balance": float(per_dev.mean() / per_dev.max()),
        "pad_efficiency": n * (n + 1) // 2 / (n_tiles * tile * tile),
        "n_tiles": n_tiles,
        "segments": n_tiles // seg,
        "group": group,
    }


def _mesh(mesh: Mesh | None, device) -> Mesh:
    if mesh is None:
        return make_mesh(device=device)
    if device is not None:
        raise ValueError("pass a mesh or a device, not both: the mesh "
                         "names its device")
    return mesh


def _zeros(mesh: Mesh, shape, dtype) -> torch.Tensor:
    """The tensor each rank writes its share into: on the card when NCCL
    sums it, on the host under gloo or with no process group."""
    on_card = (mesh.group is not None
               and dist.get_backend(mesh.group) == "nccl")
    return torch.zeros(shape, dtype=dtype,
                       device=mesh.device if on_card else "cpu")


def _sum_shares(mesh: Mesh, full: torch.Tensor) -> np.ndarray:
    """Every rank's ``full`` holds its own entries and zeros elsewhere;
    each entry is written by one rank, so the sum, which every rank
    receives, is the whole result, exactly."""
    if mesh.group is not None:
        dist.all_reduce(full, group=mesh.group)
    return full.cpu().numpy()


def _nonempty(s: slice) -> bool:
    return s.stop > s.start


def sharded_signature_agreement(
    sigs, mesh: Mesh | None = None, *, device=None
) -> np.ndarray | None:
    """All-pairs agreement counts on a 2-D mesh: rank (r, c) counts its
    [N/pr, N/pc] block of the replicated signatures (uint32 [N, H], or the
    int32 bit-pattern tensor).  Returns int32 [N, N]."""
    mesh = _mesh(mesh, device)
    part = block_sharded(mesh).local(len(sigs))
    if part is None:
        return None
    rows, cols = part
    n = len(sigs)
    full = _zeros(mesh, (n, n), torch.int32)
    if _nonempty(rows) and _nonempty(cols):
        sigs = as_signatures(sigs, mesh.device)
        mine, other = sigs[rows], sigs[cols]
        block = row_block(len(other), sigs.shape[1])
        for s in range(0, len(mine), block):
            e = min(s + block, len(mine))
            full[rows.start + s : rows.start + e, cols] = block_counts(
                mine, s, e, other).to(full.device)
    return _sum_shares(mesh, full)


def sharded_minhash_similarity(
    ascii_tokens: np.ndarray,
    lengths: np.ndarray,
    *,
    k: int = 4,
    n_hash: int = 50,
    seed: int = 0,
    mesh: Mesh | None = None,
    device=None,
) -> np.ndarray | None:
    """Full MinHash similarity on a mesh: signatures built row-sharded over
    the flattened mesh and shared, then the block-sharded agreement.
    Returns float64 [N, N], equal to ``similarity_mh``."""
    if k <= 0:
        raise ValueError("'k' must be a positive integer")
    if n_hash <= 0:
        raise ValueError("Number of hash functions must be positive")
    mesh = _mesh(mesh, device)
    n = len(lengths)
    part = row_sharded(mesh.flat()).local(n)
    if part is None:
        return None
    rows = part[0]
    full = _zeros(mesh, (n, n_hash), torch.int32)
    if _nonempty(rows):
        full[rows] = minhash_signatures(
            ascii_tokens[rows], lengths[rows], k=k, n_hash=n_hash, seed=seed,
            device=mesh.device,
        ).to(full.device)
    sigs = _sum_shares(mesh, full).view(np.uint32)
    return counts_to_similarity(sharded_signature_agreement(sigs, mesh),
                                n_hash)


def _tile_pairs(tiles: np.ndarray, tile: int, n: int):
    """(i, j), int64, of the real pairs of pair tiles [T, 2] (block row,
    block column): i <= j < n, tile by tile, row-major within a tile."""
    off = np.arange(tile)
    i = tiles[:, 0, None, None] * tile + off[None, :, None]
    j = tiles[:, 1, None, None] * tile + off[None, None, :]
    i, j = np.broadcast_arrays(i, j)
    keep = (i <= j) & (j < n)
    return i[keep], j[keep]


def _triangle_index(i: np.ndarray, j: np.ndarray, n: int) -> np.ndarray:
    """Position of pair (i, j), i <= j, in np.triu_indices(n)'s order."""
    return i * n - i * (i - 1) // 2 + (j - i)


def _launch_into(full, p, idx_a, len_a, idx_b, len_b, ti, tj, sub,
                 gap_open, gap_ext, dev):
    """NW of pairs (idx_a[ti], idx_b[tj]) through the single-device
    launches, written at triangle positions ``p`` of ``full`` [2, P]."""
    mt, ln = _pairs_nw(idx_a, len_a, idx_b, len_b,
                       torch.from_numpy(ti).to(dev),
                       torch.from_numpy(tj).to(dev), sub, gap_open, gap_ext,
                       DEFAULT_CHUNK)
    p = torch.from_numpy(p).to(full.device)
    full[0, p] = torch.from_numpy(mt).to(full.device)
    full[1, p] = torch.from_numpy(ln).to(full.device)


def sharded_nw_allpairs(
    seq_idx: np.ndarray,
    lengths: np.ndarray,
    sub: np.ndarray,
    *,
    tile: int = 16,
    gap_open: int = 10,
    gap_ext: int = 4,
    mesh: Mesh | None = None,
    max_tiles_per_dispatch: int = 1024,
    progress: bool = False,
    device=None,
) -> np.ndarray | None:
    """All-pairs NW percent identity on a mesh.  Returns float64 [N, N],
    equal to ``similarity_nw``.

    The upper-triangle tile grid (diagonal tiles included, as the
    reference's loop src/pairwiseSeqAlign.cpp:340-352 runs i <= j) is laid
    out by :func:`plan_nw_allpairs` in segments of at most
    ``max_tiles_per_dispatch`` tiles; each rank launches the real pairs of
    its chunk of each segment, the lower index as sequence 1.
    ``progress`` prints one line per segment.
    """
    mesh = _mesh(mesh, device)
    me = mesh.flat().index
    if me is None:
        return None
    ndev, n = mesh.size, len(lengths)
    nb = -(-n // tile)
    tiles, order, _, _, seg = plan_nw_allpairs(
        n, tile, ndev, max_tiles_per_dispatch)
    tiles = np.asarray(tiles, dtype=np.int64)
    dev = mesh.device
    idx = torch.from_numpy(np.asarray(seq_idx, np.int32)).to(dev)
    lens = torch.from_numpy(np.asarray(lengths, np.int32)).to(dev)
    sub = torch.as_tensor(sub).to(dev, torch.int32)
    full = _zeros(mesh, (2, n * (n + 1) // 2), torch.int32)
    chunk = seg // ndev
    n_disp = len(tiles) // seg
    for s in range(n_disp):
        if progress:
            print(f"nw: dispatch {s + 1}/{n_disp} ({seg} tiles each)",
                  flush=True)
        mine = order[s * seg + me * chunk : s * seg + (me + 1) * chunk]
        # the plan's dummy tiles sit past the nb (nb + 1) / 2 real ones
        ti, tj = _tile_pairs(tiles[mine[mine < nb * (nb + 1) // 2]], tile, n)
        if len(ti):
            _launch_into(full, _triangle_index(ti, tj, n), idx, lens, idx,
                         lens, ti, tj, sub, gap_open, gap_ext, dev)
    out = _sum_shares(mesh, full)
    return _fill(n, _ratio(out[0], out[1]))


def sharded_nw_allpairs_bucketed(
    sequences,
    sub: np.ndarray,
    *,
    bucket_edges=None,
    batch: int = 256,
    gap_open: int = 10,
    gap_ext: int = 4,
    mesh: Mesh | None = None,
    device=None,
) -> np.ndarray | None:
    """Length-bucketed all-pairs NW on a mesh, equal to
    ``similarity_nw_bucketed`` (and so to ``similarity_nw``).

    Sequences are grouped into padded length buckets (default the JAX
    package's edges, ``api.BUCKET_EDGES``); every (bucket_a, bucket_b)
    group runs at its own padded shape, in pair batches of
    :func:`plan_bucket_group`'s size, batch t on rank t % ndev, the JAX
    interleave.  The smaller global index stays sequence 1
    (src/pairwiseSeqAlign.cpp:340-343).  Returns float64 [N, N].
    """
    seqs = list(sequences)
    n = len(seqs)
    if n == 0:
        raise ValueError("Input sequences vector cannot be empty")
    mesh = _mesh(mesh, device)
    me = mesh.flat().index
    if me is None:
        return None
    ndev, dev = mesh.size, mesh.device
    buckets = bucket_by_length(
        seqs, bucket_edges=tuple(bucket_edges or BUCKET_EDGES))
    which = np.zeros(n, dtype=np.int64)  # global index -> bucket id
    local = np.zeros(n, dtype=np.int64)  # global index -> index in bucket
    on_dev = []
    for b, (pos, enc_b) in enumerate(buckets):
        which[pos] = b
        local[pos] = np.arange(len(pos))
        on_dev.append((torch.from_numpy(enc_b.indices).to(dev),
                       torch.from_numpy(enc_b.lengths).to(dev)))
    sub = torch.as_tensor(sub).to(dev, torch.int32)
    gi, gj = np.triu_indices(n)
    group = which[gi] * len(buckets) + which[gj]
    full = _zeros(mesh, (2, len(gi)), torch.int32)
    for g in np.unique(group):
        plist = np.nonzero(group == g)[0]
        batch_g = plan_bucket_group(len(plist), ndev, batch)[0]
        # batch t of the group goes to rank t % ndev; the plan's padding
        # slots past the group's pairs are not launched
        p = plist[(np.arange(len(plist)) // batch_g) % ndev == me]
        if len(p):
            ba, bb = divmod(int(g), len(buckets))
            _launch_into(full, p, *on_dev[ba], *on_dev[bb], local[gi[p]],
                         local[gj[p]], sub, gap_open, gap_ext, dev)
    out = _sum_shares(mesh, full)
    return _fill(n, _ratio(out[0], out[1]))


def sharded_minhash_topk(
    sigs,
    k: int = 64,
    *,
    mesh: Mesh | None = None,
    block: int | None = None,
    device=None,
) -> tuple[np.ndarray, np.ndarray] | None:
    """Top-k neighbour lists on a mesh, the sharded form of
    ``ops.topk_graph.minhash_topk``: rows split over the flattened mesh,
    signatures replicated, each rank reducing its whole rows to top-k (on a
    card in one kernel launch, on the CPU in row blocks of ``block``; None:
    ``minhash.COMPARE_BYTES``'s size).  The
    distinct key holds the global column, so equal counts come lowest
    index first, as on one device.

    Returns (similarities float64 [N, k], neighbour idx int32 [N, k]),
    equal to ``minhash_topk``.
    """
    mesh = _mesh(mesh, device)
    part = row_sharded(mesh.flat()).local(len(sigs))
    if part is None:
        return None
    rows = part[0]
    sigs = as_signatures(sigs, mesh.device)
    n, n_hash = sigs.shape
    k = min(k, max(n - 1, 1))
    full = _zeros(mesh, (2, n, k), torch.int64)
    counts, idx = _topk_block(sigs, rows.start, rows.stop, k, block)
    full[0, rows.start:rows.stop] = counts.to(full.device)
    full[1, rows.start:rows.stop] = idx.to(full.device)
    out = _sum_shares(mesh, full)
    return _topk_lists(out[0], out[1], n_hash)
