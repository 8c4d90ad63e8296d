"""Plain exact NW percent identity, the yardstick of the NW cells.

The semantics are the upstream's ``calculate_similarity``
(DynaAlign src/pairwiseSeqAlign.cpp:209-313): affine-gap Gotoh DP, the
percent identity (matches / alignment length) of the greedy traceback with
priority D > U > L, border gaps at gap_open + (len-1)*gap_ext, interior
openings at gap_open + gap_ext, int32 cells with the INT_MIN/2 sentinel.

It is a frozen copy of the port's plain version (an anti-diagonal loop
over ``d = i + j`` on ``[B, M+1]`` int32 tensors, the traceback carried
forward in two planes), so that a later change to the port cannot move
the yardstick.  It imports nothing of the port: the alphabet and BLOSUM62
are read from this folder.
"""

from __future__ import annotations

import os

import numpy as np
import torch

ALPHABET = "ARNDCQEGHILKMFPSTWYVBZX*"
PAD = len(ALPHABET)  # 24: padding; the table is zero there
NEG = int(np.iinfo(np.int32).min // 2)
_HERE = os.path.dirname(os.path.abspath(__file__))
# most int32 elements of one batch's [B, M+1] plane
BATCH_ELEMENTS = 1 << 24


def substitution_table(name: str) -> np.ndarray:
    """int32 [32, 32]: the named table over ALPHABET, zero beyond it."""
    path = os.path.join(_HERE, f"{name.lower()}.txt")
    if not os.path.exists(path):
        raise ValueError(f"no frozen table {name!r} in {_HERE}")
    rows = [ln.split() for ln in open(path) if ln.strip() and
            not ln.startswith("#")]
    if rows[0] != list(ALPHABET):
        raise ValueError(f"{path}: header {rows[0]} is not {ALPHABET}")
    out = np.zeros((32, 32), dtype=np.int32)
    for i, row in enumerate(rows[1:]):
        if row[0] != ALPHABET[i]:
            raise ValueError(f"{path}: row {i} is {row[0]!r}")
        out[i, : len(ALPHABET)] = [int(v) for v in row[1:]]
    return out


def encode(seqs: list[str], width: int) -> tuple[np.ndarray, np.ndarray]:
    """(int32 [N, width] alphabet indices padded with PAD, int32 [N]
    lengths); raises on a letter outside ALPHABET."""
    lut = np.full(256, -1, dtype=np.int32)
    for i, c in enumerate(ALPHABET):
        lut[ord(c)] = i
    idx = np.full((len(seqs), width), PAD, dtype=np.int32)
    for r, s in enumerate(seqs):
        v = lut[np.frombuffer(s.encode("ascii"), dtype=np.uint8)]
        if (v < 0).any():
            raise ValueError(f"sequence {r}: a letter outside {ALPHABET}")
        idx[r, : len(s)] = v
    return idx, np.array([len(s) for s in seqs], dtype=np.int32)


def _down(x: torch.Tensor, fill: int) -> torch.Tensor:
    """out[:, i] = x[:, i-1]; out[:, 0] = fill."""
    return torch.cat([torch.full_like(x[:, :1], fill), x[:, :-1]], dim=1)


def match_length(a_idx, a_len, b_idx, b_len, sub, gap_open, gap_ext):
    """(matches, alignment length), int32 [B] each, of pairs (a[k], b[k]):
    a is the upstream's sequence 1 (the DP rows)."""
    bsz, m_max = a_idx.shape
    n_max = b_idx.shape[1]
    dev = a_idx.device
    i32 = torch.int32
    lanes = m_max + 1
    go_ge, ge, go = gap_open + gap_ext, gap_ext, gap_open
    a_sh = torch.cat([torch.full((bsz, 1), 31, dtype=i32, device=dev),
                      a_idx], 1)
    sub_flat = sub.reshape(-1)
    a_row = (a_sh * 32).long()
    lane = torch.arange(lanes, dtype=i32, device=dev)[None, :]
    zeros = torch.zeros((bsz, lanes), dtype=i32, device=dev)
    negs = torch.full((bsz, lanes), NEG, dtype=i32, device=dev)
    m0 = negs.clone()
    m0[:, 0] = 0
    prev = dict(M=m0, Ix=negs, Iy=negs, MT=zeros, LN=zeros)
    prev2 = dict(M=negs, Ix=negs, Iy=negs, MT=zeros, LN=zeros)
    w = torch.full((bsz, lanes), 31, dtype=i32, device=dev)
    cap_mt = torch.zeros((bsz,), dtype=i32, device=dev)
    cap_ln = torch.zeros((bsz,), dtype=i32, device=dev)
    final_d = a_len + b_len
    a_col = a_len.long()[:, None]
    for d in range(1, m_max + n_max + 1):
        w = _down(w, 0)
        w[:, 0] = b_idx[:, min(d - 1, n_max - 1)]
        up_M, up_Ix = _down(prev["M"], NEG), _down(prev["Ix"], NEG)
        up_MT, up_LN = _down(prev["MT"], 0), _down(prev["LN"], 0)
        di_M, di_Ix = _down(prev2["M"], NEG), _down(prev2["Ix"], NEG)
        di_Iy = _down(prev2["Iy"], NEG)
        di_MT, di_LN = _down(prev2["MT"], 0), _down(prev2["LN"], 0)
        score = sub_flat[a_row + w.long()]
        ix = torch.maximum(up_M - go_ge, up_Ix - ge)
        iy = torch.maximum(prev["M"] - go_ge, prev["Iy"] - ge)
        mnew = torch.maximum(di_M, torch.maximum(di_Ix, di_Iy)) + score
        d_sel = (mnew >= ix) & (mnew >= iy)  # D > U > L
        u_sel = ~d_sel & (ix >= iy)
        m_cell = torch.where(d_sel, mnew, torch.where(u_sel, ix, iy))
        match = (a_sh == w).to(i32)
        mt = torch.where(d_sel, di_MT + match,
                         torch.where(u_sel, up_MT, prev["MT"]))
        ln = torch.where(d_sel, di_LN,
                         torch.where(u_sel, up_LN, prev["LN"])) + 1
        border_gap = -go - (d - 1) * ge
        is_lane0, is_laned = lane == 0, lane == d
        border = is_lane0 | is_laned
        m_cell = torch.where(border, NEG, m_cell)
        ix = torch.where(is_laned, border_gap, torch.where(is_lane0, NEG, ix))
        iy = torch.where(is_lane0, border_gap, torch.where(is_laned, NEG, iy))
        mt = torch.where(border, 0, mt)
        ln = torch.where(border, d, ln)
        hit = final_d == d
        cap_mt = torch.where(hit, mt.gather(1, a_col)[:, 0], cap_mt)
        cap_ln = torch.where(hit, ln.gather(1, a_col)[:, 0], cap_ln)
        prev2 = prev
        prev = dict(M=m_cell, Ix=ix, Iy=iy, MT=mt, LN=ln)
    return cap_mt, cap_ln


def pair_counts(seqs, pairs, settings, device) -> tuple[np.ndarray, ...]:
    """(matches, lengths), int64 [P], of ``pairs`` (int [P, 2], i <= j:
    sequence i is the upstream's sequence 1), batched by the pairs' summed
    length so that a batch's loop ends near its own longest pair."""
    pairs = np.asarray(pairs, dtype=np.int64).reshape(-1, 2)
    lens = np.array([len(s) for s in seqs], dtype=np.int64)
    sub = torch.from_numpy(substitution_table(settings["matrix_name"])).to(
        device)
    go, ge = int(settings["gap_open"]), int(settings["gap_ext"])
    order = np.argsort(lens[pairs[:, 0]] + lens[pairs[:, 1]], kind="stable")
    mt = np.zeros(len(pairs), dtype=np.int64)
    ln = np.zeros(len(pairs), dtype=np.int64)
    s = 0
    while s < len(order):
        # grow the batch from the shortest pairs left while it fits
        width = int(max(lens[pairs[order[-1]]].max(), 1))
        e = min(len(order), s + max(1, BATCH_ELEMENTS // (width + 1)))
        sel = order[s:e]
        p = pairs[sel]
        wa = int(max(lens[p[:, 0]].max(), 1))
        wb = int(max(lens[p[:, 1]].max(), 1))
        a, la = encode([seqs[i] for i in p[:, 0]], wa)
        b, lb = encode([seqs[j] for j in p[:, 1]], wb)
        got = match_length(*(torch.from_numpy(x).to(device)
                             for x in (a, la, b, lb)), sub, go, ge)
        mt[sel], ln[sel] = (g.cpu().numpy() for g in got)
        s = e
    return mt, ln


def ratio(matches: np.ndarray, lengths: np.ndarray,
          dtype=np.float64) -> np.ndarray:
    """matches / lengths in ``dtype`` (the upstream's C++ double), as
    float64; 0/0 is NaN, as there."""
    with np.errstate(invalid="ignore", divide="ignore"):
        return (matches.astype(dtype) / lengths.astype(dtype)).astype(
            np.float64)
