"""Needleman–Wunsch / Gotoh percent identity: the plain PyTorch version.

Behavioural spec: reference src/pairwiseSeqAlign.cpp:209-313
(``calculate_similarity``).  The score is NOT the alignment score — it is
percent identity (matches / alignment_length) along the greedy traceback.

This module is the plain twin of both CUDA kernels, ``csrc/nw_gotoh.cu``
and ``csrc/nw_gotoh_xl.cu``, and serves any length: the CPU tests hold it
against the JAX package and the C++ oracle, and ``chip_smoke.py`` holds
each kernel against it on the card.  It is the
anti-diagonal scan of the JAX package's ``ops/nw.py`` written as a Python loop
over ``d = i + j`` on ``[B, M+1]`` int32 tensors (lane i <-> DP row i):

* cell (i, j) reads (i-1, j) and (i, j-1) from the previous diagonal and
  (i-1, j-1) from the one before;
* the traceback is not stored: the reference's walk reads one decision per
  visited cell, and that decision depends only on the cell's own
  (M, Ix, Iy) comparison (priority D > U > L), so the (matches, length) of
  the path back to the origin obeys a forward recurrence carried in two
  more planes (MT, LN);
* border gaps cost gap_open + (len-1)*gap_ext while interior openings cost
  gap_open + gap_ext, and int32 arithmetic keeps the INT_MIN/2 sentinel, as
  the reference does.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

NEG_SENTINEL = int(np.iinfo(np.int32).min // 2)  # INT_MIN / 2


class NWResult(NamedTuple):
    matches: torch.Tensor  # int32 [B]
    length: torch.Tensor  # int32 [B]

    def similarity(self) -> np.ndarray:
        """matches / alignment_length in float64 (C++ double semantics)."""
        m = self.matches.cpu().numpy().astype(np.float64)
        ln = self.length.cpu().numpy().astype(np.float64)
        with np.errstate(invalid="ignore", divide="ignore"):
            return m / ln


def _shift_down(x: torch.Tensor, fill: int) -> torch.Tensor:
    """out[:, i] = x[:, i-1]; out[:, 0] = fill."""
    return torch.cat([torch.full_like(x[:, :1], fill), x[:, :-1]], dim=1)


def nw_similarity_batch(
    a_idx: torch.Tensor,  # int32 [B, M] alphabet indices (PAD beyond len)
    a_len: torch.Tensor,  # int32 [B]
    b_idx: torch.Tensor,  # int32 [B, N]
    b_len: torch.Tensor,  # int32 [B]
    sub: torch.Tensor,  # int32 [32, 32] padded substitution matrix
    *,
    gap_open: int = 10,
    gap_ext: int = 4,
) -> NWResult:
    """(matches, alignment_length) for a batch of sequence pairs.

    ``a`` is the reference's sequence 1 (the DP rows).  Requires
    ``a_len <= M`` and ``b_len <= N``.
    """
    bsz, m_max = a_idx.shape
    n_max = b_idx.shape[1]
    dev = a_idx.device
    i32 = torch.int32
    lanes = m_max + 1
    go_ge, ge, go, neg = gap_open + gap_ext, gap_ext, gap_open, NEG_SENTINEL

    a_len = a_len.to(i32)
    b_i32 = b_idx.to(i32)
    # lane i holds a-char a[i-1]; lane 0 is the border row (index 31: PAD)
    a_sh = torch.cat(
        [torch.full((bsz, 1), 31, dtype=i32, device=dev), a_idx.to(i32)], 1
    )
    # score(i, j) = sub[a[i-1], b[j-1]] = flat[a_sh * 32 + w]
    sub_flat = sub.to(i32).reshape(-1)
    a_row = (a_sh * 32).long()

    lane = torch.arange(lanes, dtype=i32, device=dev)[None, :]
    zeros = torch.zeros((bsz, lanes), dtype=i32, device=dev)
    negs = torch.full((bsz, lanes), neg, dtype=i32, device=dev)

    # diagonal d=0: only cell (0,0) is real: M=0, Ix=Iy=sentinel, path empty
    m0 = negs.clone()
    m0[:, 0] = 0
    prev = dict(M=m0, Ix=negs, Iy=negs, MT=zeros, LN=zeros)
    prev2 = dict(M=negs, Ix=negs, Iy=negs, MT=zeros, LN=zeros)
    w = torch.full((bsz, lanes), 31, dtype=i32, device=dev)
    cap_mt = torch.zeros((bsz,), dtype=i32, device=dev)
    cap_ln = torch.zeros((bsz,), dtype=i32, device=dev)
    final_d = a_len + b_len.to(i32)  # diagonal holding each pair's (m, n)
    a_col = a_len.long()[:, None]

    for d in range(1, m_max + n_max + 1):
        # b-char window: w[i] = b[d-1-i] (shift down, insert b[d-1] at 0)
        w = _shift_down(w, 0)
        w[:, 0] = b_i32[:, min(d - 1, n_max - 1)]

        up_M = _shift_down(prev["M"], neg)
        up_Ix = _shift_down(prev["Ix"], neg)
        up_MT = _shift_down(prev["MT"], 0)
        up_LN = _shift_down(prev["LN"], 0)
        di_M = _shift_down(prev2["M"], neg)
        di_Ix = _shift_down(prev2["Ix"], neg)
        di_Iy = _shift_down(prev2["Iy"], neg)
        di_MT = _shift_down(prev2["MT"], 0)
        di_LN = _shift_down(prev2["LN"], 0)

        score = sub_flat[a_row + w.long()]

        ix = torch.maximum(up_M - go_ge, up_Ix - ge)
        iy = torch.maximum(prev["M"] - go_ge, prev["Iy"] - ge)
        mnew = torch.maximum(di_M, torch.maximum(di_Ix, di_Iy)) + score

        d_sel = (mnew >= ix) & (mnew >= iy)  # traceback priority D > U > L
        u_sel = ~d_sel & (ix >= iy)
        m_cell = torch.where(d_sel, mnew, torch.where(u_sel, ix, iy))
        match = (a_sh == w).to(i32)
        mt = torch.where(
            d_sel, di_MT + match, torch.where(u_sel, up_MT, prev["MT"])
        )
        ln = torch.where(d_sel, di_LN, torch.where(u_sel, up_LN, prev["LN"]))
        ln = ln + 1

        # borders: cell (0, d) at lane 0 ('L' column), cell (d, 0) at lane d
        border_gap = -go - (d - 1) * ge
        is_lane0 = lane == 0
        is_laned = lane == d
        border = is_lane0 | is_laned
        m_cell = torch.where(border, neg, m_cell)
        ix = torch.where(is_laned, border_gap, torch.where(is_lane0, neg, ix))
        iy = torch.where(is_lane0, border_gap, torch.where(is_laned, neg, iy))
        mt = torch.where(border, 0, mt)
        ln = torch.where(border, d, ln)

        # capture (matches, length) at each pair's final cell (m, n)
        hit = final_d == d
        cap_mt = torch.where(hit, mt.gather(1, a_col)[:, 0], cap_mt)
        cap_ln = torch.where(hit, ln.gather(1, a_col)[:, 0], cap_ln)

        prev2 = prev
        prev = dict(M=m_cell, Ix=ix, Iy=iy, MT=mt, LN=ln)
    return NWResult(matches=cap_mt, length=cap_ln)


def nw_pairs(a_idx, a_len, b_idx, b_len, sub, *, device=None,
             **kw) -> np.ndarray:
    """Convenience: similarity values (float64) for a batch of pairs, on
    ``device`` (None means the card): through the NW kernel the padded
    width picks there, through this plain version on the CPU.  ``kw``
    takes ``gap_open`` and ``gap_ext``."""
    from ..device import resolve_device
    from . import nw_batch

    dev = resolve_device(device)
    args = [torch.as_tensor(x).to(dev, torch.int32)
            for x in (a_idx, a_len, b_idx, b_len, sub)]
    return nw_batch(*args, **kw).similarity()
