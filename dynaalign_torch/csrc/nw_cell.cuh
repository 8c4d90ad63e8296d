// The Gotoh cell update and the skewed strip sweep shared by the two NW
// kernels, csrc/nw_gotoh.cu (groups of lanes per pair, m+1 <= 1120) and
// csrc/nw_gotoh_xl.cu (one warp per pair, any length).
//
// The function is the one of ops/nw.py: for each pair the (matches,
// alignment_length) of the reference's greedy D>U>L traceback
// (src/pairwiseSeqAlign.cpp:209-313), carried forward in a path word W
// beside the three score planes M, Ix, Iy.  Four facts of that recurrence
// shape the code; each is checked against ops/nw.py:117-140.
//
// 1. M is already the best of the three.  The stored M of an interior cell
//    is m_cell = where(d_sel, diag, where(u_sel, ix, iy)) with
//    d_sel = diag >= ix && diag >= iy and u_sel = !d_sel && ix >= iy: the
//    chosen one is never smaller than the other two, so M = max(diag, ix,
//    iy) >= Ix, Iy of the same cell.  The diagonal ancestor's
//    max(M, Ix, Iy) is therefore M itself, and a cell's Iy is read by its
//    right neighbour only, its Ix by the cell below only.  Border cells are
//    the exception: there M is the sentinel and one gap plane holds the
//    border gap -gap_open - (len-1)*gap_ext.  They are row 0 (the cell
//    above lane 0's first row in the first strip) and column 0 (the
//    diagonal of column 1); the sweep gives both their border value as the
//    "best" and keeps their M at the sentinel, because Ix and Iy of their
//    neighbours open from M (the border/interior gap asymmetry).
// 2. The decision falls out of the max.  t = max(ix, iy) with pU = ix >= iy
//    and mc = max(diag, t) with pD = diag >= t give d_sel = pD and
//    u_sel = !pD && pU: Hopper's __vibmax_s32 returns the max and that
//    predicate (a >= b) in one instruction, and __viaddmax_s32(a, b, c) =
//    max(a + b, c) makes Ix and Iy two instructions each.
// 3. MT and LN fit one word wherever m + n < 65,536: W = MT << 16 | LN
//    (LN <= m + n, MT <= min(m, n) < 32,768).  A step adds 1, a match on
//    the diagonal 1 << 16.  NWD = 1 is that packing, NWD = 2 keeps two
//    words (MT, LN) for longer pairs.
// 4. Sentinels only have to lose.  NW_NEG = INT_MIN / 2 enters Ix at row 1
//    and Iy at column 1 as NW_NEG - gap_ext (and NW_NEG - gap_open -
//    gap_ext inside the max); one cell later the finite M - gap_open -
//    gap_ext wins, so a sentinel never drifts further and nothing wraps
//    while gap_open + gap_ext < 2^29; the wrapper accepts 0..2^20 each.
//
// Scores come from a query profile (what the TPU kernel's _score_slab is
// for): prof[c][thread][w] holds, as four int8 per word, sub[a_i][c] for
// the thread's R rows, rebuilt for every strip.  A lane at column j reads
// the ceil(R / 4) words of symbol b_j; the word index is (c * threads +
// thread) * RW + w, so with 32 | threads the bank depends on the lane
// alone: odd RW is conflict-free word by word, RW = 2 by one 64-bit load.
// The old s_sub[a * 32 + b] had its bank in b alone, and the lanes of a
// skewed step hold different b.  __dp4a(word, 1 << 8k, best) extracts byte
// k, sign-extends it and adds the diagonal in one instruction.  Scores
// must fit int8 and symbols lie in 0..24 (the alphabet and PAD); the
// wrapper checks both.
//
// The other layout that was weighed, the 32 x 32 table as int8 replicated
// once per bank (one load and one address add per cell where the profile
// costs ceil(R / 4) / R loads), measured slower on both workloads; PERF.md
// has the times.
//
// Integer operations per steady-state cell: Ix 2 (subtract, add-max),
// Iy 2, diagonal 1 (dp4a), two max-with-predicate 2, path word 5 (two
// selects, compare a_i == b_j fused with pD, select of the increment, add)
// = NW_OPS_PER_CELL = 12, plus ceil(R / 4) / R shared-memory loads and
// (2 + NWD) / R shuffles.  An SM issues 128 thread-instructions a clock
// (four schedulers, a warp each) but has 64 integer ALU lanes; plain adds
// and subtracts (as IMAD.IADD) and the dp4a (IDP.4A) can go down the FMA
// pipe beside them.  What only the ALU takes is NW_ALU_OPS_PER_CELL = 8:
// the two add-max, the two max-with-predicate, the compare and the three
// selects.  chip_smoke.py's bound is the larger of the 8 at 64 lanes and
// the 12 at the issue rate, which is the 8.
//
// The sweep: a pair is served by a group of G lanes (G a power of two,
// shuffles take width = G), lane t of the group owns R consecutive rows of
// a strip of G * R rows and keeps their column j-1 values (M, Iy, W) and
// a-characters in registers.  At step k lane t works column j = k - t; the
// cell above its first row is lane t-1's last row one step earlier, handed
// over by 2 + NWD shuffles (M, Ix, W).  Every lane of the warp runs the
// same number of steps (the largest of its groups) with the full mask;
// ragged columns and idle groups are a predicate with no shuffle inside.
// The first G steps are the ones in which some lane sits at column 1 and
// takes its next diagonal from the column-0 border; they run the EDGE body,
// the rest the steady one.  Between strips the last lane leaves its last
// row (M, Ix, W: 2 + NWD planes of N+1 words) in a boundary row and lane 0
// reads it back one column ahead; within a strip column c is read at step
// c-1 and written at step c+G-1, so one buffer is safe, and __syncwarp()
// orders strips.  That is nw_pair_sweep, which runs every strip of a pair
// on one group.
//
// nw_strip_sweep runs one strip of a pair on a whole warp (G = 32), for
// nw_gotoh_xl's queue of (pair, strip) items, so that strips of one pair
// run on different warps, on different SMs, at once.  Strip s reads the
// bottom row strip s-1 left in global memory while strip s-1 is still
// writing it, chunk by chunk:
// * A progress word per item, zeroed by the wrapper: after every G = 32
//   steps, and at the strip's end, the last lane stores with release
//   semantics the highest column it has written, after a __syncwarp() that
//   orders lane 0's reads of the row above before it.
// * Lane 0 of strip s, before the steps that read columns up to c, waits
//   with acquire loads until item k-1 (strip s-1: a pair's strips are
//   consecutive in the table) has published c, and then reads the row with
//   __ldcg, which skips the SM's L1: another SM wrote it.  Only lane 0
//   spins, and the warp meets at a __syncwarp() before its next shuffle.
// * One boundary row a pair still suffices.  Strip s writes column c once,
//   before strip s+1 reads it (s+1 waited for it); s+1 reads it at its
//   step c-1 and overwrites it at step c+31, 32 steps later, so the
//   __syncwarp() of a publication lies between; strip s+2 waits for s+1's
//   word, so it reads s+1's value.  Nobody else reads the row.  A progress
//   word per pair would not do: strip s+1 publishes while strip s still
//   does, and a reader could see the wrong strip's column.
// * A strip waits only on the item before it, which an earlier atomicAdd
//   handed to a warp that is running; by induction every wait ends, with
//   any grid, block order or residency.

#ifndef DYNAALIGN_NW_CELL_CUH_
#define DYNAALIGN_NW_CELL_CUH_

#define NW_NEG (-1073741824)  // INT_MIN / 2, the reference's sentinel
#define NW_SUB 32             // padded substitution table width
#define NW_SYMS 25            // profile symbols: the 24-letter alphabet + PAD
#define NW_OPS_PER_CELL 12
#define NW_ALU_OPS_PER_CELL 8
#define NW_FULL 0xffffffffu

#ifdef __CUDACC__
// Progress words between strips of one pair on different SMs (the host
// harness of tests/test_torch_harness.py defines both on std::atomic_ref).
__device__ __forceinline__ int nw_load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void nw_store_release(int* p, int v) {
  asm volatile("st.release.gpu.b32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}
#endif

template <int NWD>
struct NwPath {
  int w[NWD];  // NWD == 1: MT << 16 | LN; NWD == 2: MT, LN
};

template <int NWD>
__device__ __forceinline__ NwPath<NWD> nw_path(int mt, int ln) {
  NwPath<NWD> p;
  if constexpr (NWD == 1) {
    p.w[0] = (mt << 16) | ln;
  } else {
    p.w[0] = mt;
    p.w[1] = ln;
  }
  return p;
}

template <int NWD>
__device__ __forceinline__ int nw_path_mt(const NwPath<NWD>& p) {
  return NWD == 1 ? p.w[0] >> 16 : p.w[0];
}

template <int NWD>
__device__ __forceinline__ int nw_path_ln(const NwPath<NWD>& p) {
  return NWD == 1 ? p.w[0] & 0xffff : p.w[NWD - 1];
}

// One interior cell.  u: the cell above (M, Ix, W); l: the cell to the left
// (M, Iy, W); d: the diagonal ancestor (its best score, W).  q holds the
// cell's score as the int8 that sel (1 << 8k) selects, same is a_i == b_j.
template <int NWD>
__device__ __forceinline__ void nw_cell(
    int uM, int uIx, const NwPath<NWD>& uW, int lM, int lIy,
    const NwPath<NWD>& lW, int dBest, const NwPath<NWD>& dW, int q, int sel,
    bool same, int neg_go_ge, int gap_ext, int& mc, int& ix, int& iy,
    NwPath<NWD>& w) {
  ix = __viaddmax_s32(uM, neg_go_ge, uIx - gap_ext);
  iy = __viaddmax_s32(lM, neg_go_ge, lIy - gap_ext);
  const int diag = __dp4a(q, sel, dBest);
  bool pU, pD;  // traceback priority D > U > L: both tests are >=
  const int t = __vibmax_s32(ix, iy, &pU);
  mc = __vibmax_s32(diag, t, &pD);
  const bool hit = pD && same;
#pragma unroll
  for (int k = 0; k < NWD; ++k) {
    const int step = (NWD == 1 || k == 1) ? 1 : 0;
    const int match = NWD == 1 ? 1 << 16 : (k == 0 ? 1 : 0);
    const int from = pD ? dW.w[k] : (pU ? uW.w[k] : lW.w[k]);
    w.w[k] = from + (hit ? step + match : step);
  }
}

template <int RW>
__device__ __forceinline__ void nw_load_profile(const int* p, int (&q)[RW]) {
  if constexpr (RW == 2) {
    const int2 v = *reinterpret_cast<const int2*>(p);
    q[0] = v.x;
    q[1] = v.y;
  } else if constexpr (RW == 4) {
    const int4 v = *reinterpret_cast<const int4*>(p);
    q[0] = v.x;
    q[1] = v.y;
    q[2] = v.z;
    q[3] = v.w;
  } else {
#pragma unroll
    for (int w = 0; w < RW; ++w) q[w] = p[w];
  }
}

// One lane's share of a strip: its R rows' column j-1 values and what it
// carries from step to step.  XL: the boundary row lies in global memory
// and another SM may have written it, so lane 0 reads it past L1.
template <int G, int R, int NWD, bool XL = false>
struct NwLane {
  static constexpr int RW = (R + 3) / 4;  // profile words per symbol
  int ac[R], cM[R], cIy[R];
  NwPath<NWD> cW[R];
  int dBest;  // best of the first row's diagonal ancestor
  NwPath<NWD> dW;
  int xIx;    // Ix of the last row, for the lane below
  int bNext;  // the next column's b-character
  int nM, nIx;  // lane 0, later strips: the next column's boundary cell
  NwPath<NWD> nW;

  // Lane 0, a later strip: column c of the boundary row, the cell above its
  // first row.
  __device__ __forceinline__ void load_next(const int* bnd, int bstride,
                                            int c) {
    if constexpr (XL) {
      nM = __ldcg(bnd + c);
      nIx = __ldcg(bnd + bstride + c);
#pragma unroll
      for (int w = 0; w < NWD; ++w) {
        nW.w[w] = __ldcg(bnd + (2 + w) * bstride + c);
      }
    } else {
      nM = bnd[c];
      nIx = bnd[bstride + c];
#pragma unroll
      for (int w = 0; w < NWD; ++w) nW.w[w] = bnd[(2 + w) * bstride + c];
    }
  }

  // The strip whose first row is r0 (busy: the group's pair has it): this
  // lane's rows at column 0, the 'U' border, and its query profile.
  // Returns Ix of the lane's first row at column 0.
  __device__ __forceinline__ int begin(
      bool busy, const int* __restrict__ a, const int* __restrict__ b, int m,
      int r0, int gl, const int* __restrict__ sub_t, int* prof, int pstride,
      int gap_open, int gap_ext) {
    const int first = r0 + gl * R;  // this lane's first row
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = first + r;
      ac[r] = (busy && i <= m) ? (a[i - 1] & (NW_SUB - 1)) : NW_SUB - 1;
      // column 0 of row i, the 'U' border: M and Iy are the sentinel, the
      // path is i gaps; its Ix is -gap_open - (i-1)*gap_ext
      cM[r] = NW_NEG;
      cIy[r] = NW_NEG;
      cW[r] = nw_path<NWD>(0, i);
    }
    if (busy) {
#pragma unroll 1
      for (int c = 0; c < NW_SYMS; ++c) {
#pragma unroll
        for (int w = 0; w < RW; ++w) {
          int word = 0;
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            if (4 * w + k < R) {
              word |= (sub_t[c * NW_SUB + ac[4 * w + k]] & 0xff) << (8 * k);
            }
          }
          prof[c * pstride + w] = word;
        }
      }
    }
    const int e_border = -gap_open - (first - 1) * gap_ext;  // Ix(first, 0)
    // diagonal of the first row at column 1: cell (first-1, 0), the origin
    // or a 'U' border cell
    dBest = first == 1 ? 0 : e_border + gap_ext;
    dW = nw_path<NWD>(0, first - 1);
    xIx = NW_NEG;
    bNext = (gl == 0 && busy) ? b[0] : 0;
    nM = nIx = 0;
    nW = nw_path<NWD>(0, 0);
    return e_border;
  }

  // Step k of a strip: this lane (gl of its group) works column k - gl of
  // the nn the pair has (0 for an idle group).  EDGE: some lane of the
  // group may sit at column 1.  top: the strip starts at row 1.  more:
  // another strip follows, so the last lane writes the boundary row.
  template <bool EDGE>
  __device__ __forceinline__ void step(
      int k, int gl, int nn, bool top, bool more, const int* __restrict__ b,
      const int* prof, int pstride, int* bnd, int bstride, int gap_open,
      int gap_ext, int e_border) {
    // the cell above the first row: lane gl-1's last row at this column
    int uM = cM[R - 1], uIx = xIx;
    NwPath<NWD> uW = cW[R - 1];
    if constexpr (G > 1) {
      uM = __shfl_up_sync(NW_FULL, uM, 1, G);
      uIx = __shfl_up_sync(NW_FULL, uIx, 1, G);
#pragma unroll
      for (int w = 0; w < NWD; ++w) {
        uW.w[w] = __shfl_up_sync(NW_FULL, uW.w[w], 1, G);
      }
    }
    const int j = k - gl;
    const int bj = bNext;
    if (j >= 0 && j < nn) bNext = b[j];  // column j+1
    int uBest = uM;
    if (gl == 0) {
      if (top) {  // row 0: the 'L' border, Iy = -gap_open - (j-1)*gap_ext
        uM = NW_NEG;
        uIx = NW_NEG;
        uBest = -gap_open - (j - 1) * gap_ext;
        uW = nw_path<NWD>(0, j);
      } else {
        uM = nM;
        uIx = nIx;
        uBest = nM;
        uW = nW;
        if (j < nn) load_next(bnd, bstride, j + 1);
      }
    }
    if (j >= 1 && j <= nn) {
      // the wrapper refuses symbols past PAD; the clamp only keeps a stray
      // one inside the profile
      const int sym = bj < NW_SYMS ? bj : NW_SYMS - 1;
      int q[RW];
      nw_load_profile<RW>(prof + sym * pstride, q);
      const int neg_go_ge = -(gap_open + gap_ext);
      int pBest = dBest;  // diagonal of row r
      NwPath<NWD> pW = dW;
      dBest = uBest;  // next step's diagonal
      dW = uW;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        int mc, ix, iy;
        NwPath<NWD> w;
        nw_cell<NWD>(uM, uIx, uW, cM[r], cIy[r], cW[r], pBest, pW, q[r / 4],
                     1 << (8 * (r & 3)), ac[r] == bj, neg_go_ge, gap_ext, mc,
                     ix, iy, w);
        // row r at column j-1 is the next row's diagonal; at column 0 its
        // best is the border's Ix, not its M
        pBest = (EDGE && j == 1) ? e_border - r * gap_ext : cM[r];
        pW = cW[r];
        cM[r] = mc;
        cIy[r] = iy;
        cW[r] = w;
        uM = mc;
        uIx = ix;
        uW = w;
      }
      xIx = uIx;
      if (more && gl == G - 1) {
        bnd[j] = uM;
        bnd[bstride + j] = uIx;
#pragma unroll
        for (int w = 0; w < NWD; ++w) bnd[(2 + w) * bstride + j] = uW.w[w];
      }
    }
  }
};

// The largest v of the warp's groups of G lanes, in every lane.
template <int G>
__device__ __forceinline__ int nw_warp_max(int v, int lane) {
  if constexpr (G < 32) {
#pragma unroll
    for (int o = 16; o >= G; o >>= 1) {
      const int other = __shfl_sync(NW_FULL, v, lane ^ o);
      v = other > v ? other : v;
    }
  }
  return v;
}

// All strips of one pair, run by the G lanes of its group; every lane of
// the warp calls it.  live: the group has a pair (else it only keeps the
// warp's shuffles company).  a, b: the pair's rows of a_idx, b_idx; sub_t:
// the [32, 32] table in global memory, transposed (sub_t[b][a] is the score
// of a against b), so that the lanes of a warp, which differ in a, read
// neighbouring words when they build their profiles.  prof: this thread's
// profile words (RW per symbol, symbol stride pstride words), aligned to 4
// * RW bytes when RW is 2 or 4.  bnd: the pair's boundary row, 2 + NWD
// planes (M, Ix, W) of bstride words, column j at [j]; only touched when m
// > G * R.
template <int G, int R, int NWD>
__device__ __forceinline__ void nw_pair_sweep(
    bool live, const int* __restrict__ a, const int* __restrict__ b, int m,
    int n, const int* __restrict__ sub_t, int gap_open, int gap_ext, int* prof,
    int pstride, int* bnd, int bstride, int* out_mt, int* out_ln) {
  using Lane = NwLane<G, R, NWD>;
  const int lane = threadIdx.x & 31;
  const int gl = lane & (G - 1);  // lane of the group
  if (live && (m == 0 || n == 0)) {  // the path is one border gap
    if (gl == 0) {
      *out_mt = 0;
      *out_ln = m + n;
    }
    live = false;
  }
  if (!live) m = n = 0;
  // the warp's lanes run the strips of its longest pair
  const int m_warp = nw_warp_max<G>(m, lane);

  for (int r0 = 1; r0 <= m_warp; r0 += G * R) {  // the strip's first row
    const bool busy = r0 <= m;
    const int nn = busy ? n : 0;
    const int first = r0 + gl * R;  // this lane's first row
    Lane s;
    const int e_border = s.begin(busy, a, b, m, r0, gl, sub_t, prof, pstride,
                                 gap_open, gap_ext);
    if (gl == 0 && busy && r0 > 1) s.load_next(bnd, bstride, 1);
    const bool more = busy && r0 + G * R <= m;
    // lanes past the one holding row m have nothing to compute, and that
    // lane's last step is at column n
    const int last = (m - r0) / R < G - 1 ? (m - r0) / R : G - 1;
    const int steps = nw_warp_max<G>(busy ? n + last : 0, lane);
    // some lane sits at column 1 in the first G steps only
    const int edge_steps = steps < G ? steps : G;
    for (int k = 1; k <= edge_steps; ++k) {
      s.template step<true>(k, gl, nn, r0 == 1, more, b, prof, pstride, bnd,
                            bstride, gap_open, gap_ext, e_border);
    }
    for (int k = G + 1; k <= steps; ++k) {
      s.template step<false>(k, gl, nn, r0 == 1, more, b, prof, pstride, bnd,
                             bstride, gap_open, gap_ext, e_border);
    }
    // the lane holding row m ended the strip at column n: the final cell
    if (busy && first <= m && m < first + R) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (first + r == m) {
          *out_mt = nw_path_mt<NWD>(s.cW[r]);
          *out_ln = nw_path_ln<NWD>(s.cW[r]);
        }
      }
    }
    __syncwarp();
  }
}

// Strip s of one pair on a whole warp (G = 32 lanes of R rows), one item of
// nw_gotoh_xl's queue; every lane of the warp calls it.  a, b, m, n, sub_t,
// prof, pstride, bnd, bstride as for nw_pair_sweep; strip s reads the
// boundary row that strip s-1 writes, and writes its own over it.
// progress: the item's progress word; progress[-1] is strip s-1's, which
// this strip waits on (the wrapper's table keeps a pair's strips
// consecutive and in order).  The strip waits and publishes every G steps
// (no more, or the row above would be overwritten before it is read).
template <int R, int NWD>
__device__ __forceinline__ void nw_strip_sweep(
    const int* __restrict__ a, const int* __restrict__ b, int m, int n, int s,
    const int* __restrict__ sub_t, int gap_open, int gap_ext, int* prof,
    int pstride, int* bnd, int bstride, int* progress, int* out_mt,
    int* out_ln) {
  constexpr int G = 32;
  using Lane = NwLane<G, R, NWD, true>;
  const int gl = threadIdx.x & 31;
  const int r0 = 1 + s * G * R;  // the strip's first row
  if (m == 0 || n == 0) {  // the path is one border gap; the table gives
    if (s == 0 && gl == 0) {  // such a pair one item
      *out_mt = 0;
      *out_ln = m + n;
    }
    return;
  }
  if (r0 > m) return;  // no such strip (the wrapper makes none)
  const bool more = r0 + G * R <= m;
  Lane L;
  const int e_border = L.begin(true, a, b, m, r0, gl, sub_t, prof, pstride,
                               gap_open, gap_ext);
  int seen = 0;  // lane 0: the column up to which strip s-1 has published
  // lane 0 waits until strip s-1 has written bnd up to column need; the
  // warp meets before its next shuffle
  auto wait_for = [&](int need) {
    if (s > 0) {
      if (gl == 0 && need > seen) {
        while ((seen = nw_load_acquire(progress - 1)) < need) __nanosleep(100);
      }
      __syncwarp();
    }
  };
  // after step k1 the last lane has written bnd up to column k1 - (G - 1)
  auto publish = [&](int k1) {
    if (more) {
      __syncwarp();  // lane 0's reads of bnd come before the word too
      if (gl == G - 1) {
        const int c = k1 - (G - 1);
        nw_store_release(progress, c < n ? c : n);
      }
    }
  };
  // lanes past the one holding row m have nothing to compute, and that
  // lane's last step is at column n
  const int last = (m - r0) / R < G - 1 ? (m - r0) / R : G - 1;
  const int steps = n + last;
  // some lane sits at column 1 in the first G steps only; lane 0 reads
  // column k + 1 at step k
  const int edge_steps = steps < G ? steps : G;
  wait_for(edge_steps + 1 < n ? edge_steps + 1 : n);
  if (gl == 0 && s > 0) L.load_next(bnd, bstride, 1);
  for (int k = 1; k <= edge_steps; ++k) {
    L.template step<true>(k, gl, n, s == 0, more, b, prof, pstride, bnd,
                          bstride, gap_open, gap_ext, e_border);
  }
  publish(edge_steps);
  for (int k0 = G + 1; k0 <= steps; k0 += G) {
    const int k1 = k0 + G - 1 < steps ? k0 + G - 1 : steps;
    wait_for(k1 + 1 < n ? k1 + 1 : n);
#pragma unroll 1
    for (int k = k0; k <= k1; ++k) {
      L.template step<false>(k, gl, n, s == 0, more, b, prof, pstride, bnd,
                             bstride, gap_open, gap_ext, e_border);
    }
    publish(k1);
  }
  // the lane holding row m ended the strip at column n: the final cell
  const int first = r0 + gl * R;
  if (first <= m && m < first + R) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (first + r == m) {
        *out_mt = nw_path_mt<NWD>(L.cW[r]);
        *out_ln = nw_path_ln<NWD>(L.cW[r]);
      }
    }
  }
}

#endif  // DYNAALIGN_NW_CELL_CUH_
