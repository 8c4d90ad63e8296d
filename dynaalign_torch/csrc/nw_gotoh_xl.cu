// Gotoh Needleman–Wunsch percent identity for long pairs: one warp per pair.
//
// Replaces the Pallas TPU kernel ops/nw_pallas.py::_kernel_xl of the JAX
// package (:1093, launched by nw_similarity_batch_pallas_xl :1220).  It
// computes what csrc/nw_gotoh.cu computes — for each pair, the (matches,
// alignment_length) of the reference's greedy D>U>L traceback
// (src/pairwiseSeqAlign.cpp:209-313), carried as the forward (MT, LN)
// recurrence of ops/nw.py with the border/interior gap asymmetry and the
// INT_MIN/2 sentinel — and writes them as two int32 outputs.  It has no
// length ceiling: int32 holds every score and length up to m+n ~ 10^8.
//
// Where the two CUDA kernels differ is where the parallelism lies.
// nw_gotoh.cu gives one thread to each pair; a set of a few thousand long
// pairs would then be a few thousand threads, each sweeping millions of
// cells in series.  The TPU kernel parallelises inside a pair (DP rows on
// lanes, 8 pairs on sublanes), and so does this one.  None of the TPU
// layout is carried over (transpose, 128-lane padding, the [6, MP1, B]
// score slab): the card reads the table from shared memory.
//
// Design:
// * One warp per pair, XL_WARPS pairs per block.
// * Strips of rows.  Lane t owns XL_R consecutive DP rows, so one pass of
//   the warp covers a strip of 32 * XL_R rows.  Lane t keeps its rows'
//   a-characters (as substitution-table row offsets) and its rows' column
//   j-1 values (M, Ix, Iy, MT, LN) in registers.
// * Skewed sweep.  At step k lane t works column j = k - t.  The cell above
//   its first row is lane t-1's last row, computed one step earlier: five
//   __shfl_up_sync per step hand it over, and the value handed over at the
//   previous step is the diagonal.  The shift probe (probe_shift.cu) finds
//   a shuffle dearer than a shared-memory load one row lower, but that
//   load pays only for values already in shared memory; these sit in
//   registers, where shared memory would cost a store, a load and a
//   __syncwarp per value, so the hand-off stays a shuffle.
// * Lane 0's first row reads the previous strip's bottom row from a
//   per-pair global boundary row, XL_PLANES planes of N+1 int32, which the
//   last lane writes.  That is the only scratch: 20 (N+1) bytes per pair.
//   In one strip lane 0 reads column j at step j and lane 31 writes it at
//   step j+31, from a value that depends on what lane 0 read (through the
//   shuffles), so one buffer is safe; __syncwarp() between strips orders
//   lane 31's writes before lane 0's reads of the next strip.
// * Warp convergence: every lane stays in the step loop with the full mask
//   until the strip is done.  Columns outside [1, b_len] are skipped under a
//   predicate that holds no shuffle; rows past a_len are computed and never
//   read.  Only whole warps return early.
// * Loads: at one step the lanes sit on 32 neighbouring columns, so the
//   b-character loads coalesce; each lane fetches its next character, and
//   lane 0 its next boundary cell, one step ahead.
//
// Bound on this card: about 20 int32 operations per DP cell (3 for Ix, 3
// for Iy, 3 for the diagonal, 4 for the D>U>L decision, 6 selects, 1 for
// the match), plus 5 / XL_R shuffles.  The inputs and the boundary row are
// tiny beside that, so operations bound it; the design keeps every DP value
// in registers, so the loop is nearly all such operations.

#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

#include <stddef.h>

#define XL_NEG (-1073741824)  // INT_MIN / 2, the reference's sentinel
#define XL_SUB 32             // padded substitution table width
#define XL_R 8                // DP rows per lane
#define XL_WARPS 4            // pairs (warps) per block
#define XL_PLANES 5           // boundary row: M, Ix, Iy, MT, LN
#define XL_FULL 0xffffffffu

__device__ __forceinline__ int xl_max(int x, int y) { return x > y ? x : y; }

// a_idx [B, M], b_idx [B, N] int32 alphabet indices; a_len, b_len [B];
// sub [32, 32]; bnd int32 [B, XL_PLANES, N+1]; out_mt, out_ln [B].
// Any block of whole warps works; the launch below uses XL_WARPS.
__global__ void __launch_bounds__(XL_WARPS * 32) nw_gotoh_xl_kernel(
    const int* __restrict__ a_idx, const int* __restrict__ a_len,
    const int* __restrict__ b_idx, const int* __restrict__ b_len,
    const int* __restrict__ sub, int B, int M, int N, int gap_open,
    int gap_ext, int* bnd, int* __restrict__ out_mt,
    int* __restrict__ out_ln) {
  __shared__ int s_sub[XL_SUB * XL_SUB];
  for (int k = threadIdx.x; k < XL_SUB * XL_SUB; k += blockDim.x) {
    s_sub[k] = sub[k];
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int p = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (p >= B) return;  // the whole warp
  const int m = a_len[p];
  const int n = b_len[p];
  if (m == 0 || n == 0) {  // the whole warp: the path is one border gap
    if (lane == 0) {
      out_mt[p] = 0;
      out_ln[p] = m + n;
    }
    return;
  }
  const int* a = a_idx + (size_t)p * M;
  const int* b = b_idx + (size_t)p * N;
  const size_t plane = (size_t)N + 1;
  int* bM = bnd + (size_t)p * XL_PLANES * plane;  // column j at [j]
  int* bIx = bM + plane;
  int* bIy = bM + 2 * plane;
  int* bMT = bM + 3 * plane;
  int* bLN = bM + 4 * plane;
  const int go_ge = gap_open + gap_ext;

  for (int r0 = 1; r0 <= m; r0 += 32 * XL_R) {  // the strip's first row
    const int first = r0 + lane * XL_R;          // this lane's first row
    int aoff[XL_R], cM[XL_R], cIx[XL_R], cIy[XL_R], cMT[XL_R], cLN[XL_R];
#pragma unroll
    for (int r = 0; r < XL_R; ++r) {
      const int i = first + r;
      aoff[r] = (i <= m ? a[i - 1] : XL_SUB - 1) * XL_SUB;
      // column 0 of row i: the 'U' border, Ix = -gap_open - (i-1)*gap_ext
      cM[r] = XL_NEG;
      cIx[r] = -gap_open - (i - 1) * gap_ext;
      cIy[r] = XL_NEG;
      cMT[r] = 0;
      cLN[r] = i;
    }
    // diagonal of the first row at column 1: cell (first-1, 0), the origin
    // or a 'U' border cell; kept as max(M, Ix, Iy), MT, LN
    int dBest = first == 1 ? 0 : -gap_open - (first - 2) * gap_ext;
    int dMT = 0, dLN = first - 1;
    // next step's b-character and (lane 0, later strips) boundary cell
    int bNext = lane == 0 ? b[0] : 0;
    int nM = 0, nIx = 0, nIy = 0, nMT = 0, nLN = 0;
    if (lane == 0 && r0 > 1) {
      nM = bM[1];
      nIx = bIx[1];
      nIy = bIy[1];
      nMT = bMT[1];
      nLN = bLN[1];
    }
    // lanes past the one holding row m have nothing to compute, and that
    // lane's last step is at column n
    const int last = (m - r0) / XL_R < 31 ? (m - r0) / XL_R : 31;
    const int steps = n + last;
    for (int k = 1; k <= steps; ++k) {
      // the cell above the first row: lane t-1's last row at this column
      int uM = __shfl_up_sync(XL_FULL, cM[XL_R - 1], 1);
      int uIx = __shfl_up_sync(XL_FULL, cIx[XL_R - 1], 1);
      int uIy = __shfl_up_sync(XL_FULL, cIy[XL_R - 1], 1);
      int uMT = __shfl_up_sync(XL_FULL, cMT[XL_R - 1], 1);
      int uLN = __shfl_up_sync(XL_FULL, cLN[XL_R - 1], 1);
      const int j = k - lane;
      const int bj = bNext;
      if (j >= 0 && j < n) bNext = b[j];  // column j+1
      if (lane == 0) {
        if (r0 == 1) {  // row 0: the 'L' border, Iy = -gap_open - (j-1)*ge
          uM = XL_NEG;
          uIx = XL_NEG;
          uIy = -gap_open - (j - 1) * gap_ext;
          uMT = 0;
          uLN = j;
        } else {
          uM = nM;
          uIx = nIx;
          uIy = nIy;
          uMT = nMT;
          uLN = nLN;
          if (j < n) {
            nM = bM[j + 1];
            nIx = bIx[j + 1];
            nIy = bIy[j + 1];
            nMT = bMT[j + 1];
            nLN = bLN[j + 1];
          }
        }
      }
      if (j >= 1 && j <= n) {
        const int bj32 = bj * XL_SUB;
        int pBest = dBest, pMT = dMT, pLN = dLN;  // diagonal of row r
        dBest = xl_max(uM, xl_max(uIx, uIy));     // next step's diagonal
        dMT = uMT;
        dLN = uLN;
#pragma unroll
        for (int r = 0; r < XL_R; ++r) {
          const int ix = xl_max(uM - go_ge, uIx - gap_ext);
          const int iy = xl_max(cM[r] - go_ge, cIy[r] - gap_ext);
          const int diag = pBest + s_sub[aoff[r] + bj];
          int mc, mt, ln;
          if (diag >= ix && diag >= iy) {  // traceback priority D > U > L
            mc = diag;
            mt = pMT + (aoff[r] == bj32);
            ln = pLN + 1;
          } else if (ix >= iy) {
            mc = ix;
            mt = uMT;
            ln = uLN + 1;
          } else {
            mc = iy;
            mt = cMT[r];
            ln = cLN[r] + 1;
          }
          // row r at column j-1 is the next row's diagonal
          pBest = xl_max(cM[r], xl_max(cIx[r], cIy[r]));
          pMT = cMT[r];
          pLN = cLN[r];
          cM[r] = mc;
          cIx[r] = ix;
          cIy[r] = iy;
          cMT[r] = mt;
          cLN[r] = ln;
          uM = mc;
          uIx = ix;
          uMT = mt;
          uLN = ln;
        }
        if (lane == 31) {
          bM[j] = cM[XL_R - 1];
          bIx[j] = cIx[XL_R - 1];
          bIy[j] = cIy[XL_R - 1];
          bMT[j] = cMT[XL_R - 1];
          bLN[j] = cLN[XL_R - 1];
        }
      }
    }
    // the lane holding row m ended the strip at column n: the final cell
    if (first <= m && m < first + XL_R) {
#pragma unroll
      for (int r = 0; r < XL_R; ++r) {
        if (first + r == m) {
          out_mt[p] = cMT[r];
          out_ln[p] = cLN[r];
        }
      }
    }
    __syncwarp();
  }
}

#ifdef __CUDACC__
// Launch on `stream`; returns cudaGetLastError() (0 on success).  The
// caller allocates the boundary rows (XL_PLANES * (N+1) * B ints) and the
// outputs.
extern "C" int nw_gotoh_xl_launch(const void* a_idx, const void* a_len,
                                  const void* b_idx, const void* b_len,
                                  const void* sub, int B, int M, int N,
                                  int gap_open, int gap_ext, void* bnd,
                                  void* out_mt, void* out_ln, void* stream) {
  if (B > 0) {
    const int blocks = (B + XL_WARPS - 1) / XL_WARPS;
    nw_gotoh_xl_kernel<<<blocks, XL_WARPS * 32, 0, (cudaStream_t)stream>>>(
        (const int*)a_idx, (const int*)a_len, (const int*)b_idx,
        (const int*)b_len, (const int*)sub, B, M, N, gap_open, gap_ext,
        (int*)bnd, (int*)out_mt, (int*)out_ln);
  }
  return (int)cudaGetLastError();
}
#endif
