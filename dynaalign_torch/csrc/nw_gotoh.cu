// Gotoh Needleman–Wunsch percent identity for a batch of sequence pairs.
//
// Replaces the Pallas TPU kernel ops/nw_pallas.py::_kernel of the JAX
// package (:302, launched by _run_kernel :831).  It computes what that kernel
// computes — for each pair, the (matches, alignment_length) of the
// reference's greedy D>U>L traceback (src/pairwiseSeqAlign.cpp:209-313) —
// and writes them as two int32 outputs.  None of the TPU kernel's
// VMEM/VPU machinery is carried over (packed substitution slab, band
// classes, int16 planes, packed output).
//
// Design: one thread per pair sweeps its DP grid row by row, as the C++
// oracle does (cpp/oracle.cpp:205-241).  Instead of a traceback matrix it
// carries the forward (MT, LN) recurrence of ops/nw.py: the traceback's
// decision at a cell depends only on that cell's (M, Ix, Iy) comparison, so
// (matches, length) of the path back to (0, 0) is the chosen ancestor's
// pair plus one step.  That recurrence does not depend on sweep order.
//
// Memory: the previous row of the five planes M, Ix, Iy, MT, LN lives in a
// global scratch row of n+1 columns, plus a sixth plane holding the pair's
// b sequence; every plane is laid out pair-minor ([column][pair]) so the
// threads of a warp, which sit at the same column, touch neighbouring
// addresses.  The diagonal ancestor's five values are kept in registers
// before the sweep overwrites them, and the left neighbour is the value the
// thread just computed.  The padded 32x32 substitution table sits in shared
// memory.  Each thread stops at its own (a_len, b_len).
//
// Bound on this card: the useful work is integer ALU, about 20 int32
// operations per DP cell (3 for Ix, 3 for Iy, 3 for the diagonal, 4 for
// the D>U>L decision, 6 selects for M/MT/LN, 1 for the match).  The
// function's own bytes (sequences in, two ints out per pair) are tiny.
// This first design also moves 24 bytes of scratch reads and 20 bytes of
// scratch writes per cell; at a chunk of 10^5 pairs the rows do not fit in
// L2, so the scratch traffic, not the ALU, is what it spends its time on.
// A later design keeps the rows on chip (anti-diagonal wavefront in shared
// memory, one block per tile of pairs) and removes it.

#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

#include <stddef.h>

#define NW_NEG (-1073741824)  // INT_MIN / 2, the reference's sentinel
#define NW_SUB 32             // padded substitution table width
#define NW_THREADS 128        // threads (pairs) per block
#define NW_PLANES 6           // M, Ix, Iy, MT, LN rows + the b sequence

__device__ __forceinline__ int nw_max(int x, int y) { return x > y ? x : y; }

// a_idx [B, M], b_idx [B, N] int32 alphabet indices; a_len, b_len [B];
// sub [32, 32]; scratch int32 [NW_PLANES, N+1, B]; out_mt, out_ln [B].
__global__ void __launch_bounds__(NW_THREADS) nw_gotoh_kernel(
    const int* __restrict__ a_idx, const int* __restrict__ a_len,
    const int* __restrict__ b_idx, const int* __restrict__ b_len,
    const int* __restrict__ sub, int B, int M, int N, int gap_open,
    int gap_ext, int* __restrict__ scratch, int* __restrict__ out_mt,
    int* __restrict__ out_ln) {
  __shared__ int s_sub[NW_SUB * NW_SUB];
  for (int k = threadIdx.x; k < NW_SUB * NW_SUB; k += blockDim.x) {
    s_sub[k] = sub[k];
  }
  __syncthreads();

  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= B) return;
  const int m = a_len[p];
  const int n = b_len[p];
  const int* a = a_idx + (size_t)p * M;
  const int* b = b_idx + (size_t)p * N;
  const size_t plane = (size_t)(N + 1) * B;
  int* rM = scratch + p;  // column j of plane k at [k * plane + j * B]
  int* rIx = rM + plane;
  int* rIy = rM + 2 * plane;
  int* rMT = rM + 3 * plane;
  int* rLN = rM + 4 * plane;
  int* rB = rM + 5 * plane;  // b[j-1] at column j
  const int go_ge = gap_open + gap_ext;

  // Row 0: M[0][0] = 0; Iy[0][j] = -gap_open - (j-1)*gap_ext ('L' border).
  rM[0] = 0;
  rIx[0] = NW_NEG;
  rIy[0] = NW_NEG;
  rMT[0] = 0;
  rLN[0] = 0;
  for (int j = 1; j <= n; ++j) {
    const size_t o = (size_t)j * B;
    rM[o] = NW_NEG;
    rIx[o] = NW_NEG;
    rIy[o] = -gap_open - (j - 1) * gap_ext;
    rMT[o] = 0;
    rLN[o] = j;
    rB[o] = b[j - 1];
  }

  for (int i = 1; i <= m; ++i) {
    const int ai = a[i - 1];
    const int* srow = s_sub + ai * NW_SUB;
    // diagonal ancestor of column 1: row i-1, column 0
    int dM = rM[0], dIx = rIx[0], dIy = rIy[0], dMT = rMT[0], dLN = rLN[0];
    // column 0 of row i: the 'U' border, Ix = -gap_open - (i-1)*gap_ext
    int lM = NW_NEG, lIy = NW_NEG, lMT = 0, lLN = i;
    rM[0] = NW_NEG;
    rIx[0] = -gap_open - (i - 1) * gap_ext;
    rIy[0] = NW_NEG;
    rMT[0] = 0;
    rLN[0] = i;
    for (int j = 1; j <= n; ++j) {
      const size_t o = (size_t)j * B;
      const int uM = rM[o], uIx = rIx[o], uIy = rIy[o];
      const int uMT = rMT[o], uLN = rLN[o];
      const int bj = rB[o];
      const int ix = nw_max(uM - go_ge, uIx - gap_ext);
      const int iy = nw_max(lM - go_ge, lIy - gap_ext);
      const int diag = nw_max(dM, nw_max(dIx, dIy)) + srow[bj];
      int mc, mt, ln;
      if (diag >= ix && diag >= iy) {  // traceback priority D > U > L
        mc = diag;
        mt = dMT + (ai == bj);
        ln = dLN + 1;
      } else if (ix >= iy) {
        mc = ix;
        mt = uMT;
        ln = uLN + 1;
      } else {
        mc = iy;
        mt = lMT;
        ln = lLN + 1;
      }
      rM[o] = mc;
      rIx[o] = ix;
      rIy[o] = iy;
      rMT[o] = mt;
      rLN[o] = ln;
      dM = uM;
      dIx = uIx;
      dIy = uIy;
      dMT = uMT;
      dLN = uLN;
      lM = mc;
      lIy = iy;
      lMT = mt;
      lLN = ln;
    }
  }
  // row m, column n holds the pair's final cell (row 0 when m == 0)
  out_mt[p] = rMT[(size_t)n * B];
  out_ln[p] = rLN[(size_t)n * B];
}

#ifdef __CUDACC__
// Launch on `stream`; returns cudaGetLastError() (0 on success).  The
// caller allocates scratch (NW_PLANES * (N+1) * B ints) and the outputs.
extern "C" int nw_gotoh_launch(const void* a_idx, const void* a_len,
                               const void* b_idx, const void* b_len,
                               const void* sub, int B, int M, int N,
                               int gap_open, int gap_ext, void* scratch,
                               void* out_mt, void* out_ln, void* stream) {
  if (B > 0) {
    const int blocks = (B + NW_THREADS - 1) / NW_THREADS;
    nw_gotoh_kernel<<<blocks, NW_THREADS, 0, (cudaStream_t)stream>>>(
        (const int*)a_idx, (const int*)a_len, (const int*)b_idx,
        (const int*)b_len, (const int*)sub, B, M, N, gap_open, gap_ext,
        (int*)scratch, (int*)out_mt, (int*)out_ln);
  }
  return (int)cudaGetLastError();
}
#endif
