// Gotoh Needleman–Wunsch percent identity for a batch of sequence pairs of
// padded max(m, n) + 1 <= 1120: a group of lanes per pair, DP state in
// registers.
//
// Replaces the Pallas TPU kernel ops/nw_pallas.py::_kernel of the JAX
// package (:302, launched by _run_kernel :831).  It computes what that kernel
// computes — for each pair, the (matches, alignment_length) of the
// reference's greedy D>U>L traceback (src/pairwiseSeqAlign.cpp:209-313) —
// and writes them as two int32 outputs.  None of the TPU kernel's
// VMEM/VPU machinery is carried over (band classes, int16 planes, packed
// output); its per-pair score slab has a counterpart, the query profile of
// csrc/nw_cell.cuh.
//
// Bound on this card: integer operations, NW_OPS_PER_CELL = 12 per DP cell
// with Hopper's fused add-max, max-with-predicate and dp4a, of which
// NW_ALU_OPS_PER_CELL = 8 run on the 64 integer ALU lanes of an SM alone
// (derived in nw_cell.cuh); the function's own bytes (sequences in, two
// ints out per pair) are tiny beside them.  The first version of this
// kernel gave one thread to each pair and kept the previous DP row in
// global memory: 44 bytes of scratch traffic per cell, which it spent its
// time waiting for.
//
// Design (the sweep itself is nw_pair_sweep of nw_cell.cuh):
// * No global scratch.  A pair is served by a group of G lanes, lane t
//   owning R consecutive DP rows whose state (M, Iy, packed MT/LN, the
//   a-character) sits in registers; the lanes sweep the columns skewed by
//   one step each and hand the row above down by three width-G shuffles.
//   m + n <= 2,238 here, so MT and LN always share one word.
// * One instantiation per launch, picked by the wrapper from the batch's
//   largest a_len (NW_INSTANCES below; ops/nw_cuda.py mirrors the list).
//   Beside each entry: the rows a strip holds, and at the length it is
//   meant for the share of computed rows and of steps that are real.
//     0: G = 1,  R = 12:   12 rows.  12-mers: rows 12/12, steps 12/12; a
//        thread per pair, no shuffle, no skew.
//     1: G = 4,  R = 8:    32 rows.  at 32 x 32: rows 32/32, steps 32/35.
//     2: G = 16, R = 8:   128 rows.  at 128 x 128: rows 1, steps 128/143.
//     3: G = 16, R = 18:  288 rows.  at 288 x 288: rows 1, steps 288/303.
//     4: G = 32, R = 18:  576 rows a strip.  h3n2's 566 aa in one strip:
//        rows 566/576 = 98%, steps 566/597 = 95%; up to 1,119 rows in two
//        strips (at 1,119: rows 1,119/1,152 = 97%).
//   A shorter pair in a batch leaves the lanes past its last row idle:
//   rows a_len / (G * R).
// * Shared memory, all dynamic: the block's query profiles (NW_SYMS * 64
//   threads * ceil(R / 4) words: 32,000 bytes at R = 18, which would let 7
//   blocks share an SM) and, only when a pair needs a second strip, a
//   boundary row of 3 planes * (N + 1) words per pair (13,440 bytes at
//   N = 1,119).
// * Registers: R = 18 keeps 4 * 18 = 72 state words, and ptxas takes 166
//   registers for that instantiation when it is free to.  Held to 7 blocks
//   an SM (144 registers) it spills a word that the step loop reloads at
//   every step; __launch_bounds__(64, 6) lets it have the 166, so 6 blocks
//   = 12 warps an SM run, with no spill (chip_smoke.py prints the ptxas
//   lines).  On an h3n2 launch 3 to 7 blocks an SM all take the same time
//   (tools/nw_variants.py), so occupancy is not what bounds the kernel.
// * Warp convergence: every lane of a warp runs the step count of its
//   longest group with the full mask; whole warps past the batch return.

#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

#include <stddef.h>

#include "nw_cell.cuh"

#ifndef NW_THREADS
#define NW_THREADS 64  // threads per block: NW_THREADS / G pairs
#endif
#ifndef NW_BLOCKS_PER_SM
#define NW_BLOCKS_PER_SM 6  // __launch_bounds__: 12 warps an SM
#endif
#define NW_BND_PLANES 3  // boundary row: M, Ix, packed MT/LN

// index, lanes per pair G, rows per lane R; ordered by capacity G * R, the
// last one also runs pairs of more than one strip
#define NW_INSTANCES(X) X(0, 1, 12) X(1, 4, 8) X(2, 16, 8) X(3, 16, 18) \
  X(4, 32, 18)

extern __shared__ __align__(16) int nw_dyn[];

// a_idx [B, M], b_idx [B, N] int32 alphabet indices; a_len, b_len [B];
// sub_t [32, 32] the table transposed (sub_t[b][a]), in global memory;
// out_mt, out_ln [B].  Dynamic shared memory: NW_SYMS * blockDim.x * ceil(R
// / 4) profile words, then, when bnd_cols > 0, NW_BND_PLANES * bnd_cols
// words per pair of the block (bnd_cols = N + 1; 0 when no pair of the
// batch has more than G * R rows).
template <int G, int R>
__global__ void __launch_bounds__(NW_THREADS, NW_BLOCKS_PER_SM)
nw_gotoh_kernel(const int* __restrict__ a_idx, const int* __restrict__ a_len,
                const int* __restrict__ b_idx, const int* __restrict__ b_len,
                const int* __restrict__ sub_t, int B, int M, int N,
                int gap_open, int gap_ext, int bnd_cols,
                int* __restrict__ out_mt, int* __restrict__ out_ln) {
  constexpr int RW = (R + 3) / 4;
  const int tid = threadIdx.x, threads = blockDim.x;
  const int slot = tid / G;  // the group's pair within the block
  const int p = blockIdx.x * (threads / G) + slot;
  // the first pair of this thread's warp: past the batch, the warp is idle
  if (p - (tid & 31) / G >= B) return;
  const bool live = p < B;
  const size_t q = live ? p : 0;
  int* prof = nw_dyn + tid * RW;
  int* bnd = nw_dyn + NW_SYMS * threads * RW + slot * NW_BND_PLANES * bnd_cols;
  nw_pair_sweep<G, R, 1>(live, a_idx + q * M, b_idx + q * N,
                         live ? a_len[q] : 0, live ? b_len[q] : 0, sub_t,
                         gap_open, gap_ext, prof, threads * RW, bnd, bnd_cols,
                         out_mt + q, out_ln + q);
}

// Words of dynamic shared memory a block of instantiation (G, R) takes for
// padded width N when the batch's largest a_len is a_max; *bnd_cols is the
// kernel's argument of that name.
template <int G, int R>
static inline size_t nw_gotoh_smem_words(int a_max, int N, int* bnd_cols) {
  *bnd_cols = a_max > G * R ? N + 1 : 0;
  const size_t scores = (size_t)NW_SYMS * NW_THREADS * ((R + 3) / 4);
  return scores + (size_t)(NW_THREADS / G) * NW_BND_PLANES * *bnd_cols;
}

#ifdef __CUDACC__
template <int G, int R>
static int nw_gotoh_launch_as(const int* a_idx, const int* a_len,
                              const int* b_idx, const int* b_len,
                              const int* sub_t, int B, int M, int N,
                              int gap_open, int gap_ext, int a_max,
                              int* out_mt, int* out_ln,
                              cudaStream_t stream) {
  const int pairs = NW_THREADS / G;  // per block
  int bnd_cols;
  const size_t smem =
      sizeof(int) * nw_gotoh_smem_words<G, R>(a_max, N, &bnd_cols);
  // the kernel hardly reads global memory: give the SM's L1 to the blocks'
  // shared memory, whatever carve-out the kernel before it left
  cudaError_t rc = cudaFuncSetAttribute(
      nw_gotoh_kernel<G, R>, cudaFuncAttributePreferredSharedMemoryCarveout,
      cudaSharedmemCarveoutMaxShared);
  if (rc == cudaSuccess) {
    rc = cudaFuncSetAttribute(nw_gotoh_kernel<G, R>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
  }
  if (rc != cudaSuccess) return (int)rc;
  nw_gotoh_kernel<G, R><<<(B + pairs - 1) / pairs, NW_THREADS, smem, stream>>>(
      a_idx, a_len, b_idx, b_len, sub_t, B, M, N, gap_open, gap_ext, bnd_cols,
      out_mt, out_ln);
  return (int)cudaGetLastError();
}

// Launch instantiation `inst` of NW_INSTANCES on `stream`; a_max is the
// batch's largest a_len.  Returns the CUDA error of the attribute call or
// the launch (0 on success), -1 for an unknown `inst`.  The caller
// allocates the outputs; there is no scratch.
extern "C" int nw_gotoh_launch(const void* a_idx, const void* a_len,
                               const void* b_idx, const void* b_len,
                               const void* sub_t, int B, int M, int N,
                               int gap_open, int gap_ext, int inst, int a_max,
                               void* out_mt, void* out_ln, void* stream) {
  if (B <= 0) return (int)cudaGetLastError();
  switch (inst) {
#define NW_CASE(I, G, R)                                                     \
  case I:                                                                    \
    return nw_gotoh_launch_as<G, R>(                                         \
        (const int*)a_idx, (const int*)a_len, (const int*)b_idx,             \
        (const int*)b_len, (const int*)sub_t, B, M, N, gap_open, gap_ext,    \
        a_max, (int*)out_mt, (int*)out_ln, (cudaStream_t)stream);
    NW_INSTANCES(NW_CASE)
#undef NW_CASE
  }
  return -1;
}
#endif
