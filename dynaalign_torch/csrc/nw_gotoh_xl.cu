// Gotoh Needleman–Wunsch percent identity for long pairs: a queue of strips,
// one warp a strip.
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
// Where the two CUDA kernels differ is where the strips' boundary row
// lives.  nw_gotoh.cu keeps it in shared memory, which holds pairs of up to
// 1,119 aa; this kernel keeps it in global memory, gives a whole warp to
// each strip, and so takes any length.  The TPU kernel parallelises inside a
// pair (DP rows on lanes, 8 pairs on sublanes), and so does this one.  Of
// the TPU layout nothing is carried over (transpose, 128-lane padding) but
// the idea of its [6, MP1, B] score slab: a per-pair query profile.
//
// Design (the sweep itself is in csrc/nw_cell.cuh: nw_strip_sweep here,
// nw_pair_sweep in csrc/nw_gotoh.cu):
// * A queue of strips, longest pair first.  The wrapper (ops/nw_cuda.py,
//   xl_work_table) orders the pairs by a_len * b_len, descending, ties by
//   index, and expands each into its ceil(a_len / (32 * XL_R)) strips in
//   order (one item for a pair without cells): items[k] = (pair, strip).
//   The grid has a warp per item; each warp takes a ticket k from a counter
//   with atomicAdd and runs item k.  One long pair no longer runs on one
//   warp after everything else has finished: its strips start first and
//   run on as many warps as it has strips, each a chunk of columns behind
//   the one above it (nw_cell.cuh: a boundary row a pair in global memory,
//   a progress word per item, release/acquire).
// * Deadlock freedom by dequeue order: a strip waits only on the strip
//   before it, whose ticket an earlier atomicAdd gave to a warp that is
//   running.  The ticket, not the block index, picks the item, so no block
//   order or residency matters: a block index would let a resident warp
//   wait on a block the card has not started.  (A persistent grid of one
//   wave, each warp looping over tickets, ran slower on the card: PERF.md.)
// * Outputs go to the pair's own index: the caller sees input order.
//   Strips follow a, never b: the D>U>L traceback breaks ties by
//   orientation, so (a, b) and (b, a) may differ.
// * Strips of rows.  Lane t owns XL_R consecutive DP rows, so a strip is
//   32 * XL_R rows.  Lane t keeps its rows' a-characters and column j-1
//   values (M, Iy, MT, LN) in registers.
// * Skewed sweep.  At step k lane t works column j = k - t.  The cell above
//   its first row is lane t-1's last row, computed one step earlier:
//   __shfl_up_sync hands over its M, Ix, MT and LN, and the M handed over
//   at the previous step is the diagonal's best (nw_cell.cuh says why M
//   suffices).  The shift probe (probe_shift.cu) finds a shuffle dearer than
//   a shared-memory load one row lower, but that load pays only for values
//   already in shared memory; these sit in registers, where shared memory
//   would cost a store, a load and a __syncwarp per value, so the hand-off
//   stays a shuffle.
// * Two instantiations.  Where M + N < 65,536, MT and LN travel as one
//   word (one select chain, one shuffle and one boundary plane fewer);
//   longer pairs keep two words.  The launcher picks (nw_gotoh_xl_words).
// * Scratch: a boundary row a pair, XL_PLANES(NWD) = 2 + NWD planes of
//   N+1 int32 (M, Ix, and MT/LN packed or not): 12 or 16 (N+1) bytes a
//   pair; and a zeroed word per item plus the ticket counter.
// * XL_R = 20 rows a lane (strips of 640 rows) and XL_WARPS = 2: a step's
//   fixed cost (shuffles, the b-character, lane 0's boundary cell, the
//   branches: about 100 SASS instructions) is shared by more cells.  With
//   8 rows and 4 warps the long set took 72-74 ms, with 16 and 2 60-62 ms,
//   with 20 and 2 59 ms, with 24 and 2 59 ms at 168 registers, all under
//   the one-warp-a-pair schedule the queue replaced (tools/nw_variants.py;
//   the runs are in PERF.md and in git history).
//   A strip waits and publishes every 32 steps (nw_cell.cuh), so it starts
//   about 64-96 steps after the one above it.
// * Scores: each strip builds the warp's query profile in shared memory
//   (NW_SYMS symbols x 32 lanes x 5 words of four int8), and a lane reads
//   its 20 rows' scores for a column with five loads whose bank depends on
//   the lane alone.
// * Warp convergence: every lane stays in the step loop with the full mask
//   until the strip is done.  Columns outside [1, b_len] are skipped under a
//   predicate that holds no shuffle; rows past a_len are computed and never
//   read.  Only lane 0 spins on a progress word, and the warp meets at a
//   __syncwarp() before its next shuffle.
// * Loads: at one step the lanes sit on 32 neighbouring columns, so the
//   b-character loads coalesce; each lane fetches its next character, and
//   lane 0 its next boundary cell, one step ahead.
//
// Bound on this card: NW_OPS_PER_CELL = 12 integer operations per DP cell,
// NW_ALU_OPS_PER_CELL = 8 of them on the integer ALU lanes alone (derived
// in nw_cell.cuh), plus (2 + NWD) / XL_R shuffles.  The inputs and
// the boundary rows are tiny beside that, so operations bound it; the
// design keeps every DP value in registers, so the loop is nearly all such
// operations.

#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

#include <stddef.h>

#include "nw_cell.cuh"

#ifndef XL_R
#define XL_R 20               // DP rows per lane
#endif
#ifndef XL_WARPS
#define XL_WARPS 2            // warps per block
#endif
#define XL_PLANES(NWD) (2 + (NWD))  // boundary row: M, Ix, path word(s)
#define XL_PACK_LIMIT 65536  // padded M + N from which MT, LN take two words

// a_idx [B, M], b_idx [B, N] int32 alphabet indices; a_len, b_len [B];
// sub_t [32, 32] the table transposed (sub_t[b][a]), in global memory;
// items int32 [n_items, 2], (pair, strip), a pair's strips consecutive and
// in order; bnd int32 [B, XL_PLANES(NWD), N+1]; queue: one int32, 0;
// progress int32 [n_items], 0; out_mt, out_ln [B].  Blocks of XL_WARPS
// warps, at least n_items warps in all.
template <int NWD>
__global__ void __launch_bounds__(XL_WARPS * 32) nw_gotoh_xl_kernel(
    const int* __restrict__ a_idx, const int* __restrict__ a_len,
    const int* __restrict__ b_idx, const int* __restrict__ b_len,
    const int* __restrict__ sub_t, int B, int M, int N, int gap_open,
    int gap_ext, const int* __restrict__ items, int n_items, int* bnd,
    int* queue, int* progress, int* __restrict__ out_mt,
    int* __restrict__ out_ln) {
  constexpr int RW = (XL_R + 3) / 4;
  __shared__ __align__(16) int s_prof[NW_SYMS * XL_WARPS * 32 * RW];
  const int tid = threadIdx.x;
  int k = 0;  // the warp's ticket
  if ((tid & 31) == 0) k = atomicAdd(queue, 1);
  k = __shfl_sync(NW_FULL, k, 0);
  if (k >= n_items) return;  // the whole warp
  const size_t p = items[2 * k];
  nw_strip_sweep<XL_R, NWD>(
      a_idx + p * M, b_idx + p * N, a_len[p], b_len[p], items[2 * k + 1],
      sub_t, gap_open, gap_ext, s_prof + tid * RW, XL_WARPS * 32 * RW,
      bnd + p * XL_PLANES(NWD) * ((size_t)N + 1), N + 1, progress + k,
      out_mt + p, out_ln + p);
}

// Words MT and LN travel in at padded widths M, N: one where both stay
// under 2^16 (LN <= M + N), else two.
extern "C" int nw_gotoh_xl_words(int M, int N) {
  return M + N < XL_PACK_LIMIT ? 1 : 2;
}

// DP rows a strip holds, the unit of the wrapper's table.
extern "C" int nw_gotoh_xl_strip_rows() { return 32 * XL_R; }

// The grid's blocks: a warp per item.
static int nw_gotoh_xl_blocks(int n_items) {
  return (n_items + XL_WARPS - 1) / XL_WARPS;
}

#ifdef __CUDACC__
// Launch on `stream`.  nwd: the words MT and LN travel in; 0 takes
// nw_gotoh_xl_words(M, N), and no fewer than that are allowed.  Returns the
// CUDA error of the attribute or of the launch (0 on success), -1 for
// another nwd.  The caller allocates the
// table, the boundary rows (XL_PLANES(2) * (N+1) * B ints), the zeroed
// counter and progress words, and the outputs.
extern "C" int nw_gotoh_xl_launch(const void* a_idx, const void* a_len,
                                  const void* b_idx, const void* b_len,
                                  const void* sub_t, int B, int M, int N,
                                  int gap_open, int gap_ext, int nwd,
                                  const void* items, int n_items, void* bnd,
                                  void* queue, void* progress, void* out_mt,
                                  void* out_ln, void* stream) {
  if (nwd == 0) nwd = nw_gotoh_xl_words(M, N);
  if (nwd < nw_gotoh_xl_words(M, N) || nwd > 2) return -1;
  if (B > 0) {
    auto* kernel = nwd == 1 ? nw_gotoh_xl_kernel<1> : nw_gotoh_xl_kernel<2>;
    // the profiles of the blocks an SM's registers admit need more shared
    // memory than the default carve-out always leaves
    cudaError_t rc = cudaFuncSetAttribute(
        kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
        cudaSharedmemCarveoutMaxShared);
    if (rc != cudaSuccess) return (int)rc;
    const int blocks = nw_gotoh_xl_blocks(n_items);
    if (blocks > 0) {
      kernel<<<blocks, XL_WARPS * 32, 0, (cudaStream_t)stream>>>(
          (const int*)a_idx, (const int*)a_len, (const int*)b_idx,
          (const int*)b_len, (const int*)sub_t, B, M, N, gap_open, gap_ext,
          (const int*)items, n_items, (int*)bnd, (int*)queue, (int*)progress,
          (int*)out_mt, (int*)out_ln);
    }
  }
  return (int)cudaGetLastError();
}
#endif
