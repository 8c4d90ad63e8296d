// MinHash top-k neighbour lists: for each row of a signature block, its k
// columns with the most agreeing signature slots, the row itself left out,
// equal counts lowest column first.
//
// Replaces no TPU kernel: the JAX package computes the top-k as plain
// jax.jit code (ops/topk_graph.py::_topk_kernel), and the port's plain
// version, ops/topk_graph.py::_topk_block, materialises a [rows, N, H]
// boolean compare, its int32 copy and sum, and a [rows, N] int64 key for
// torch.topk: three passes over device memory for every row block.  This
// kernel compares, counts and selects in one pass, with nothing of shape
// [rows, N] in device memory.
//
// Bound on this card: integer operations.  Every ordered pair (row, column)
// compares H slots at one compare and one add a slot on the SMs' 64 integer
// ALU lanes; the signatures, N * H * 4 bytes (20 MB at N = 100,000, H =
// 50), are read from L2 (50 MB) by every block and from device memory
// about once.
//
// Design:
// * A block owns MH_RT rows (their signatures resident in shared memory,
//   transposed to [h][row]) and streams every column through a two-stage
//   ring of [h][column] tiles of MH_TC columns and up to MH_HC_MAX slots,
//   loaded with cp.async: the next stage lands while this one is counted.
// * Counting: thread (ty, tx) of 16 x 16 owns rows 4ty..4ty+3 and columns
//   4tx..4tx+3 and 64+4tx..64+4tx+3 of the tile: per slot three 16-byte
//   shared loads and 32 compare-and-adds into registers.
// * Selection, exact: a column's key is (count << 24) | (0xFFFFFF - col),
//   so keys are distinct and a larger key is the better neighbour (count
//   descending, column ascending).  Each row keeps in shared memory a
//   buffer of keys and a threshold, the smallest key it keeps; after each
//   column tile only keys above the threshold are appended.  Where a
//   row's buffer holds more than k keys, one warp ranks them (rank = keys
//   above it; keys are distinct), keeps the k best in order and raises the
//   threshold to the k-th.  The threshold is the k-th best of a subset of
//   the columns, so no column of the true top k is ever dropped; columns
//   arrive in ascending order tile by tile, so one at the threshold's
//   count comes after every kept one of that count and rightly loses.
// * At the end one warp a row ranks its last buffer and writes the k keys
//   as counts and columns in rank order.  A row with fewer than k other
//   columns (N = 1, k = 1) gets count -1 at its own index in the slots
//   left, as the plain version's masked self.
// * Limits: n_hash <= MH_HMAX (a count fits the key's 8 bits), k <=
//   MH_KMAX (the buffer and the rank arrays), N <= MH_NMAX (a column fits
//   24 bits; key 0 stays free).  ops/topk_cuda.py reads them from here.

#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

#include <stddef.h>

#define MH_THREADS 256
#define MH_WARPS (MH_THREADS / 32)
#define MH_RT 64          // rows a block
#define MH_TC 128         // columns a tile
#define MH_SR (MH_RT + 4)  // shared stride of a slot's rows
#define MH_SC (MH_TC + 4)  // shared stride of a slot's columns
#define MH_HC_MAX 64      // slots a stage of the ring, at most
#define MH_KMAX 256
#define MH_HMAX 255
#define MH_NMAX 16777215
#define MH_SMEM_MAX 232448  // 227 KB, a block's most on this card
// keys a lane ranks: a buffer holds at most MH_KMAX + MH_TC
#define MH_PER ((MH_KMAX + MH_TC) / 32)

extern __shared__ __align__(16) int mh_dyn[];

__device__ __forceinline__ int mh_min(int a, int b) { return a < b ? a : b; }

__device__ __forceinline__ int4 mh_ld4(const int* p) {
#ifdef __CUDACC__
  return *reinterpret_cast<const int4*>(p);
#else
  return int4{p[0], p[1], p[2], p[3]};
#endif
}

// a 4-byte copy from global to shared memory, asynchronous on the card
__device__ __forceinline__ void mh_copy4(int* dst, const int* src) {
#ifdef __CUDACC__
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
#else
  *dst = *src;
#endif
}

__device__ __forceinline__ void mh_commit() {
#ifdef __CUDACC__
  asm volatile("cp.async.commit_group;\n" ::);
#endif
}

// wait until at most N committed groups of this thread are in flight
template <int N>
__device__ __forceinline__ void mh_wait() {
#ifdef __CUDACC__
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
#endif
}

// Words of dynamic shared memory for n_hash H, stage slots hc and k.
static inline size_t mh_smem_words(int H, int hc, int k) {
  return (size_t)H * MH_SR + 2 * (size_t)hc * MH_SC +
         (size_t)MH_RT * (k + MH_TC) + 2 * MH_RT;
}

// Stage (tile t, slots h0 .. h0 + hn) of the columns into dst[h][col];
// columns past N repeat column N - 1, which the selection skips.
__device__ __forceinline__ void mh_load_stage(const int* __restrict__ sig,
                                              int N, int H, int t, int h0,
                                              int hn, int* dst) {
  const int col0 = t * MH_TC, total = MH_TC * hn;
  const int q = MH_THREADS / hn, r = MH_THREADS - q * hn;
  int cl = threadIdx.x / hn, h = threadIdx.x - cl * hn;
  for (int e = threadIdx.x; e < total; e += MH_THREADS) {
    const int col = mh_min(col0 + cl, N - 1);
    mh_copy4(dst + h * MH_SC + cl, sig + (size_t)col * H + h0 + h);
    cl += q;
    h += r;
    if (h >= hn) {
      h -= hn;
      ++cl;
    }
  }
  mh_commit();
}

// Ranks of the f distinct keys buf[0..f): rank[j] of key lane + 32 j is the
// number of keys above it.  Lanes past f hold key 0.
__device__ __forceinline__ void mh_rank(const unsigned* buf, int f,
                                        unsigned (&key)[MH_PER],
                                        int (&rank)[MH_PER], int lane) {
#pragma unroll
  for (int j = 0; j < MH_PER; ++j) {
    const int i = lane + 32 * j;
    key[j] = i < f ? buf[i] : 0u;
    rank[j] = 0;
  }
  for (int i = 0; i < f; ++i) {
    const unsigned o = buf[i];
#pragma unroll
    for (int j = 0; j < MH_PER; ++j) rank[j] += o > key[j];
  }
}

// sig [N, H] int32 signatures; rows start..stop; out_cnt, out_idx
// [stop - start, k] int32.  Dynamic shared memory: mh_smem_words(H, hc, k).
__global__ void __launch_bounds__(MH_THREADS, 2)
minhash_topk_kernel(const int* __restrict__ sig, int N, int H, int start,
                    int stop, int k, int hc, int* __restrict__ out_cnt,
                    int* __restrict__ out_idx) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tx = tid & 15, ty = tid >> 4;
  const int row0 = start + (int)blockIdx.x * MH_RT;
  const int rows = mh_min(MH_RT, stop - row0);
  const int cap = k + MH_TC;
  int* s_row = mh_dyn;
  int* s_col = s_row + H * MH_SR;
  unsigned* buf = (unsigned*)(s_col + 2 * hc * MH_SC);
  int* fill = (int*)(buf + MH_RT * cap);
  unsigned* thr = (unsigned*)(fill + MH_RT);

  const int chunks = (H + hc - 1) / hc;
  const int stages = (N + MH_TC - 1) / MH_TC * chunks;
  mh_load_stage(sig, N, H, 0, 0, mh_min(hc, H), s_col);
  for (int e = tid; e < MH_RT * H; e += MH_THREADS) {
    const int r = e / H, h = e - r * H;
    s_row[h * MH_SR + r] = sig[(size_t)(row0 + mh_min(r, rows - 1)) * H + h];
  }
  for (int r = tid; r < MH_RT; r += MH_THREADS) {
    fill[r] = 0;
    thr[r] = 0u;  // below every key: all pass until the buffer first fills
  }

  int acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[i][c] = 0;

  for (int s = 0; s < stages; ++s) {
    const int t = s / chunks, h0 = (s - t * chunks) * hc;
    const int hn = mh_min(hc, H - h0);
    if (s + 1 < stages) {
      const int t1 = (s + 1) / chunks, h1 = (s + 1 - t1 * chunks) * hc;
      mh_load_stage(sig, N, H, t1, h1, mh_min(hc, H - h1),
                    s_col + ((s + 1) & 1) * hc * MH_SC);
      mh_wait<1>();
    } else {
      mh_wait<0>();
    }
    __syncthreads();
    const int* cb = s_col + (s & 1) * hc * MH_SC + 4 * tx;
    const int* rb = s_row + h0 * MH_SR + 4 * ty;
#pragma unroll 2
    for (int h = 0; h < hn; ++h) {
      const int4 a = mh_ld4(rb + h * MH_SR);
      const int4 b0 = mh_ld4(cb + h * MH_SC);
      const int4 b1 = mh_ld4(cb + h * MH_SC + 64);
      const int av[4] = {a.x, a.y, a.z, a.w};
      const int bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[i][c] += av[i] == bv[c];
    }
    if (h0 + hn == H) {  // the tile's last slots: select
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int lr = 4 * ty + i;
        const unsigned th = lr < rows ? thr[lr] : 0xFFFFFFFFu;
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const int col = t * MH_TC + 4 * tx + (c & 3) + (c >> 2) * 64;
          const unsigned key =
              ((unsigned)acc[i][c] << 24) | (0xFFFFFFu - (unsigned)col);
          acc[i][c] = 0;
          if (key > th && col < N && col != row0 + lr) {
            buf[lr * cap + atomicAdd(&fill[lr], 1)] = key;
          }
        }
      }
      __syncthreads();
      for (int lr = warp; lr < rows; lr += MH_WARPS) {
        const int f = fill[lr];
        if (f <= k) continue;  // uniform in the warp
        unsigned* b = buf + lr * cap;
        unsigned key[MH_PER];
        int rank[MH_PER];
        mh_rank(b, f, key, rank, lane);
        __syncwarp();
#pragma unroll
        for (int j = 0; j < MH_PER; ++j) {
          if (lane + 32 * j < f && rank[j] < k) b[rank[j]] = key[j];
        }
        __syncwarp();
        if (lane == 0) {
          fill[lr] = k;
          thr[lr] = b[k - 1];
        }
      }
    }
    __syncthreads();  // the stage is read: the ring may refill it
  }

  for (int lr = warp; lr < rows; lr += MH_WARPS) {
    const int f = fill[lr];
    unsigned key[MH_PER];
    int rank[MH_PER];
    mh_rank(buf + lr * cap, f, key, rank, lane);
    const size_t o = (size_t)(row0 - start + lr) * k;
#pragma unroll
    for (int j = 0; j < MH_PER; ++j) {
      if (lane + 32 * j < f && rank[j] < k) {
        out_cnt[o + rank[j]] = (int)(key[j] >> 24);
        out_idx[o + rank[j]] = (int)(0xFFFFFFu - (key[j] & 0xFFFFFFu));
      }
    }
    for (int j = f + lane; j < k; j += 32) {  // fewer than k other columns
      out_cnt[o + j] = -1;
      out_idx[o + j] = row0 + lr;
    }
  }
}

// The slots a stage of the ring holds for n_hash H and k: all of them up to
// MH_HC_MAX, halved until the block's shared memory fits MH_SMEM_MAX.
static inline int mh_stage_slots(int H, int k) {
  int hc = H < MH_HC_MAX ? H : MH_HC_MAX;
  while (hc > 1 && mh_smem_words(H, hc, k) * sizeof(int) > MH_SMEM_MAX) {
    hc = (hc + 1) / 2;
  }
  return hc;
}

#ifdef __CUDACC__
// Top-k lists of rows start..stop of sig [N, H] (int32, on the card) into
// out_cnt and out_idx [stop - start, k] (int32, allocated by the caller), on
// `stream`.  Returns the CUDA error of the attribute call or the launch (0
// on success), or cudaErrorInvalidValue for arguments past the limits.
extern "C" int minhash_topk_launch(const void* sig, int N, int H, int start,
                                   int stop, int k, void* out_cnt,
                                   void* out_idx, void* stream) {
  if (H < 1 || H > MH_HMAX || k < 1 || k > MH_KMAX || k > N || N > MH_NMAX ||
      start < 0 || start > stop || stop > N) {
    return (int)cudaErrorInvalidValue;
  }
  if (start == stop) return (int)cudaGetLastError();
  const int hc = mh_stage_slots(H, k);
  const size_t smem = sizeof(int) * mh_smem_words(H, hc, k);
  cudaError_t rc = cudaFuncSetAttribute(
      minhash_topk_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
      cudaSharedmemCarveoutMaxShared);
  if (rc == cudaSuccess) {
    rc = cudaFuncSetAttribute(minhash_topk_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
  }
  if (rc != cudaSuccess) return (int)rc;
  const int blocks = (stop - start + MH_RT - 1) / MH_RT;
  minhash_topk_kernel<<<blocks, MH_THREADS, smem, (cudaStream_t)stream>>>(
      (const int*)sig, N, H, start, stop, k, hc, (int*)out_cnt,
      (int*)out_idx);
  return (int)cudaGetLastError();
}
#endif
