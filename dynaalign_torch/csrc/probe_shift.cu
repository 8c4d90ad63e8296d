// Probe: what handing a row's value to the next row costs on this card.
//
// Replaces the Pallas TPU probe tools/probe_misalign.py::_kernel of the JAX
// package (:41, launched by run :66).  That probe asks whether the NW
// wavefront's ancestor shift (shifted[i] = x[i-1], a roll in the TPU
// kernels) is cheaper as a roll or as a load at an offset one row lower.
// On this card the question is the one csrc/nw_cell.cuh answers with a
// shuffle: a group of G lanes serves a pair, lane t holds R consecutive rows
// in registers, and only the row above a lane's first row crosses lanes.
// This kernel asks it in that layout.
//
// The state is the TPU probe's int32 plane [584, 256].  Step g takes the
// 336-row window at o = 16 + (g mod 8) * 16 of every column and stores
// a ^ b there:
//   base (kind 0): b = a;
//   shfl (kind 1): b = a rolled down one row with wrap (b[0] = a[335]);
//   mis  (kind 2): b = the window loaded at o - 1.
// The kernel returns the whole plane, so a test sees every value it wrote.
//
// Layout.  A step mixes rows of one column, never columns, so a column is a
// group of PROBE_G = 16 lanes and lane t owns window rows t * 21 .. t * 21 +
// 20 (336 = 16 * 21): a step loads them into registers, and inside a lane
// the shift is a register move.  Only row 0 of a lane crosses lanes:
//   shfl: one __shfl_sync from lane (t - 1) mod 16 of its group, which is
//         the shuffle up of nw_cell.cuh's hand-off and the wrap
//         (b[0] = a[335], lane 15's last row) in one instruction;
//   mis:  one shared-memory load of row o + 21 t - 1;
//   base: neither.
// So shfl - base and mis - base price one shuffle and one shifted load per
// lane per step: the choice nw_cell.cuh made.  16 lanes per column rather
// than 32: 336 rows split evenly, two columns fill a warp, and a lane holds
// 21 rows, as a lane of nw_gotoh (18) or nw_gotoh_xl (20) does, where 32
// lanes would hold 11 and leave the last two short.  A block is one warp
// holding two columns, 128 blocks cover the 256 columns.
//
// Shared memory.  A block keeps its two columns column-major (rows
// contiguous), 2,336 B of plane a column at a stride of PROBE_STRIDE = 592
// words.  Lane L = 16 c + t reads word c * 592 + o + 21 t + i; 592 = 16 and
// 21 * 16 = 16 (mod 32), so the word is 21 L + o + i (mod 32): 21 is odd,
// so the 32 lanes hit 32 banks for every i.  The launch asks for
// PROBE_SMEM_BYTES, more than half of an SM's 228 KB, so that no SM holds
// two blocks: the 128 blocks run at once on 128 of the 132 SMs (each
// reserves the rest of its shared memory and uses 4,736 B of it).
//
// Synchronisation.  A step's reads finish before its writes (lane t's
// shifted load reads lane t-1's row; the window moves 16 rows a step, so a
// step reads rows other lanes wrote): __syncwarp between reads and writes
// and after the writes, no block barrier.  The window is read through a
// volatile pointer, so no kind's load is folded away (base's a ^ a is 0
// whatever a is).  The loop runs 8 steps at the 8 window offsets, each
// offset a constant, then the n_steps mod 8 steps left, likewise.
//
// Bound: the step's shared-memory bytes (base: 336 * 256 * 4 read and as
// many written; mis: one more 4-byte load a lane; shfl: none) at 128 bytes
// per clock on each of the 128 SMs, 42 clocks a step; a step is a chain of
// loads, a shuffle or load, xors, stores and two __syncwarp on one warp of
// each SM, so its latency, not that rate, is the expected limit.

#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

#define PROBE_ROWS 584  // MP1 of the TPU probe
#define PROBE_COLS 256  // B of the TPU probe
#define PROBE_W 336     // window rows
#define PROBE_G 16      // lanes a column
#define PROBE_R (PROBE_W / PROBE_G)                // 21 window rows a lane
#define PROBE_THREADS 32                           // one warp a block
#define PROBE_BCOLS (PROBE_THREADS / PROBE_G)      // 2 columns a block
#define PROBE_BLOCKS (PROBE_COLS / PROBE_BCOLS)    // 128
#define PROBE_STRIDE 592  // words a column in shared memory, 16 mod 32
#define PROBE_SMEM_BYTES (120 * 1024)  // > 228 KB / 2: one block an SM
#define PROBE_FULL 0xffffffffu

extern __shared__ int probe_plane[];  // [PROBE_BCOLS][PROBE_STRIDE]

// One step at window offset o: this lane's 21 rows of its column, whose
// window row 0 is col[o].
template <int KIND>
__device__ __forceinline__ void probe_step(int* col, int t, int o) {
  // volatile: base's a ^ a is 0, and the loads must stay all the same
  const volatile int* w = col + o + PROBE_R * t;
  int a[PROBE_R];
#pragma unroll
  for (int i = 0; i < PROBE_R; ++i) a[i] = w[i];
  int b0 = a[0];
  if (KIND == 1) {
    b0 = __shfl_sync(PROBE_FULL, a[PROBE_R - 1], (t + PROBE_G - 1) % PROBE_G,
                     PROBE_G);
  } else if (KIND == 2) {
    b0 = w[-1];
  }
  __syncwarp();
  int* s = col + o + PROBE_R * t;
  s[0] = a[0] ^ b0;
#pragma unroll
  for (int i = 1; i < PROBE_R; ++i) s[i] = a[i] ^ (KIND == 0 ? a[i] : a[i - 1]);
  __syncwarp();
}

// seed, out: int32 [PROBE_ROWS, PROBE_COLS], row-major.
template <int KIND>
__global__ void __launch_bounds__(PROBE_THREADS) probe_shift_kernel(
    const int* __restrict__ seed, int* __restrict__ out, int n_steps) {
  const int c0 = blockIdx.x * PROBE_BCOLS;
  for (int q = threadIdx.x; q < PROBE_ROWS * PROBE_BCOLS; q += PROBE_THREADS) {
    const int r = q / PROBE_BCOLS, c = q % PROBE_BCOLS;
    probe_plane[c * PROBE_STRIDE + r] = seed[r * PROBE_COLS + c0 + c];
  }
  __syncwarp();
  const int t = threadIdx.x % PROBE_G;
  int* col = probe_plane + threadIdx.x / PROBE_G * PROBE_STRIDE;
  for (int g = 0; g < n_steps / 8; ++g) {
#pragma unroll
    for (int k = 0; k < 8; ++k) probe_step<KIND>(col, t, 16 + 16 * k);
  }
  const int rem = n_steps % 8;
#pragma unroll
  for (int k = 0; k < 7; ++k) {
    if (k < rem) probe_step<KIND>(col, t, 16 + 16 * k);
  }
  for (int q = threadIdx.x; q < PROBE_ROWS * PROBE_BCOLS; q += PROBE_THREADS) {
    const int r = q / PROBE_BCOLS, c = q % PROBE_BCOLS;
    out[r * PROBE_COLS + c0 + c] = probe_plane[c * PROBE_STRIDE + r];
  }
}

#ifdef __CUDACC__
template <int KIND>
static int probe_prepare() {
  return (int)cudaFuncSetAttribute(
      probe_shift_kernel<KIND>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      PROBE_SMEM_BYTES);
}

template <int KIND>
static int probe_launch(const void* seed, void* out, int n_steps,
                        cudaStream_t stream) {
  const int e = probe_prepare<KIND>();
  if (e != 0) return e;
  probe_shift_kernel<KIND>
      <<<PROBE_BLOCKS, PROBE_THREADS, PROBE_SMEM_BYTES, stream>>>(
          (const int*)seed, (int*)out, n_steps);
  return (int)cudaGetLastError();
}

// kind 0 base, 1 shfl, 2 mis.  Launch on `stream`; returns a CUDA error code
// (0 on success).  The caller allocates `out`.
extern "C" int probe_shift_launch(const void* seed, void* out, int kind,
                                  int n_steps, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (kind) {
    case 0: return probe_launch<0>(seed, out, n_steps, s);
    case 1: return probe_launch<1>(seed, out, n_steps, s);
    case 2: return probe_launch<2>(seed, out, n_steps, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The launch geometry of every kind on the current device: out[5 * kind ..]
// = blocks, threads a block, dynamic shared memory a block, the most blocks
// an SM holds at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor) and
// the device's SMs.  Returns a CUDA error code (0 on success).
extern "C" int probe_shift_geometry(int* out) {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (e != cudaSuccess) return (int)e;
  const void* kernels[3] = {(const void*)probe_shift_kernel<0>,
                            (const void*)probe_shift_kernel<1>,
                            (const void*)probe_shift_kernel<2>};
  const int prep[3] = {probe_prepare<0>(), probe_prepare<1>(),
                       probe_prepare<2>()};
  for (int kind = 0; kind < 3; ++kind) {
    if (prep[kind] != 0) return prep[kind];
    int per_sm = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernels[kind], PROBE_THREADS, PROBE_SMEM_BYTES);
    if (e != cudaSuccess) return (int)e;
    int* o = out + 5 * kind;
    o[0] = PROBE_BLOCKS;
    o[1] = PROBE_THREADS;
    o[2] = PROBE_SMEM_BYTES;
    o[3] = per_sm;
    o[4] = sms;
  }
  return 0;
}
#endif
