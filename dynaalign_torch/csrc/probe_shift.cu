// Probe: what handing a row's value to the next row costs on this card.
//
// Replaces the Pallas TPU probe tools/probe_misalign.py::_kernel of the JAX
// package (:41, launched by run :66).  That probe asks whether the NW
// wavefront's ancestor shift (shifted[i] = x[i-1], a roll in the TPU
// kernels) is cheaper as a roll or as a load at an offset one row lower.
// On this card the shift is either a register shuffle between the lanes
// that hold neighbouring rows (what nw_gotoh_xl.cu does) or a shared-memory
// load one row lower.  This kernel times the two against a step with no
// shift.
//
// The state is the TPU probe's int32 plane [584, 256], cut by columns into
// 8 blocks of [584, 32], each held in shared memory column-major (rows
// contiguous, so lanes on neighbouring rows hit neighbouring banks); 74,752
// bytes per block, past the 48 KB default, so the launch opts in.  Step g
// takes the 336-row window at o = 16 + (g mod 8) * 16 of every column and
// stores a ^ b there:
//   base (kind 0): b = a;
//   shfl (kind 1): b = a rolled down one row with wrap (b[0] = a[335]),
//                  through __shfl_up_sync, and through shared memory only at
//                  warp edges and at row 0 of the window;
//   mis  (kind 2): b = the window loaded at o - 1.
// All of a step's reads finish before its writes; the window is read
// through a volatile pointer, so no kind's load is folded away (base's
// a ^ a is 0 whatever a is).  The kernel returns the whole plane, so a
// test sees every value it wrote.
//
// Bound: the step's shared-memory bytes per block (base: 336 * 32 * 4 read
// and as many written; mis: one more read; shfl: base plus the edge loads)
// at 128 bytes per clock per SM, each block on its own SM.  Thread p holds
// row p mod 336 of columns p / 336 + 2e, e < 16, so 672 threads cover the
// window with whole warps.

#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

#define PROBE_ROWS 584  // MP1 of the TPU probe
#define PROBE_COLS 256  // B of the TPU probe
#define PROBE_W 336     // window rows
#define PROBE_BCOLS 32  // columns per block
#define PROBE_THREADS 672
#define PROBE_PER_THREAD (PROBE_W * PROBE_BCOLS / PROBE_THREADS)  // 16
#define PROBE_FULL 0xffffffffu

extern __shared__ int probe_plane[];  // [PROBE_BCOLS][PROBE_ROWS]

// seed, out: int32 [PROBE_ROWS, PROBE_COLS], row-major.
template <int KIND>
__global__ void __launch_bounds__(PROBE_THREADS) probe_shift_kernel(
    const int* __restrict__ seed, int* __restrict__ out, int n_steps) {
  int* st = probe_plane;
  const int c0 = blockIdx.x * PROBE_BCOLS;
  for (int q = threadIdx.x; q < PROBE_ROWS * PROBE_BCOLS; q += blockDim.x) {
    const int r = q / PROBE_BCOLS, c = q % PROBE_BCOLS;
    st[c * PROBE_ROWS + r] = seed[r * PROBE_COLS + c0 + c];
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int r = threadIdx.x % PROBE_W;  // this thread's window row
  const int cb = threadIdx.x / PROBE_W;  // its first column, 0 or 1
  for (int g = 0; g < n_steps; ++g) {
    const int o = 16 + (g % 8) * 16;
    int v[PROBE_PER_THREAD];
#pragma unroll
    for (int e = 0; e < PROBE_PER_THREAD; ++e) {
      // volatile: base's a ^ a is 0, and the load must stay all the same
      const volatile int* col = st + (cb + 2 * e) * PROBE_ROWS + o;
      const int a = col[r];
      int b = a;
      if (KIND == 1) {
        b = __shfl_up_sync(PROBE_FULL, a, 1);
        if (lane == 0 || r == 0) b = col[r == 0 ? PROBE_W - 1 : r - 1];
      } else if (KIND == 2) {
        b = col[r - 1];
      }
      v[e] = a ^ b;
    }
    __syncthreads();
#pragma unroll
    for (int e = 0; e < PROBE_PER_THREAD; ++e) {
      st[(cb + 2 * e) * PROBE_ROWS + o + r] = v[e];
    }
    __syncthreads();
  }
  for (int q = threadIdx.x; q < PROBE_ROWS * PROBE_BCOLS; q += blockDim.x) {
    const int r = q / PROBE_BCOLS, c = q % PROBE_BCOLS;
    out[r * PROBE_COLS + c0 + c] = st[c * PROBE_ROWS + r];
  }
}

#ifdef __CUDACC__
template <int KIND>
static int probe_launch(const void* seed, void* out, int n_steps,
                        cudaStream_t stream) {
  const int smem = PROBE_BCOLS * PROBE_ROWS * (int)sizeof(int);
  cudaError_t e = cudaFuncSetAttribute(
      probe_shift_kernel<KIND>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return (int)e;
  probe_shift_kernel<KIND>
      <<<PROBE_COLS / PROBE_BCOLS, PROBE_THREADS, smem, stream>>>(
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
#endif
