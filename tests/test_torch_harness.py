"""A host harness that runs the port's CUDA sources as C++ on the CPU, and
its own checks.

Each block of a grid runs as real threads, one ``std::thread`` per CUDA
thread, blocks in turn.  Each thread has a ``thread_local`` ``threadIdx``;
``__syncthreads`` is a ``std::barrier`` of the block, ``__syncwarp`` one of
the warp, and ``__shfl_sync``/``__shfl_up_sync`` pass values through a
per-warp array between barrier waits (two arrays used in turn, so one wait
per shuffle suffices).  This checks a kernel's arithmetic and its warp
hand-offs here, where no nvcc exists.  The kernel tests use it from
``tests/test_torch_xl.py`` and ``tests/test_torch_probe.py``.
"""

import ctypes
import subprocess

import numpy as np
import pytest

pytest.importorskip("torch")

from dynaalign_torch.ops import _build  # noqa: E402

HARNESS = r"""
#include <barrier>
#include <memory>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(x)

struct Dim3 { unsigned x = 0, y = 0, z = 0; };
static thread_local Dim3 threadIdx;
static Dim3 blockIdx, blockDim;

namespace harness {
static std::barrier<>* block_bar;
static std::vector<std::unique_ptr<std::barrier<>>> warp_bar;
static std::vector<int> shfl_buf;  // [warp][2][32]
static thread_local int shfl_turn;
inline int warp() { return threadIdx.x / 32; }
inline int lane() { return threadIdx.x % 32; }

// Runs body() as `blocks` blocks of `threads` threads, blocks in turn.
template <class F>
void launch(int blocks, int threads, F body) {
  blockDim.x = threads;
  for (int b = 0; b < blocks; ++b) {
    blockIdx.x = b;
    std::barrier<> bar(threads);
    block_bar = &bar;
    warp_bar.clear();
    for (int w = 0; w < threads / 32; ++w)
      warp_bar.push_back(std::make_unique<std::barrier<>>(32));
    shfl_buf.assign(threads / 32 * 64, 0);
    std::vector<std::thread> ts;
    for (int t = 0; t < threads; ++t)
      ts.emplace_back([t, &body] {
        threadIdx.x = t;
        shfl_turn = 0;
        body();
      });
    for (auto& t : ts) t.join();
  }
}
}  // namespace harness

inline void __syncthreads() { harness::block_bar->arrive_and_wait(); }
inline void __syncwarp(unsigned = 0xffffffffu) {
  harness::warp_bar[harness::warp()]->arrive_and_wait();
}
inline int __shfl_sync(unsigned, int v, int src) {
  const int turn = harness::shfl_turn;
  int* buf = &harness::shfl_buf[(harness::warp() * 2 + turn) * 32];
  harness::shfl_turn ^= 1;
  buf[harness::lane()] = v;
  harness::warp_bar[harness::warp()]->arrive_and_wait();
  return buf[src & 31];
}
inline int __shfl_up_sync(unsigned mask, int v, unsigned d) {
  const int l = harness::lane();
  return __shfl_sync(mask, v, l >= (int)d ? l - (int)d : l);
}
"""


def build_host(tmp_dir, name: str, shim: str) -> ctypes.CDLL:
    """Compile HARNESS + ``shim`` (which includes a csrc source) with g++
    into a library under ``tmp_dir``."""
    src = tmp_dir / f"{name}.cpp"
    src.write_text(HARNESS + shim)
    so = tmp_dir / f"lib{name}.so"
    subprocess.run(
        ["g++", "-std=c++20", "-pthread", "-O2", "-shared", "-fPIC", "-Wall",
         "-Werror", "-Wno-unknown-pragmas", "-I", _build.CSRC, str(src),
         "-o", str(so)],
        check=True,
    )
    return ctypes.CDLL(str(so))


def ptr(x: np.ndarray):
    return x.ctypes.data_as(ctypes.c_void_p)


_SELF_SHIM = r"""
#define __shared__ static
// out[b, t] = [shfl_up by 1, shfl_up by 3, shfl from lane 31 - l, block sum
// of thread ids read after a barrier]
__global__ void harness_kernel(int* out) {
  __shared__ int s[256];
  const int t = threadIdx.x, g = blockIdx.x * blockDim.x + t;
  s[t] = g;
  __syncthreads();
  int sum = 0;
  for (unsigned k = 0; k < blockDim.x; ++k) sum += s[k];
  const int l = t & 31;
  out[4 * g] = __shfl_up_sync(0xffffffffu, g, 1);
  out[4 * g + 1] = __shfl_up_sync(0xffffffffu, g, 3);
  __syncwarp();
  out[4 * g + 2] = __shfl_sync(0xffffffffu, g, 31 - l);
  out[4 * g + 3] = sum;
}
extern "C" void harness_run(int blocks, int threads, int* out) {
  harness::launch(blocks, threads, [&] { harness_kernel(out); });
}
"""


def test_harness_shuffles_and_barriers(tmp_path):
    """The emulated intrinsics behave as CUDA's: shfl_up keeps a lane's own
    value below the offset, shfl reads any lane, a block barrier orders
    shared-memory writes before reads."""
    fn = build_host(tmp_path, "self", _SELF_SHIM).harness_run
    fn.restype = None
    blocks, threads = 2, 96
    out = np.zeros((blocks * threads, 4), np.int32)
    fn(blocks, threads, ptr(out))
    g = np.arange(blocks * threads)
    lane = g % 32
    np.testing.assert_array_equal(out[:, 0], np.where(lane >= 1, g - 1, g))
    np.testing.assert_array_equal(out[:, 1], np.where(lane >= 3, g - 3, g))
    np.testing.assert_array_equal(out[:, 2], g - lane + 31 - lane)
    block = g // threads
    sums = np.array([np.arange(b * threads, (b + 1) * threads).sum()
                     for b in range(blocks)])
    np.testing.assert_array_equal(out[:, 3], sums[block])
