"""A host harness that runs the port's CUDA sources as C++ on the CPU, and
its own checks.

Each block of a grid runs as real threads, one ``std::thread`` per CUDA
thread, blocks in turn.  Each thread has a ``thread_local`` ``threadIdx``;
``__syncthreads`` is a ``std::barrier`` of the block, ``__syncwarp`` one of
the warp, and ``__shfl_sync``/``__shfl_up_sync`` pass values through a
per-warp array between barrier waits (two arrays used in turn, so one wait
per shuffle suffices), within segments of ``width`` lanes as on the card.
Hopper's DPX intrinsics and ``__dp4a`` are defined from their documented
meaning; dynamic shared memory is a buffer that ``launch`` fills with a
pattern before each block, so that no block finds another's values.
``atomicAdd``, ``__threadfence``, ``__ldcg``, ``__nanosleep`` (a yield) and
the progress-word helpers of ``csrc/nw_cell.cuh`` (``nw_load_acquire``,
``nw_store_release``) are defined on ``std::atomic_ref`` and the C++ memory
model, so that warps of one block that wait on each other really run at
once; ``atomicAdd`` also logs which warp got which old value.  This checks
a kernel's arithmetic, its warp hand-offs and its waits here, where no
nvcc exists.  The kernel tests use it from ``tests/test_torch_nw.py``,
``tests/test_torch_xl.py`` and ``tests/test_torch_probe.py``.
"""

import ctypes
import subprocess

import numpy as np
import pytest

pytest.importorskip("torch")

from dynaalign_torch.ops import _build  # noqa: E402

HARNESS = r"""
#include <atomic>
#include <barrier>
#include <memory>
#include <mutex>
#include <thread>
#include <utility>
#include <vector>

#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __align__(n) __attribute__((aligned(n)))

struct alignas(8) int2 { int x, y; };
struct alignas(16) int4 { int x, y, z, w; };
struct Dim3 { unsigned x = 0, y = 0, z = 0; };
static thread_local Dim3 threadIdx;
static Dim3 blockIdx, blockDim;

namespace harness {
static std::barrier<>* block_bar;
static std::vector<std::unique_ptr<std::barrier<>>> warp_bar;
static std::vector<int> shfl_buf;  // [warp][2][32]
static thread_local int shfl_turn;
static std::mutex add_mu;
static std::vector<std::pair<int, int>> add_log;  // (old value, warp)
inline int warp() { return threadIdx.x / 32; }
inline int lane() { return threadIdx.x % 32; }

// Runs body() as `blocks` blocks of `threads` threads, blocks in turn.
// dyn: the blocks' dynamic shared memory, dyn_words ints, given a pattern
// that differs from block to block before each.
template <class F>
void launch(int blocks, int threads, F body, int* dyn = nullptr,
            size_t dyn_words = 0) {
  blockDim.x = threads;
  add_log.clear();
  for (int b = 0; b < blocks; ++b) {
    blockIdx.x = b;
    for (size_t k = 0; k < dyn_words; ++k) dyn[k] = 0x5a5a0000 + 977 * b;
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
inline int __shfl_sync(unsigned, int v, int src, int width = 32) {
  const int turn = harness::shfl_turn;
  int* buf = &harness::shfl_buf[(harness::warp() * 2 + turn) * 32];
  harness::shfl_turn ^= 1;
  const int l = harness::lane();
  buf[l] = v;
  harness::warp_bar[harness::warp()]->arrive_and_wait();
  return buf[(l & ~(width - 1)) | (src & (width - 1))];
}
inline int __shfl_up_sync(unsigned mask, int v, unsigned d, int width = 32) {
  const int pos = harness::lane() & (width - 1);  // lane of its segment
  return __shfl_sync(mask, v, pos >= (int)d ? pos - (int)d : pos, width);
}
// DPX, as NVIDIA documents the intrinsics: max(a + b, c); max(a, b) with
// *pred = (a >= b).  __dp4a: c plus the dot product of the four signed
// bytes of a and b.
inline int __viaddmax_s32(int a, int b, int c) {
  const int s = a + b;
  return s > c ? s : c;
}
inline int __vibmax_s32(int a, int b, bool* pred) {
  *pred = a >= b;
  return *pred ? a : b;
}
inline int __dp4a(int a, int b, int c) {
  for (int k = 0; k < 4; ++k)
    c += (int)(signed char)(a >> (8 * k)) * (int)(signed char)(b >> (8 * k));
  return c;
}
// Device-wide atomics and ordering: CUDA's atomicAdd is relaxed; a fence is
// a sequentially consistent fence; ld.acquire.gpu / st.release.gpu are
// acquire loads and release stores.  __ldcg is a plain load, so that a race
// stays a race for a thread sanitizer.
inline int atomicAdd(int* p, int v) {
  const int old = std::atomic_ref<int>(*p).fetch_add(
      v, std::memory_order_relaxed);
  std::lock_guard<std::mutex> hold(harness::add_mu);
  harness::add_log.emplace_back(
      old, (int)(blockIdx.x * (blockDim.x / 32)) + harness::warp());
  return old;
}
inline void __threadfence() {
  std::atomic_thread_fence(std::memory_order_seq_cst);
}
inline int __ldcg(const int* p) { return *p; }
inline void __nanosleep(unsigned) { std::this_thread::yield(); }
inline int nw_load_acquire(const int* p) {
  return std::atomic_ref<int>(*const_cast<int*>(p)).load(
      std::memory_order_acquire);
}
inline void nw_store_release(int* p, int v) {
  std::atomic_ref<int>(*p).store(v, std::memory_order_release);
}
// the atomicAdd log of the last launch: out[2i] = old value, out[2i + 1] =
// the warp (block * warps a block + warp); returns its length
extern "C" int harness_adds(int* out, int cap) {
  const int n = (int)harness::add_log.size();
  for (int i = 0; i < n && i < cap; ++i) {
    out[2 * i] = harness::add_log[i].first;
    out[2 * i + 1] = harness::add_log[i].second;
  }
  return n;
}
"""


def build_host(tmp_dir, name: str, shim: str,
               flags: tuple = ()) -> ctypes.CDLL:
    """Compile HARNESS + ``shim`` (which includes a csrc source) with g++
    and ``flags`` into a library under ``tmp_dir``.  -fno-gnu-unique: each
    library keeps its own statics of template functions (a kernel's
    __shared__ arrays), also beside a build of the same source with other
    sizes in one process."""
    src = tmp_dir / f"{name}.cpp"
    src.write_text(HARNESS + shim)
    so = tmp_dir / f"lib{name}.so"
    subprocess.run(
        ["g++", "-std=c++20", "-pthread", "-O2", "-shared", "-fPIC", "-Wall",
         "-Werror", "-Wno-unknown-pragmas", "-fno-gnu-unique", *flags, "-I",
         _build.CSRC, str(src), "-o", str(so)],
        check=True,
    )
    return ctypes.CDLL(str(so))


def atomic_log(lib) -> np.ndarray:
    """[n, 2] (old value, warp) of every atomicAdd of ``lib``'s last
    launch, in the order they ran."""
    fn = lib.harness_adds
    out = np.zeros(2 * fn(ptr(np.zeros(0, np.int32)), 0), np.int32)
    fn(ptr(out), out.size // 2)
    return out.reshape(-1, 2)


def ptr(x: np.ndarray):
    return x.ctypes.data_as(ctypes.c_void_p)


_SELF_SHIM = r"""
#define __shared__ static
extern int self_dyn[];
static int gridDim_x;
// width[w][g] = [shfl_up by 1, shfl from lane l ^ w, shfl from lane 5] within
// segments of 1 << w lanes
__global__ void width_kernel(int* out) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x, l = threadIdx.x & 31;
  const int n = gridDim_x * blockDim.x;
  for (int w = 0; w <= 5; ++w) {
    int* o = out + 3 * (w * n + g);
    o[0] = __shfl_up_sync(0xffffffffu, g, 1, 1 << w);
    o[1] = __shfl_sync(0xffffffffu, g, l ^ w, 1 << w);
    o[2] = __shfl_sync(0xffffffffu, g, 5, 1 << w);
  }
}
// out[g] = what thread g finds in its word of dynamic shared memory before
// it writes there, plus what its neighbour wrote, read after a barrier
__global__ void dyn_kernel(int* out) {
  const int t = threadIdx.x, g = blockIdx.x * blockDim.x + t;
  const int before = self_dyn[t];
  __syncthreads();
  self_dyn[t] = g;
  __syncthreads();
  out[2 * g] = before;
  out[2 * g + 1] = self_dyn[(t + 1) % blockDim.x];
}
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
extern "C" void width_run(int blocks, int threads, int* out) {
  gridDim_x = blocks;
  harness::launch(blocks, threads, [&] { width_kernel(out); });
}
int self_dyn[64];
extern "C" void dyn_run(int blocks, int* out) {
  harness::launch(blocks, 64, [&] { dyn_kernel(out); }, self_dyn, 64);
}
// Warp 0 writes data[0, n) and publishes it, warp 1 waits for that and
// reads it back into out: mode 0 through nw_store_release/nw_load_acquire,
// mode 1 through __threadfence and atomicAdd on the flag.  Then every
// thread of the block takes `tickets` tickets from *ticket.
__global__ void order_kernel(int* data, int* flag, int* out, int n, int mode,
                             int* ticket, int tickets) {
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
  if (w == 0) {
    for (int i = l; i < n; i += 32) data[i] = 1000 + 7 * i;
    __syncwarp();
    if (l == 0) {
      if (mode == 0) {
        nw_store_release(flag, 1);
      } else {
        __threadfence();
        atomicAdd(flag, 1);
      }
    }
  } else if (w == 1) {
    if (l == 0) {
      if (mode == 0) {
        while (nw_load_acquire(flag) < 1) __nanosleep(32);
      } else {
        while (atomicAdd(flag, 0) < 1) __nanosleep(32);
        __threadfence();
      }
    }
    __syncwarp();
    for (int i = l; i < n; i += 32) out[i] = __ldcg(data + i);
  }
  for (int t = 0; t < tickets; ++t) atomicAdd(ticket, 1);
}
extern "C" void order_run(int threads, int* data, int* flag, int* out, int n,
                          int mode, int* ticket, int tickets) {
  harness::launch(1, threads, [&] {
    order_kernel(data, flag, out, n, mode, ticket, tickets);
  });
}
extern "C" void dpx_run(int n, const int* a, const int* b, const int* c,
                        int* out) {
  for (int k = 0; k < n; ++k) {
    bool p;
    out[4 * k] = __viaddmax_s32(a[k], b[k], c[k]);
    out[4 * k + 1] = __vibmax_s32(a[k], b[k], &p);
    out[4 * k + 2] = p;
    out[4 * k + 3] = __dp4a(a[k], b[k], c[k]);
  }
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


def test_harness_width_shuffles(tmp_path):
    """With a width the shuffles stay inside segments of that many lanes:
    shfl_up keeps a segment's first lanes' own values, and a source lane
    is taken modulo the width, from the caller's own segment."""
    fn = build_host(tmp_path, "self", _SELF_SHIM).width_run
    fn.restype = None
    blocks, threads = 2, 64
    n = blocks * threads
    out = np.zeros((6, n, 3), np.int32)
    fn(blocks, threads, ptr(out))
    g = np.arange(n)
    lane = g % 32
    for w in range(6):
        width = 1 << w
        pos, seg = lane % width, g - lane % width
        np.testing.assert_array_equal(out[w, :, 0],
                                      np.where(pos >= 1, g - 1, g))
        np.testing.assert_array_equal(out[w, :, 1],
                                      seg + (lane ^ w) % width)
        np.testing.assert_array_equal(out[w, :, 2], seg + 5 % width)


def test_harness_dynamic_shared_memory(tmp_path):
    """A block starts on a pattern, not on what the block before it left,
    and sees its own threads' writes after a barrier."""
    fn = build_host(tmp_path, "self", _SELF_SHIM).dyn_run
    fn.restype = None
    blocks = 3
    out = np.zeros((blocks * 64, 2), np.int32)
    fn(blocks, ptr(out))
    g = np.arange(blocks * 64)
    np.testing.assert_array_equal(out[:, 0], 0x5A5A0000 + 977 * (g // 64))
    np.testing.assert_array_equal(out[:, 1], g - g % 64 + (g + 1) % 64)


def test_harness_dpx_and_dp4a(tmp_path):
    """The host definitions of the DPX intrinsics and __dp4a against numpy,
    ties and negative bytes included."""
    rng = np.random.default_rng(0)
    n = 4096
    a, b, c = (rng.integers(-2**29, 2**29, size=n).astype(np.int32)
               for _ in range(3))
    b[::3] = a[::3]  # ties
    c[::5] = (a[::5] + b[::5])
    out = np.zeros((n, 4), np.int32)
    fn = build_host(tmp_path, "self", _SELF_SHIM).dpx_run
    fn.restype = None
    fn(n, ptr(a), ptr(b), ptr(c), ptr(out))
    a64, b64, c64 = a.astype(np.int64), b.astype(np.int64), c.astype(np.int64)
    np.testing.assert_array_equal(out[:, 0], np.maximum(a64 + b64, c64))
    np.testing.assert_array_equal(out[:, 1], np.maximum(a, b))
    np.testing.assert_array_equal(out[:, 2], a >= b)
    dot = sum(a.view(np.int8)[k::4].astype(np.int64)
              * b.view(np.int8)[k::4].astype(np.int64) for k in range(4))
    np.testing.assert_array_equal(out[:, 3], c64 + dot)


ORDER_MODES = ["release/acquire", "threadfence/atomicAdd"]


@pytest.mark.parametrize("mode", ORDER_MODES)
def test_harness_orders_a_producer_warp_before_a_consumer_warp(tmp_path,
                                                               mode):
    """Warp 1 waits on warp 0's flag, then reads what warp 0 wrote before
    it: through the progress-word helpers of csrc/nw_cell.cuh, or through
    __threadfence and atomicAdd.  It never reads ahead of the producer
    (it would find the -1 fill)."""
    fn = build_host(tmp_path, "self", _SELF_SHIM).order_run
    fn.restype = None
    n = 4096
    for _ in range(3):
        data = np.full(n, -1, np.int32)
        out = np.full(n, -2, np.int32)
        flag, ticket = np.zeros(1, np.int32), np.zeros(1, np.int32)
        fn(64, ptr(data), ptr(flag), ptr(out), n, ORDER_MODES.index(mode),
           ptr(ticket), 0)
        np.testing.assert_array_equal(out, 1000 + 7 * np.arange(n))


def test_harness_atomic_add_hands_out_distinct_tickets(tmp_path):
    """128 threads of 4 warps draw 50 tickets each from one counter: every
    value once, and the log records 32 * 50 draws for each warp."""
    lib = build_host(tmp_path, "self", _SELF_SHIM)
    fn = lib.order_run
    fn.restype = None
    threads, tickets = 128, 50
    data, out = np.zeros(1, np.int32), np.zeros(1, np.int32)
    flag, ticket = np.zeros(1, np.int32), np.zeros(1, np.int32)
    fn(threads, ptr(data), ptr(flag), ptr(out), 0, 0, ptr(ticket), tickets)
    assert ticket[0] == threads * tickets
    log = atomic_log(lib)
    np.testing.assert_array_equal(np.sort(log[:, 0]),
                                  np.arange(threads * tickets))
    np.testing.assert_array_equal(np.bincount(log[:, 1]),
                                  [32 * tickets] * (threads // 32))
