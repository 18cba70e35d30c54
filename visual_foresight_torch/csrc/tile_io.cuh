// Staging of tiles between device memory and shared memory on Hopper
// (sm_90a), shared by the CDNA tail's forward (cdna_tail.cu) and backward
// (cdna_tail_bwd.cu) kernels: 16-byte cp.async copies, bulk copies by the
// copy engine (cp.async.bulk) completing on an mbarrier, bulk stores, and
// the geometry of an NHWC window, and the host side's per-device opt-in to
// more than 48 KB of shared memory.  Each kernel source is its own library,
// so the helpers sit in an unnamed namespace of each.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <mutex>
#include <type_traits>

namespace {

// Opting a kernel into more than 48 KB of dynamic shared memory
// (cudaFuncSetAttribute) is a setting of the current device's context, not
// of the process: a launch on a second card needs its own.  One SmemOptIn a
// kernel instantiation (a function-local static) records, for each device,
// the largest size set there; the lock keeps two host threads from setting
// a smaller size over a larger one, and a failed setting is returned.
class SmemOptIn {
 public:
  template <typename Kernel>
  cudaError_t ensure(Kernel* kernel, size_t bytes) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
    if (allowed_[dev].load(std::memory_order_acquire) >= bytes) return cudaSuccess;
    std::lock_guard<std::mutex> lock(mutex_);
    if (allowed_[dev].load(std::memory_order_relaxed) >= bytes) return cudaSuccess;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
    allowed_[dev].store(bytes, std::memory_order_release);
    return cudaSuccess;
  }

 private:
  static constexpr int kMaxDevices = 64;
  std::atomic<size_t> allowed_[kMaxDevices] = {};
  std::mutex mutex_;
};

// floor(x / d) for 0 <= x < 2^22 and 0 < d < 2^11, given inv = 1.f / d: the
// quotient of x + 0.5 is at least 0.5 / d away from an integer, more than
// the rounding of the two float operations.
__device__ __forceinline__ int fast_div(int x, float inv) {
  return (int)(((float)x + 0.5f) * inv);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   (unsigned)__cvta_generic_to_shared(smem)),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;" ::: "memory");
}

// One thread hands a whole span to the copy engine (TMA bulk copy); the
// loads report to an mbarrier that every thread then waits on.
__device__ __forceinline__ unsigned shared_address(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbarrier_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
               "fence.mbarrier_init.release.cluster;" ::"r"(shared_address(bar))
               : "memory");
}
__device__ __forceinline__ void mbarrier_expect(unsigned long long* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   shared_address(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbarrier_wait(unsigned long long* bar) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], 0;\n"
      "@p bra DONE;\nbra WAIT;\nDONE:\n}" ::"r"(shared_address(bar))
      : "memory");
}
__device__ __forceinline__ void bulk_load(void* smem, const void* gmem, unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(shared_address(smem)),
      "l"(gmem), "r"(bytes), "r"(shared_address(bar))
      : "memory");
}
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}
__device__ __forceinline__ void bulk_store(void* gmem, const void* smem, unsigned bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(gmem),
               "r"(shared_address(smem)), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void bulk_store_wait() {
  asm volatile("cp.async.bulk.commit_group;\ncp.async.bulk.wait_group.read 0;" ::: "memory");
}

// Runs of elements in global memory and their place in shared memory.
template <typename T>
struct SpanT {
  T* g;
  std::remove_const_t<T>* s;
  int rows, len;
  // one run of whole 16-byte words (or nothing), as a bulk copy takes it
  __device__ __forceinline__ bool whole_words() const {
    return len == 0 ||
           (rows == 1 && (uintptr_t)g % 16 == 0 && (len * sizeof(T)) % 16 == 0);
  }
};

// Copies `rows` runs of `len` elements from global memory (run i at
// g + i * g_stride) into shared memory (run i at s + i * s_pitch) as they
// are, by the NT threads of the block: 16 bytes per thread with cp.async
// where the runs start on 16-byte boundaries, the rest of each run (or all
// of it) element by element.  s and s_pitch are multiples of 16 bytes.
template <int NT, typename T>
__device__ __forceinline__ void copy_in(const T* __restrict__ g, int rows, long g_stride,
                                        int len, T* __restrict__ s, int s_pitch) {
  constexpr int V = 16 / sizeof(T);
  const bool vec_ok = (uintptr_t)g % 16 == 0 &&
                      (rows == 1 || (g_stride * sizeof(T)) % 16 == 0);
  const int nvec = vec_ok ? len / V : 0;
  const float inv_nvec = 1.f / (float)max(nvec, 1);
  for (int idx = threadIdx.x; idx < rows * nvec; idx += NT) {
    const int run = rows > 1 ? fast_div(idx, inv_nvec) : 0;
    const int e = (idx - run * nvec) * V;
    cp_async16(s + run * s_pitch + e, g + run * g_stride + e);
  }
  const int done = nvec * V, rest = len - done;
  for (int idx = threadIdx.x; idx < rows * rest; idx += NT) {
    const int run = idx / rest;
    const int e = done + idx - run * rest;
    s[run * s_pitch + e] = g[run * g_stride + e];
  }
}

// The reverse of copy_in: 16-byte stores where the runs start
// on 16-byte boundaries.
template <int NT, typename T>
__device__ __forceinline__ void copy_out(T* __restrict__ g, int rows, long g_stride,
                                         int len, const T* __restrict__ s, int s_pitch) {
  constexpr int V = 16 / sizeof(T);
  const bool vec_ok = (uintptr_t)g % 16 == 0 &&
                      (rows == 1 || (g_stride * sizeof(T)) % 16 == 0);
  const int nvec = vec_ok ? len / V : 0;
  const float inv_nvec = 1.f / (float)max(nvec, 1);
  for (int idx = threadIdx.x; idx < rows * nvec; idx += NT) {
    const int run = rows > 1 ? fast_div(idx, inv_nvec) : 0;
    const int e = (idx - run * nvec) * V;
    *reinterpret_cast<uint4*>(g + run * g_stride + e) =
        *reinterpret_cast<const uint4*>(s + run * s_pitch + e);
  }
  const int done = nvec * V, rest = len - done;
  for (int idx = threadIdx.x; idx < rows * rest; idx += NT) {
    const int run = idx / rest;
    const int e = done + idx - run * rest;
    g[run * g_stride + e] = s[run * s_pitch + e];
  }
}

template <typename T>
__device__ __forceinline__ int round_up_vec(int n) {
  constexpr int V = 16 / sizeof(T);
  return (n + V - 1) / V * V;
}

// A window of an NHWC tensor of `nch` channels: rows [r_lo, r_hi), columns
// [c_lo, c_hi) of sample b.  Of full width it is one contiguous run, else
// one run per row.  In shared memory element (row, col, ch), counted from
// the window's corner, sits at row * stride + col * nch + ch.
struct Window {
  long origin;      // first element in the tensor
  int rows, len;    // runs and elements per run
  long g_stride;    // between runs in the tensor
  int stride;       // between rows in shared memory
  int size;         // elements taken in shared memory
};

template <typename T>
__device__ __forceinline__ Window make_window(int b, int H, int W, int nch, int r_lo,
                                              int r_hi, int c_lo, int c_hi) {
  Window win;
  win.origin = (((long)b * H + r_lo) * W + c_lo) * nch;
  if (c_lo == 0 && c_hi == W) {
    win.rows = 1;
    win.len = (r_hi - r_lo) * W * nch;
    win.g_stride = 0;
    win.stride = W * nch;
    win.size = round_up_vec<T>(win.len);
  } else {
    win.rows = r_hi - r_lo;
    win.len = (c_hi - c_lo) * nch;
    win.g_stride = (long)W * nch;
    win.stride = round_up_vec<T>(win.len);
    win.size = win.rows * win.stride;
  }
  return win;
}

}  // namespace
