// Toolchain probe for Hopper (sm_90a): out[i] = in[i] + 1 over n floats.
//
// Replaces the Pallas TPU kernel add_one of scripts/pallas_device_probe.py
// (stage 1 of that probe: a trivial kernel on an (8, 128) f32 array that shows
// the compiler, the loader and a launch work before anything larger is
// tried).  This one takes any length.
//
// Bound on an H100 SXM: 4 bytes read and 4 written per element at 3.35 TB/s,
// one add per element.  At the probe's shape (1,024 floats) that is 2.4 ns,
// far below the microsecond a launch costs, so there the kernel is bound by
// its launch whatever its design.  At lengths where the bytes count (2^26
// floats: 0.160 ms) what matters is how many bytes each SM keeps in flight.
// The first design (a grid-stride loop over 16 blocks of 256 threads an SM,
// one 16-byte load in flight a thread, 64-bit index arithmetic) ran 5 %
// behind PyTorch's own add: an SM holds 8 such blocks, so the grid ran in two
// waves, the second ragged.  Here each block owns a fixed run of kUnroll x
// 256 words of 16 bytes; each thread issues its kUnroll loads before the
// first store, with the streaming hints (nothing is read again), and indexes
// within its block's run in 32 bits.  Two loads a thread beat four on an H100
// (more, shorter blocks even out the last wave); more did not help.  A scalar head brings both pointers to a
// 16-byte boundary where they share one; where they do not (an input sliced
// one element in, say), a plain one-element-a-thread kernel runs instead.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 2;                        // 16-byte loads in flight a thread
constexpr int kRun = kThreads * kUnroll;          // 16-byte words a block

// out4[i] = in4[i] + 1 for the n4 words from in4, and the scalar head
// (the first `head` elements before in4) and tail (`tail` elements after it),
// whose loads block 0 issues beside its words'.
__global__ void __launch_bounds__(kThreads)
add_one_vec_kernel(const float* __restrict__ in, float* __restrict__ out, int head,
                   long long n4, int tail) {
  const float4* in4 = reinterpret_cast<const float4*>(in + head);
  float4* out4 = reinterpret_cast<float4*>(out + head);
  const long long base = (long long)blockIdx.x * kRun;
  const int left = (int)(n4 - base < kRun ? n4 - base : kRun);
  const int t = threadIdx.x;
  const bool edge = blockIdx.x == 0;
  const long long at = head + 4 * n4 + t;
  float first = 0.f, last = 0.f;
  if (edge && t < head) first = in[t];
  if (edge && t < tail) last = in[at];
  in4 += base;
  out4 += base;
  float4 v[kUnroll];
#pragma unroll
  for (int k = 0; k < kUnroll; ++k) {
    const int i = t + k * kThreads;
    if (i < left) v[k] = __ldcs(in4 + i);
  }
#pragma unroll
  for (int k = 0; k < kUnroll; ++k) {
    const int i = t + k * kThreads;
    if (i < left) {
      v[k].x += 1.0f;
      v[k].y += 1.0f;
      v[k].z += 1.0f;
      v[k].w += 1.0f;
      __stcs(out4 + i, v[k]);
    }
  }
  if (edge && t < head) out[t] = first + 1.0f;
  if (edge && t < tail) out[at] = last + 1.0f;
}

__global__ void __launch_bounds__(kThreads)
add_one_scalar_kernel(const float* __restrict__ in, float* __restrict__ out, long long n) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i < n) out[i] = in[i] + 1.0f;
}

}  // namespace

// Plain C entry point for ctypes.  Returns the cudaError_t of the launch
// (0 on success).
extern "C" int probe_add_one(const void* in, void* out, long long n,
                             void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* x = static_cast<const float*>(in);
  float* y = static_cast<float*>(out);
  const uintptr_t mis = (uintptr_t)x & 15;
  if (mis != ((uintptr_t)y & 15) || mis % 4) {
    const long long blocks = (n + kThreads - 1) / kThreads;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    add_one_scalar_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(x, y, n);
    return (int)cudaGetLastError();
  }
  const long long head_ll = mis ? (16 - (long long)mis) / 4 : 0;
  const int head = (int)(head_ll < n ? head_ll : n);
  const long long n4 = (n - head) / 4;
  const int tail = (int)(n - head - 4 * n4);
  const long long blocks = n4 ? (n4 + kRun - 1) / kRun : 1;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  add_one_vec_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(x, y, head, n4, tail);
  return (int)cudaGetLastError();
}
