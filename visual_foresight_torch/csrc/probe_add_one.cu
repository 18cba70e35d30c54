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
// floats: 0.160 ms) one element per thread fell short of PyTorch's own add,
// so each thread moves 16 bytes at a time (where both pointers allow) in a
// grid-stride loop over a grid that the card holds at once.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132 * 16;   // 16 blocks of 256 on each SM of an H100

__global__ void __launch_bounds__(kThreads)
add_one_kernel(const float* __restrict__ in, float* __restrict__ out, long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool aligned = (((uintptr_t)in | (uintptr_t)out) & 15) == 0;
  const long long n4 = aligned ? n / 4 : 0;
  const float4* in4 = reinterpret_cast<const float4*>(in);
  float4* out4 = reinterpret_cast<float4*>(out);
  for (long long i = first; i < n4; i += stride) {
    float4 v = in4[i];
    v.x += 1.0f;
    v.y += 1.0f;
    v.z += 1.0f;
    v.w += 1.0f;
    out4[i] = v;
  }
  for (long long i = 4 * n4 + first; i < n; i += stride) out[i] = in[i] + 1.0f;
}

}  // namespace

// Plain C entry point for ctypes.  Returns the cudaError_t of the launch
// (0 on success).
extern "C" int probe_add_one(const void* in, void* out, long long n,
                             void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  long long blocks = ((n + 3) / 4 + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  add_one_kernel<<<(unsigned)blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(in), static_cast<float*>(out), n);
  return (int)cudaGetLastError();
}
