// Toolchain probe for Hopper (sm_90a): out[i] = in[i] + 1 over n floats.
//
// Replaces the Pallas TPU kernel add_one of scripts/pallas_device_probe.py
// (stage 1 of that probe: a trivial kernel on an (8, 128) f32 array that shows
// the compiler, the loader and a launch work before anything larger is
// tried).  This one takes any length.
//
// Bound on an H100 SXM at the probe's shape (1,024 floats): 4 KiB read and
// 4 KiB written, 2.4 ns at 3.35 TB/s, and 1,024 adds.  A launch costs
// microseconds, so the kernel is bound by its launch by design; one thread per
// element, 256-thread blocks.

#include <cuda_runtime.h>

namespace {

__global__ void add_one_kernel(const float* __restrict__ in,
                               float* __restrict__ out, long long n) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = in[i] + 1.0f;
}

}  // namespace

// Plain C entry point for ctypes.  Returns the cudaError_t of the launch
// (0 on success).
extern "C" int probe_add_one(const void* in, void* out, long long n,
                             void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  add_one_kernel<<<(unsigned)blocks, threads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(in), static_cast<float*>(out), n);
  return (int)cudaGetLastError();
}
