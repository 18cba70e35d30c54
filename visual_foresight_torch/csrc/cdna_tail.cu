// Fused CDNA warp-and-composite tail for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of visual_foresight_tpu/ops/pallas_cdna.py:
//   fused_warp_composite_eff (body _warp_kernel) and
//   fused_warp_composite_chw (body _warp_kernel_chw),
// and also folds in the mask x CDNA-kernel contraction that the TPU path left
// to XLA (visual_foresight_tpu/ops/cdna_warp.py effective_pixel_kernels), so
// the (B, H, W, K*K) effective-kernel field never reaches device memory.
//
// For every output pixel (b, h, w), with offset = 2 if SNA else 1:
//   eff[t]   = sum_m masks[b,h,w,offset+m] * kernels[b,t/K,t%K,m]      (t < K*K)
//   out_x[c] = x[b,h,w,c]*m0 (+ first_x[b,h,w,c]*m1 if SNA)
//            + sum_t eff[t] * x[b, h+t/K-K/2, w+t%K-K/2, c]   (zero outside)
// for x = the previous frame (C channels) and the pixel distributions (P
// channels, P may be 0).  Accumulation is in f32; outputs are written in the
// input dtype (f32 or bf16).  All tensors are contiguous NHWC; the CDNA
// kernels are (B, K, K, M).
//
// Design: one thread per output pixel, one block of 256 threads per (sample,
// tile of 256 consecutive pixels, i.e. four 64-wide rows).  The block stages
// its sample's K*K*M normalized kernel values in shared memory (1000 bytes at
// K=5, M=10); each thread forms its 25 effective weights from the M transform
// masks in registers and accumulates the taps over C+P channels.  Neighbour
// reads hit L1/L2: every input pixel is read by up to 25 threads of the same
// or a neighbouring block.
//
// Bound on an H100 SXM at the serving shapes (B=200, 48x64, C=3, P=1, K=5,
// M=10, SNA, bf16): the kernel must read prev, first (3.69 MB each), both
// distributions (1.23 MB each), the masks (14.75 MB) and the kernels
// (0.10 MB), and write the frame (3.69 MB) and the distribution (1.23 MB):
// 29.6 MB, or 8.8 us at 3.35 TB/s.  Its arithmetic is 614,400 pixels x
// (250 FMAs for the effective kernels + 100 for the taps + about 8 for the
// compositing) = 0.44 GFLOP of f32, or 6.6 us at 67 TFLOP/s.  So it is bound
// by bytes; the masks are half of them.
//
// Left for a later change: the kernel still reads the full-resolution masks
// that the softmax wrote.  Computing the softmax of the low-resolution mask
// logits inside this kernel would cut that read and the softmax's own
// write; staging the input tile with its halo in shared memory would turn the
// neighbour reads into shared-memory reads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxChannels = 4;   // C and P each at most 4
constexpr int kMaxMasks = 16;     // M at most 16

__device__ __forceinline__ float load(const float* p, long i) { return p[i]; }
__device__ __forceinline__ float load(const __nv_bfloat16* p, long i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store(float* p, long i, float v) { p[i] = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, long i, float v) {
  p[i] = __float2bfloat16(v);
}

template <typename T, int K>
__global__ void __launch_bounds__(kThreads)
cdna_tail_kernel(const T* __restrict__ prev, const T* __restrict__ first,
                 const T* __restrict__ prev_distrib,
                 const T* __restrict__ first_distrib,
                 const T* __restrict__ kernels, const T* __restrict__ masks,
                 T* __restrict__ out_img, T* __restrict__ out_distrib, int H,
                 int W, int C, int P, int M, int sna) {
  extern __shared__ float s_kernels[];  // [K*K][M] of this block's sample
  const int b = blockIdx.y;
  const int kk_m = K * K * M;
  const T* kb = kernels + (long)b * kk_m;
  for (int i = threadIdx.x; i < kk_m; i += blockDim.x) s_kernels[i] = load(kb, i);
  __syncthreads();

  const int pix = blockIdx.x * blockDim.x + threadIdx.x;
  if (pix >= H * W) return;
  const int h = pix / W;
  const int w = pix - h * W;
  const long sample = (long)b * H * W;
  const long here = sample + pix;
  const int offset = sna ? 2 : 1;
  const int n_masks = M + offset;

  const T* mrow = masks + here * n_masks;
  const float m0 = load(mrow, 0);
  const float m1 = sna ? load(mrow, 1) : 0.f;
  float mt[kMaxMasks];
#pragma unroll
  for (int m = 0; m < kMaxMasks; ++m) mt[m] = (m < M) ? load(mrow, offset + m) : 0.f;

  float acc_img[kMaxChannels];
  float acc_dst[kMaxChannels];
#pragma unroll
  for (int c = 0; c < kMaxChannels; ++c) {
    acc_img[c] = 0.f;
    acc_dst[c] = 0.f;
  }

#pragma unroll
  for (int i = 0; i < K; ++i) {
    const int hh = h + i - K / 2;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int ww = w + j - K / 2;
      const float* kt = s_kernels + (i * K + j) * M;
      float e = 0.f;
#pragma unroll
      for (int m = 0; m < kMaxMasks; ++m)
        if (m < M) e = fmaf(mt[m], kt[m], e);
      if (hh >= 0 && hh < H && ww >= 0 && ww < W) {
        const long q = sample + (long)hh * W + ww;
#pragma unroll
        for (int c = 0; c < kMaxChannels; ++c)
          if (c < C) acc_img[c] = fmaf(e, load(prev, q * C + c), acc_img[c]);
#pragma unroll
        for (int c = 0; c < kMaxChannels; ++c)
          if (c < P) acc_dst[c] = fmaf(e, load(prev_distrib, q * P + c), acc_dst[c]);
      }
    }
  }

#pragma unroll
  for (int c = 0; c < kMaxChannels; ++c) {
    if (c < C) {
      float v = load(prev, here * C + c) * m0 + acc_img[c];
      if (sna) v += load(first, here * C + c) * m1;
      store(out_img, here * C + c, v);
    }
  }
#pragma unroll
  for (int c = 0; c < kMaxChannels; ++c) {
    if (c < P) {
      float v = load(prev_distrib, here * P + c) * m0 + acc_dst[c];
      if (sna) v += load(first_distrib, here * P + c) * m1;
      store(out_distrib, here * P + c, v);
    }
  }
}

template <typename T, int K>
cudaError_t launch(const void* prev, const void* first, const void* prev_distrib,
                   const void* first_distrib, const void* kernels, const void* masks,
                   void* out_img, void* out_distrib, int B, int H, int W, int C,
                   int P, int M, int sna, cudaStream_t stream) {
  const dim3 grid((H * W + kThreads - 1) / kThreads, B);
  const size_t smem = sizeof(float) * K * K * M;
  cdna_tail_kernel<T, K><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(prev), static_cast<const T*>(first),
      static_cast<const T*>(prev_distrib), static_cast<const T*>(first_distrib),
      static_cast<const T*>(kernels), static_cast<const T*>(masks),
      static_cast<T*>(out_img), static_cast<T*>(out_distrib), H, W, C, P, M, sna);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_k(int K, const void* prev, const void* first,
                       const void* prev_distrib, const void* first_distrib,
                       const void* kernels, const void* masks, void* out_img,
                       void* out_distrib, int B, int H, int W, int C, int P, int M,
                       int sna, cudaStream_t stream) {
  switch (K) {
    case 3:
      return launch<T, 3>(prev, first, prev_distrib, first_distrib, kernels, masks,
                          out_img, out_distrib, B, H, W, C, P, M, sna, stream);
    case 5:
      return launch<T, 5>(prev, first, prev_distrib, first_distrib, kernels, masks,
                          out_img, out_distrib, B, H, W, C, P, M, sna, stream);
    case 7:
      return launch<T, 7>(prev, first, prev_distrib, first_distrib, kernels, masks,
                          out_img, out_distrib, B, H, W, C, P, M, sna, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point for ctypes.  dtype: 0 = float32, 1 = bfloat16.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int cdna_tail_forward(const void* prev, const void* first,
                                 const void* prev_distrib, const void* first_distrib,
                                 const void* kernels, const void* masks,
                                 void* out_img, void* out_distrib, int B, int H,
                                 int W, int C, int P, int K, int M, int sna,
                                 int dtype, void* stream) {
  if (B <= 0 || B > 65535 || H <= 0 || W <= 0 || C < 1 || C > kMaxChannels ||
      P < 0 || P > kMaxChannels || M < 1 || M > kMaxMasks)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch_k<float>(K, prev, first, prev_distrib, first_distrib,
                                  kernels, masks, out_img, out_distrib, B, H, W, C,
                                  P, M, sna, s);
  if (dtype == 1)
    return (int)dispatch_k<__nv_bfloat16>(K, prev, first, prev_distrib,
                                          first_distrib, kernels, masks, out_img,
                                          out_distrib, B, H, W, C, P, M, sna, s);
  return (int)cudaErrorInvalidValue;
}
