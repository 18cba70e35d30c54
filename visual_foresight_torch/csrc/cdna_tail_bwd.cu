// Backward of the fused CDNA warp-and-composite tail (the folded entry of
// cdna_tail.cu) for Hopper (sm_90a), for training.
//
// No TPU kernel is replaced: the JAX package differentiates its XLA tail
// (visual_foresight_tpu/ops/cdna_warp.py effective_pixel_kernels + dna_warp,
// composited in models/cdna.py) and has no Pallas backward.  The port's tail
// is its forward kernel on every path, so its gradient is this kernel.
//
// The forward, for P = 0 (no distribution channels), per sample:
//   eff[p, t] = sum_k masks[p, off+k] * kern[t, k]          (off = 2 if SNA else 1)
//   out[p, c] = prev[p, c]*m0[p] (+ first[p, c]*m1[p]) + sum_t eff[p, t] * prev[p+d(t), c]
// with tap t = i*K + j at offset d(t) = (i - K/2, j - K/2), zero outside the
// image.  Given g = dL/dout, the backward is
//   g_eff[p, t]      = sum_c g[p, c] * prev[p+d(t), c]
//   g_masks[p, off+k] = sum_t g_eff[p, t] * kern[t, k]
//   g_masks[p, 0]    = sum_c g[p, c] * prev[p, c];  g_masks[p, 1] = sum_c g * first  (SNA)
//   g_first[p, c]    = m1[p] * g[p, c]                        (zero without SNA)
//   g_kern[t, k]     = sum_p masks[p, off+k] * g_eff[p, t]    (over all H*W pixels)
//   g_prev[q, c]     = m0[q]*g[q, c] + sum_t eff[q-d(t), t] * g[q-d(t), c]
// The last is the transposed correlation in gather form: each pixel makes
// the one field value it needs at each of its K*K neighbours again from the
// neighbour's masks (M products), so no field is written to device memory.
//
// Two grid passes, launched by one call:
//   1. cdna_tail_bwd_pixel_kernel: one thread a pixel, 128 pixels a block of
//      one sample.  It writes g_masks (in the masks' own layout, full
//      resolution or blocked), g_first and g_prev, and the block's partial
//      sum of g_kern (its 128 pixels) to a scratch buffer in f32;
//   2. cdna_tail_bwd_kern_reduce: sums each sample's partials over the
//      blocks in a fixed order.  No float atomics, so two runs give the same
//      bits.
// Accumulation is in f32; each gradient is written in its input's dtype
// (f32 or bf16).  A null output pointer skips that gradient.
//
// Bound on an H100 SXM (48x64, C=3, K=5, M=10, SNA, bf16, blocked masks),
// per sample: it reads g, prev and first (18,432 bytes each), the masks
// (73,728) and the kernels (500), and writes g_prev, g_first (18,432 each),
// g_masks (73,728) and g_kern (500): about 240 KB, so 3.9 MB at B=16.  Its
// arithmetic is about 900 FMAs a pixel (75 for g_eff, 250 for g_masks, 250
// for g_kern, 250 + 75 for the field made again and g_prev): 1.8 kFLOP a
// pixel, 88 MFLOP at B=16, 1.3 us at 67 TFLOP/s of f32 against 1.2 us for
// the bytes.  This first version is simple rather than fast: one pixel a
// thread, every neighbour read from global memory through the cache.  Its
// redesign (tiles staged in shared memory, as the forward's tiled variant)
// is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxChannels = 4;   // C at most 4
constexpr int kMaxMasks = 16;     // M at most 16
constexpr int kPixels = 128;      // pixels (threads) a block of pass 1

__device__ __forceinline__ float load(const float* p, long i) { return p[i]; }
__device__ __forceinline__ float load(const __nv_bfloat16* p, long i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store(float* p, long i, float v) { p[i] = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, long i, float v) {
  p[i] = __float2bfloat16(v);
}

// Index of mask 0 of pixel (y, x) of sample b: full resolution (r <= 1),
// (B, H, W, nc); blocked (r > 1), (B, H/r, W/r, r*r*nc) with pixel
// (r*yb+i, r*xb+j), mask m at channel (i*r+j)*nc + m of (yb, xb).  R is the
// block factor when it is known at compile time (0: full resolution, 2, 4;
// the divisions are then shifts), -1 to read r at run time.
template <int R>
__device__ __forceinline__ long mask_index(int b, int y, int x, int H, int W,
                                           int nc, int r) {
  if (R == 0 || (R < 0 && r <= 1)) return ((static_cast<long>(b) * H + y) * W + x) * nc;
  const int f = R > 0 ? R : r;
  const int hb = H / f, wb = W / f;
  return ((static_cast<long>(b) * hb + y / f) * wb + x / f) * (f * f * nc) +
         ((y % f) * f + x % f) * nc;
}

template <typename T, int K, int R>
__global__ void __launch_bounds__(kPixels)
cdna_tail_bwd_pixel_kernel(const T* __restrict__ grad, const T* __restrict__ prev,
                           const T* __restrict__ first, const T* __restrict__ kernels,
                           const T* __restrict__ masks, T* __restrict__ g_prev,
                           T* __restrict__ g_first, T* __restrict__ g_masks,
                           float* __restrict__ partials, int H, int W, int C, int M,
                           int sna, int r) {
  constexpr int KK = K * K;
  constexpr int pad = K / 2;
  __shared__ float s_kern[KK * kMaxMasks];        // this sample's (K, K, M) kernels
  __shared__ float s_geff[kPixels * KK];          // g_eff of the block's pixels
  __shared__ float s_mask[kPixels * kMaxMasks];   // their transform masks

  const int b = blockIdx.y;
  const int offset = sna ? 2 : 1;
  const int nc = M + offset;
  const long hw = static_cast<long>(H) * W;
  for (int i = threadIdx.x; i < KK * M; i += kPixels)
    s_kern[i] = load(kernels, static_cast<long>(b) * KK * M + i);
  __syncthreads();

  const int pix = blockIdx.x * kPixels + threadIdx.x;   // H*W < 2^31
  const bool active = pix < hw;
  float geff[KK];
  float mk[kMaxMasks + 2];  // indexed by unrolled loops only: registers
#pragma unroll
  for (int t = 0; t < KK; ++t) geff[t] = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxMasks + 2; ++i) mk[i] = 0.f;

  if (active) {
    const int y = pix / W, x = pix - y * W;
    const long base = (static_cast<long>(b) * hw + pix) * C;
    float g[kMaxChannels] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int c = 0; c < kMaxChannels; ++c)
      if (c < C) g[c] = load(grad, base + c);
    const long mi = mask_index<R>(b, y, x, H, W, nc, r);
#pragma unroll
    for (int i = 0; i < kMaxMasks + 2; ++i)
      if (i < nc) mk[i] = load(masks, mi + i);

    // g_eff: the gradient by each tap of this pixel's field
#pragma unroll
    for (int t = 0; t < KK; ++t) {
      const int yy = y + t / K - pad, xx = x + t % K - pad;
      if (yy >= 0 && yy < H && xx >= 0 && xx < W) {
        const long nb = (static_cast<long>(b) * hw + static_cast<long>(yy) * W + xx) * C;
        float s = 0.f;
#pragma unroll
        for (int c = 0; c < kMaxChannels; ++c)
          if (c < C) s += g[c] * load(prev, nb + c);
        geff[t] = s;
      }
    }

    if (g_masks) {
      float s0 = 0.f, s1 = 0.f;
      for (int c = 0; c < C; ++c) {
        s0 += g[c] * load(prev, base + c);
        if (sna) s1 += g[c] * load(first, base + c);
      }
      store(g_masks, mi, s0);
      if (sna) store(g_masks, mi + 1, s1);
      for (int k = 0; k < M; ++k) {
        float s = 0.f;
#pragma unroll
        for (int t = 0; t < KK; ++t) s += geff[t] * s_kern[t * M + k];
        store(g_masks, mi + offset + k, s);
      }
    }

    if (g_first)
      for (int c = 0; c < C; ++c) store(g_first, base + c, sna ? mk[1] * g[c] : 0.f);

    if (g_prev) {
      float acc[kMaxChannels];
#pragma unroll
      for (int c = 0; c < kMaxChannels; ++c) acc[c] = mk[0] * g[c];
      // the neighbour n = q - d(t) reads this pixel through its tap t
#pragma unroll
      for (int t = 0; t < KK; ++t) {
        const int ny = y - (t / K - pad), nx = x - (t % K - pad);
        if (ny >= 0 && ny < H && nx >= 0 && nx < W) {
          const long nmi = mask_index<R>(b, ny, nx, H, W, nc, r) + offset;
          float e = 0.f;
          for (int k = 0; k < M; ++k) e += load(masks, nmi + k) * s_kern[t * M + k];
          const long nb = (static_cast<long>(b) * hw + static_cast<long>(ny) * W + nx) * C;
#pragma unroll
          for (int c = 0; c < kMaxChannels; ++c)
            if (c < C) acc[c] += e * load(grad, nb + c);
        }
      }
#pragma unroll
      for (int c = 0; c < kMaxChannels; ++c)
        if (c < C) store(g_prev, base + c, acc[c]);
    }
  }

  if (partials) {  // the block's share of g_kern, summed in a fixed order
#pragma unroll
    for (int t = 0; t < KK; ++t) s_geff[threadIdx.x * KK + t] = geff[t];
#pragma unroll
    for (int k = 0; k < kMaxMasks; ++k)
      if (k < M) s_mask[threadIdx.x * kMaxMasks + k] = sna ? mk[k + 2] : mk[k + 1];
    __syncthreads();
    float* out = partials + (static_cast<long>(b) * gridDim.x + blockIdx.x) * KK * M;
    for (int idx = threadIdx.x; idx < KK * M; idx += kPixels) {
      const int t = idx / M, k = idx % M;
      float s = 0.f;
      for (int i = 0; i < kPixels; ++i) s += s_mask[i * kMaxMasks + k] * s_geff[i * KK + t];
      out[idx] = s;
    }
  }
}

template <typename T>
__global__ void cdna_tail_bwd_kern_reduce(const float* __restrict__ partials,
                                          T* __restrict__ g_kernels, int n_blocks, int n) {
  const int b = blockIdx.y;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const float* p = partials + static_cast<long>(b) * n_blocks * n + idx;
  float s = 0.f;
  for (int i = 0; i < n_blocks; ++i) s += p[static_cast<long>(i) * n];
  store(g_kernels, static_cast<long>(b) * n + idx, s);
}

template <typename T, int K, int R>
int launch(const void* grad, const void* prev, const void* first, const void* kernels,
           const void* masks, void* g_prev, void* g_first, void* g_kernels, void* g_masks,
           void* partials, int B, int H, int W, int C, int M, int sna, int r,
           cudaStream_t stream) {
  const long hw = static_cast<long>(H) * W;
  const int n_blocks = static_cast<int>((hw + kPixels - 1) / kPixels);
  if (B == 0 || hw == 0) return 0;
  float* part = g_kernels ? static_cast<float*>(partials) : nullptr;
  cdna_tail_bwd_pixel_kernel<T, K, R><<<dim3(n_blocks, B), kPixels, 0, stream>>>(
      static_cast<const T*>(grad), static_cast<const T*>(prev),
      static_cast<const T*>(first), static_cast<const T*>(kernels),
      static_cast<const T*>(masks), static_cast<T*>(g_prev), static_cast<T*>(g_first),
      static_cast<T*>(g_masks), part, H, W, C, M, sna, r);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !g_kernels) return static_cast<int>(err);
  const int n = K * K * M;
  cdna_tail_bwd_kern_reduce<T><<<dim3((n + 127) / 128, B), 128, 0, stream>>>(
      part, static_cast<T*>(g_kernels), n_blocks, n);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int K>
int dispatch_r(const void* grad, const void* prev, const void* first, const void* kernels,
               const void* masks, void* g_prev, void* g_first, void* g_kernels,
               void* g_masks, void* partials, int B, int H, int W, int C, int M, int sna,
               int r, cudaStream_t stream) {
  if (r <= 1)
    return launch<T, K, 0>(grad, prev, first, kernels, masks, g_prev, g_first, g_kernels,
                           g_masks, partials, B, H, W, C, M, sna, r, stream);
  if (r == 4)
    return launch<T, K, 4>(grad, prev, first, kernels, masks, g_prev, g_first, g_kernels,
                           g_masks, partials, B, H, W, C, M, sna, r, stream);
  if (r == 2)
    return launch<T, K, 2>(grad, prev, first, kernels, masks, g_prev, g_first, g_kernels,
                           g_masks, partials, B, H, W, C, M, sna, r, stream);
  return launch<T, K, -1>(grad, prev, first, kernels, masks, g_prev, g_first, g_kernels,
                          g_masks, partials, B, H, W, C, M, sna, r, stream);
}

template <typename T>
int dispatch_k(int K, const void* grad, const void* prev, const void* first,
               const void* kernels, const void* masks, void* g_prev, void* g_first,
               void* g_kernels, void* g_masks, void* partials, int B, int H, int W,
               int C, int M, int sna, int r, cudaStream_t stream) {
  switch (K) {
    case 3:
      return dispatch_r<T, 3>(grad, prev, first, kernels, masks, g_prev, g_first,
                              g_kernels, g_masks, partials, B, H, W, C, M, sna, r, stream);
    case 5:
      return dispatch_r<T, 5>(grad, prev, first, kernels, masks, g_prev, g_first,
                              g_kernels, g_masks, partials, B, H, W, C, M, sna, r, stream);
    case 7:
      return dispatch_r<T, 7>(grad, prev, first, kernels, masks, g_prev, g_first,
                              g_kernels, g_masks, partials, B, H, W, C, M, sna, r, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// The wrapper (ops/cdna_tail.py fused_warp_composite_backward) checks shapes,
// types and contiguity.  dtype: 0 = f32, 1 = bf16.  Null g_* pointers skip
// those gradients; partials is (B, ceil(H*W/128), K*K*M) f32 scratch, needed
// with g_kernels.  Returns the cudaError_t of the launches (0 on success).
extern "C" int cdna_tail_backward(const void* grad, const void* prev, const void* first,
                                  const void* kernels, const void* masks, void* g_prev,
                                  void* g_first, void* g_kernels, void* g_masks,
                                  void* partials, int B, int H, int W, int C, int K, int M,
                                  int sna, int dtype, int mask_block, void* stream) {
  if (C < 1 || C > kMaxChannels || M < 1 || M > kMaxMasks || B > 65535 ||
      (g_kernels && !partials))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_k<float>(K, grad, prev, first, kernels, masks, g_prev, g_first,
                             g_kernels, g_masks, partials, B, H, W, C, M, sna,
                             mask_block, s);
  if (dtype == 1)
    return dispatch_k<__nv_bfloat16>(K, grad, prev, first, kernels, masks, g_prev,
                                     g_first, g_kernels, g_masks, partials, B, H, W, C,
                                     M, sna, mask_block, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
