// One conv-LSTM cell's gate nonlinearities, state update and the LayerNorm on
// its output, fused, for Hopper (sm_90a).
//
// It replaces no TPU kernel.  In the JAX package (visual_foresight_tpu/
// models/layers.py, ConvLSTMCell and the LayerNorm after it) XLA fuses this
// chain into the surrounding program; the port ran it as stock PyTorch ops,
// one kernel an op: the gate sum, three sigmoids, the forget gate's +1, two
// tanh, three products, a sum, and LayerNorm's cast, normalisation and cast
// back - 14 launches a cell, each reading and writing whole tensors.
//
// Per pixel row (F features, the gates' 4F channels in the order i, g, f, o):
//   z  = x + r                      (r optional: the recurrent product)
//   c' = sigmoid(f + 1) * c + sigmoid(i) * tanh(g)
//   h' = sigmoid(o) * tanh(c')
//   c', h' rounded to the storage type and written;
//   y  = LayerNorm(h' as stored): mean and variance over the row, the
//        affine map with f32 weight and bias, rounded to the storage type.
// Arithmetic is f32 throughout; storage is f32 or bf16.  The products and the
// sum of the state update are rounded separately (no fused multiply-add), as
// the op chain rounds them, so that in f32 the two agree to an ulp.
//
// Bound on an H100 SXM: the kernel must read the two gate addends (8F values)
// and c (F) and write c', h' and y (3F): 3,072 bytes a row at F=128 in bf16,
// 6,144 at F=256.  The predictor step at the serving point (B=768, 48x64,
// space-to-depth r=4) runs three cells: two of 147,456 rows at F=128 (0.135
// ms each at 3.35 TB/s) and one of 36,864 rows at F=256 (0.068 ms), 1,132.5 MB
// and 0.338 ms a step.  Its arithmetic, about 30 operations a value, is far
// below the card's rate: the kernel is bound by bytes.
//
// Design: each row is owned by a group of G lanes of one warp, each lane
// holding NV 16-byte vectors of every tensor (8 bf16 or 4 f32 values); the
// lanes of a group read neighbouring 16-byte words, so a warp's loads are
// whole sectors.  A lane issues the loads of a vector (its 4 gate words of
// each addend and its word of c) before their arithmetic: 144 bytes in
// flight per thread, three blocks of 256 threads an SM at the 73-76
// registers a thread these widths take.  x and r are read once and stream
// past the cache, c' and h' are next read a step later and stream too, y
// stays in L2 for the layer that reads it next.  The row's mean and then
// its variance come from two passes over the values held in registers,
// summed across the group by shuffles.  The LayerNorm's weight and bias are
// loaded into registers once per thread, and the blocks walk the rows in a
// grid-stride loop, as many blocks as the card holds at once.  On an H100
// SXM (700 W) this reaches 82-84 % of the bound at F=128 and 79-81 % at
// F=256 (0.161-0.165 and 0.083-0.085 ms at the serving shapes).
//
// The second entry, bias_layer_norm_forward, is the LayerNorm that stands
// alone after a convolution: the classic backbone's ln0 on enc0's product
// and ln6 on dec3's.  The port ran it as stock ops: cuDNN's product, the
// bias add, a cast to f32 (for dec3 also the copy that makes its crop
// contiguous), PyTorch's LayerNorm and the cast back - four launches, each
// reading and writing the whole tensor.  Per pixel row of a strided 4-D
// input x (B, H, W, F), channel stride 1:
//   v = x + conv_bias               (optional) in f32, rounded to the
//                                   storage type, as the stock add rounds;
//   y = LayerNorm(v): mean and variance of the row and the affine map in
//       f32, rounded to the storage type.
// Rows are read where they lie (every row starts on a 16-byte boundary), so
// dec3's uncropped (B, 49, 65, F) product is read in place and never
// copied.  Bound on an H100 SXM: read x and write y, 4F bytes a row in bf16
// (conv_bias, weight and bias are read once a thread).  ln6 on (768, 48,
// 64, 32): 301,989,888 bytes, 0.0901 ms at 3.35 TB/s; ln0 on (768, 24, 32,
// 32): 75,497,472 bytes, 0.0225 ms.  The layout is the cell kernel's, G
// lanes a row (4 at F=32 in bf16, 64 rows a 256-thread block), with the
// same loads, stores, group sums and grid-stride loop; x streams past the
// cache and y stays in L2 for mask_head.  At 16 bytes a lane and row,
// what hides the loads' latency is warps, not bytes in flight per thread:
// a group holding 2, 4 or 8 rows at once, all loads issued first, took 76,
// 71 and 60 % of the bound at ln6 against 80 % for one row, its registers
// cutting the blocks an SM holds (at 48 registers a thread, bf16 at F=32
// with the bias, an SM holds five).  On an H100 SXM (700 W) this reaches
// 79-81 % of the bound at ln6 and 74-76 % at ln0 (0.112-0.114 and
// 0.030 ms).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename T>
struct Vec {
  static constexpr int N = 16 / sizeof(T);   // values in a 16-byte word
};

// 16 bytes at p as floats; kStream reads past the cache.
template <bool kStream>
__device__ __forceinline__ void load(const float* p, float (&v)[4]) {
  const float4 a = kStream ? __ldcs(reinterpret_cast<const float4*>(p))
                           : *reinterpret_cast<const float4*>(p);
  v[0] = a.x;
  v[1] = a.y;
  v[2] = a.z;
  v[3] = a.w;
}

template <bool kStream>
__device__ __forceinline__ void load(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 a = kStream ? __ldcs(reinterpret_cast<const uint4*>(p))
                          : *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    __nv_bfloat162 b;
    *reinterpret_cast<uint32_t*>(&b) = w[k];
    const float2 f = __bfloat1622float2(b);
    v[2 * k] = f.x;
    v[2 * k + 1] = f.y;
  }
}

// v rounded to T and stored as 16 bytes at p; v is left holding the stored
// values.  kStream writes past the cache.
template <bool kStream>
__device__ __forceinline__ void store(float* p, float (&v)[4]) {
  const float4 a = make_float4(v[0], v[1], v[2], v[3]);
  if (kStream)
    __stcs(reinterpret_cast<float4*>(p), a);
  else
    *reinterpret_cast<float4*>(p) = a;
}

template <bool kStream>
__device__ __forceinline__ void store(__nv_bfloat16* p, float (&v)[8]) {
  uint32_t w[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const __nv_bfloat162 b = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
    const float2 f = __bfloat1622float2(b);
    v[2 * k] = f.x;
    v[2 * k + 1] = f.y;
    w[k] = *reinterpret_cast<const uint32_t*>(&b);
  }
  const uint4 a = make_uint4(w[0], w[1], w[2], w[3]);
  if (kStream)
    __stcs(reinterpret_cast<uint4*>(p), a);
  else
    *reinterpret_cast<uint4*>(p) = a;
}

__device__ __forceinline__ float sigmoid(float v) { return 1.0f / (1.0f + expf(-v)); }

// Sum of v over the G lanes of a group (G a power of two up to 32).
template <int G>
__device__ __forceinline__ float group_sum(float v, unsigned mask) {
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) v += __shfl_xor_sync(mask, v, o, G);
  return v;
}

struct Args {
  const void* x;
  const void* r;
  const void* c;
  const float* weight;
  const float* bias;
  float eps;
  void* c_out;
  void* h_out;
  void* y_out;
  long long rows;
};

// G lanes a row, NV vectors a lane: F = G * NV * Vec<T>::N features.
template <typename T, int G, int NV, bool kHasR>
__global__ void __launch_bounds__(kThreads) conv_lstm_ln_kernel(const Args a) {
  constexpr int V = Vec<T>::N;
  constexpr int F = G * NV * V;
  constexpr int kRowsPerBlock = kThreads / G;
  const int lane = threadIdx.x % G;
  const unsigned mask =
      G == 32 ? 0xffffffffu : ((1u << G) - 1) << ((threadIdx.x & 31) & ~(G - 1));
  const T* x = static_cast<const T*>(a.x);
  const T* r = static_cast<const T*>(a.r);
  const T* c = static_cast<const T*>(a.c);
  T* c_out = static_cast<T*>(a.c_out);
  T* h_out = static_cast<T*>(a.h_out);
  T* y_out = static_cast<T*>(a.y_out);

  float w[NV][V], b[NV][V];
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int col = (j * G + lane) * V;
#pragma unroll
    for (int e = 0; e < V; e += 4) {
      const float4 wv = *reinterpret_cast<const float4*>(a.weight + col + e);
      const float4 bv = *reinterpret_cast<const float4*>(a.bias + col + e);
      w[j][e] = wv.x, w[j][e + 1] = wv.y, w[j][e + 2] = wv.z, w[j][e + 3] = wv.w;
      b[j][e] = bv.x, b[j][e + 1] = bv.y, b[j][e + 2] = bv.z, b[j][e + 3] = bv.w;
    }
  }

  const long long stride = (long long)gridDim.x * kRowsPerBlock;
  for (long long row = (long long)blockIdx.x * kRowsPerBlock + threadIdx.x / G;
       row < a.rows; row += stride) {
    const T* xr = x + row * 4 * F;
    float h[NV][V];
    float sum = 0.0f;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int col = (j * G + lane) * V;
      float z[4][V], cv[V];
#pragma unroll
      for (int q = 0; q < 4; ++q) load<true>(xr + q * F + col, z[q]);
      load<false>(c + row * F + col, cv);
      if (kHasR) {
        const T* rr = r + row * 4 * F;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          float t[V];
          load<true>(rr + q * F + col, t);
#pragma unroll
          for (int e = 0; e < V; ++e) z[q][e] += t[e];
        }
      }
      float cn[V];
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float ig = __fmul_rn(sigmoid(z[0][e]), tanhf(z[1][e]));
        const float fc = __fmul_rn(sigmoid(z[2][e] + 1.0f), cv[e]);
        cn[e] = __fadd_rn(fc, ig);
        h[j][e] = __fmul_rn(sigmoid(z[3][e]), tanhf(cn[e]));
      }
      store<true>(c_out + row * F + col, cn);
      store<true>(h_out + row * F + col, h[j]);   // h now holds h' as stored
#pragma unroll
      for (int e = 0; e < V; ++e) sum += h[j][e];
    }
    const float mean = group_sum<G>(sum, mask) * (1.0f / F);
    float sq = 0.0f;
#pragma unroll
    for (int j = 0; j < NV; ++j)
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float d = h[j][e] - mean;
        sq += d * d;
      }
    const float rstd = rsqrtf(group_sum<G>(sq, mask) * (1.0f / F) + a.eps);
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int col = (j * G + lane) * V;
      float y[V];
#pragma unroll
      for (int e = 0; e < V; ++e) y[e] = (h[j][e] - mean) * rstd * w[j][e] + b[j][e];
      store<false>(y_out + row * F + col, y);
    }
  }
}

// Launches kernel K over `rows` rows, rows_per_block a block of kThreads, in
// a grid-stride loop: as many blocks as the card holds at once, or fewer
// where the rows need fewer.
template <auto K, typename A>
cudaError_t launch(const A& a, long long rows, int rows_per_block,
                   cudaStream_t stream) {
  static const int resident = [] {
    int n = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, K, kThreads, 0);
    return n > 0 ? n : 1;
  }();
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const long long needed = (rows + rows_per_block - 1) / rows_per_block;
  const long long most = (long long)sms * resident;
  const unsigned blocks = (unsigned)(needed < most ? needed : most);
  K<<<blocks, kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int G, int NV, bool kHasR>
struct Cell {
  static cudaError_t run(const Args& a, cudaStream_t s) {
    return launch<conv_lstm_ln_kernel<T, G, NV, kHasR>>(a, a.rows, kThreads / G, s);
  }
};

// One kernel L<T, G, NV, kFlag> for `vectors` 16-byte words a row.
template <template <typename, int, int, bool> class L, typename T, bool kFlag,
          typename A>
cudaError_t dispatch_width(int vectors, const A& a, cudaStream_t s) {
  switch (vectors) {
    case 1: return L<T, 1, 1, kFlag>::run(a, s);
    case 2: return L<T, 2, 1, kFlag>::run(a, s);
    case 4: return L<T, 4, 1, kFlag>::run(a, s);
    case 8: return L<T, 8, 1, kFlag>::run(a, s);
    case 16: return L<T, 16, 1, kFlag>::run(a, s);
    case 32: return L<T, 32, 1, kFlag>::run(a, s);
    case 64: return L<T, 32, 2, kFlag>::run(a, s);
    case 128: return L<T, 32, 4, kFlag>::run(a, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch(int features, const Args& a, cudaStream_t s) {
  if (features <= 0 || features % Vec<T>::N) return cudaErrorInvalidValue;
  const int vectors = features / Vec<T>::N;
  return a.r ? dispatch_width<Cell, T, true>(vectors, a, s)
             : dispatch_width<Cell, T, false>(vectors, a, s);
}

// -- the stand-alone LayerNorm with the convolution's bias ------------------

struct NormArgs {
  const void* x;
  const void* conv_bias;
  const float* weight;
  const float* bias;
  float eps;
  void* y_out;
  long long rows;                          // B * H * W, at most INT_MAX
  unsigned hw, width;                      // H * W and W
  long long stride_b, stride_h, stride_w;  // x's, in elements
};

// v rounded to T, as a float.
template <typename T>
__device__ __forceinline__ float round_to(float v);

template <>
__device__ __forceinline__ float round_to<float>(float v) { return v; }

template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// G lanes a row, NV vectors a lane: F = G * NV * Vec<T>::N features.
template <typename T, int G, int NV, bool kHasConvBias>
__global__ void __launch_bounds__(kThreads) bias_layer_norm_kernel(const NormArgs a) {
  constexpr int V = Vec<T>::N;
  constexpr int F = G * NV * V;
  constexpr int kRowsPerBlock = kThreads / G;
  const int lane = threadIdx.x % G;
  const unsigned mask =
      G == 32 ? 0xffffffffu : ((1u << G) - 1) << ((threadIdx.x & 31) & ~(G - 1));
  const T* x = static_cast<const T*>(a.x);
  T* y_out = static_cast<T*>(a.y_out);

  float w[NV][V], b[NV][V], cb[NV][V];
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int col = (j * G + lane) * V;
#pragma unroll
    for (int e = 0; e < V; e += 4) {
      const float4 wv = *reinterpret_cast<const float4*>(a.weight + col + e);
      const float4 bv = *reinterpret_cast<const float4*>(a.bias + col + e);
      w[j][e] = wv.x, w[j][e + 1] = wv.y, w[j][e + 2] = wv.z, w[j][e + 3] = wv.w;
      b[j][e] = bv.x, b[j][e + 1] = bv.y, b[j][e + 2] = bv.z, b[j][e + 3] = bv.w;
    }
    if (kHasConvBias) load<false>(static_cast<const T*>(a.conv_bias) + col, cb[j]);
  }

  const long long stride = (long long)gridDim.x * kRowsPerBlock;
  for (long long row = (long long)blockIdx.x * kRowsPerBlock + threadIdx.x / G;
       row < a.rows; row += stride) {
    const unsigned r = (unsigned)row, n = r / a.hw, p = r - n * a.hw;
    const unsigned i = p / a.width, k = p - i * a.width;
    const T* xr = x + n * a.stride_b + i * a.stride_h + k * a.stride_w;
    float v[NV][V];
    float sum = 0.0f;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      load<true>(xr + (j * G + lane) * V, v[j]);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        if (kHasConvBias) v[j][e] = round_to<T>(v[j][e] + cb[j][e]);
        sum += v[j][e];
      }
    }
    const float mean = group_sum<G>(sum, mask) * (1.0f / F);
    float sq = 0.0f;
#pragma unroll
    for (int j = 0; j < NV; ++j)
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float d = v[j][e] - mean;
        sq += d * d;
      }
    const float rstd = rsqrtf(group_sum<G>(sq, mask) * (1.0f / F) + a.eps);
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      float y[V];
#pragma unroll
      for (int e = 0; e < V; ++e) y[e] = (v[j][e] - mean) * rstd * w[j][e] + b[j][e];
      store<false>(y_out + row * F + (j * G + lane) * V, y);
    }
  }
}

template <typename T, int G, int NV, bool kHasConvBias>
struct Norm {
  static cudaError_t run(const NormArgs& a, cudaStream_t s) {
    return launch<bias_layer_norm_kernel<T, G, NV, kHasConvBias>>(a, a.rows, kThreads / G, s);
  }
};

template <typename T>
cudaError_t dispatch(int features, const NormArgs& a, cudaStream_t s) {
  if (features <= 0 || features % Vec<T>::N) return cudaErrorInvalidValue;
  const int vectors = features / Vec<T>::N;
  return a.conv_bias ? dispatch_width<Norm, T, true>(vectors, a, s)
                     : dispatch_width<Norm, T, false>(vectors, a, s);
}

}  // namespace

// Plain C entry point for ctypes.  x and r (r may be null): (rows, 4F); c,
// c_out, h_out, y_out: (rows, F), all contiguous, 16-byte aligned and of
// dtype (0 = float32, 1 = bfloat16); weight and bias: (F,) float32.  F times
// the element size must be 16 bytes times a power of two up to 128.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int conv_lstm_ln_forward(const void* x, const void* r, const void* c,
                                    const void* weight, const void* bias, float eps,
                                    void* c_out, void* h_out, void* y_out,
                                    long long rows, int features, int dtype,
                                    void* stream) {
  if (rows < 0) return (int)cudaErrorInvalidValue;
  if (rows == 0) return (int)cudaSuccess;
  const Args a{x, r, c, static_cast<const float*>(weight), static_cast<const float*>(bias),
               eps, c_out, h_out, y_out, rows};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dispatch<float>(features, a, s);
  if (dtype == 1) return (int)dispatch<__nv_bfloat16>(features, a, s);
  return (int)cudaErrorInvalidValue;
}

// Plain C entry point for ctypes.  x: (batch, height, width, features) at
// element strides (stride_b, stride_h, stride_w, 1), its start and every
// row on a 16-byte boundary; conv_bias (may be null): (features,) of x's
// type; weight and bias: (features,) float32; y_out: contiguous, x's shape
// and type (0 = float32, 1 = bfloat16).  At most INT_MAX rows; features
// as for conv_lstm_ln_forward.  Returns the cudaError_t of the launch (0 on
// success).
extern "C" int bias_layer_norm_forward(const void* x, const void* conv_bias,
                                       const void* weight, const void* bias,
                                       float eps, void* y_out, long long batch,
                                       int height, int width, long long stride_b,
                                       long long stride_h, long long stride_w,
                                       int features, int dtype, void* stream) {
  if (batch < 0 || height < 0 || width < 0) return (int)cudaErrorInvalidValue;
  const long long rows = batch * height * width;
  if (rows == 0) return (int)cudaSuccess;
  if (rows > INT_MAX) return (int)cudaErrorInvalidValue;
  const NormArgs a{x, conv_bias, static_cast<const float*>(weight),
                   static_cast<const float*>(bias), eps, y_out, rows,
                   (unsigned)(height * width), (unsigned)width, stride_b, stride_h,
                   stride_w};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dispatch<float>(features, a, s);
  if (dtype == 1) return (int)dispatch<__nv_bfloat16>(features, a, s);
  return (int)cudaErrorInvalidValue;
}
