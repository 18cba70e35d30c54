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
// The last is the transposed correlation in gather form.
//
// Bound on an H100 SXM (48x64, C=3, K=5, M=10, SNA, bf16, blocked masks),
// per sample: it reads g, prev and first (18,432 bytes each), the masks
// (73,728) and the kernels (500), and writes g_prev, g_first (18,432 each),
// g_masks (73,728) and g_kern (500): about 240 KB, so 3.9 MB (1.2 us) at
// B=16 and 61 MB (18 us) at B=256.  Its arithmetic is about 900 FMAs a
// pixel (75 for g_eff, 250 each for g_masks, g_kern and the field, 75 for
// g_prev): 1.8 kFLOP a pixel, 88 MFLOP (1.3 us at 67 TFLOP/s of f32) at
// B=16, 1.4 GFLOP (20 us) at B=256.  Bound by operations, barely.
//
// What held the first design (one thread a pixel, 128 pixels a block, every
// neighbour read through the cache) at 23-28 times the bound: per pixel 250
// two-byte global mask loads at a 24-byte stride to make each of its 25
// neighbours' field values again for g_prev's gather, 25 x C neighbour loads
// behind a bounds test each for g_eff and as many for the gather, and a
// g_kern partial of 250 serial sums over the block's 128 pixels; at B=16
// under a fifth of the threads the card holds, so every load's latency
// showed.  The redesign stages tiles in shared memory, as the forward's
// tiled kernel does:
//   * one block of 256 threads owns a tile of 8 rows x 32 columns of one
//     sample, one pixel a thread; at K=5 in bf16 a block takes 72 KB of
//     shared memory and at most 85 registers a thread, so three blocks fit
//     an SM, and at B=16 the 192 tiles are all resident at once;
//   * grad and prev come in as windows with a K/2 halo, first for the tile,
//     and the masks of the tile and its halo in their own layout (blocked:
//     whole cells): one thread hands each to the copy engine (cp.async.bulk
//     on an mbarrier) where all are runs of whole 16-byte words, else every
//     thread copies 16 bytes at a time (cp.async; the halo windows widened
//     to the left to a 16-byte boundary) and single elements for the rest;
//   * grad, prev and the tile's transform masks are restaged packed, four
//     channels or masks in a float4 (f32) or in 8 bytes (bf16, the inputs'
//     own values), with a zero halo, so the inner loops have no bounds test;
//   * the field is made once for the tile and its halo, in f32, over the
//     masks' staged bytes once every thread holds its pixels' masks in
//     registers (12 x 36 x 25 floats at K=5); a thread makes its two or
//     three pixels' field values together, so one broadcast 16-byte load
//     of kernel values feeds them all.  g_prev's gather then reads 25 field
//     values and 25 packed grad pixels a pixel from shared memory;
//   * g_eff stays in registers for g_masks (one 16-byte load of kernel
//     values feeds four FMAs) and is then written over the field;
//   * the block's g_kern partial, masks^T (M x 256) times g_eff (256 x K*K),
//     is read from shared memory: a group of lanes owns one tap row and four
//     masks (4 x K sums), each lane every 16th (or 8th) pixel, and the lanes'
//     sums meet in a fixed butterfly of warp shuffles; a second launch sums
//     the tiles' partials in a fixed order.  No float atomics, so two runs
//     give the same bits;
//   * g_prev, g_first and g_masks (in the masks' own layout) leave through
//     shared memory with 16-byte or bulk stores; for block factors other
//     than 1, 2 and 4 (cells that 8 x 32 tiles cut) g_masks is stored from
//     each thread.
// What bounds it now is the block's own latency and its shared-memory
// traffic: the field over the halo (1.7 times the tile's pixels) and the
// g_kern partial are half its instructions, and at B=16, where every tile
// is resident at once, all blocks load first and together.
// Accumulation is in f32; each gradient is written in its input's dtype
// (f32 or bf16).  A null output pointer skips that gradient.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tile_io.cuh"

namespace {

constexpr int kMaxChannels = 4;   // C at most 4
constexpr int kMaxMasks = 16;     // M at most 16
constexpr int kTileH = 8;
constexpr int kTileW = 32;
constexpr int kTilePix = kTileH * kTileW;
constexpr int kThreads = kTilePix;                      // one pixel a thread
constexpr int kAlignPx = 8;       // widening of a halo window to 16 bytes, in pixels

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_float(float& d, float v) { d = v; }
__device__ __forceinline__ void from_float(__nv_bfloat16& d, float v) {
  d = __float2bfloat16(v);
}

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return fmaf(a.x, b.x, fmaf(a.y, b.y, fmaf(a.z, b.z, a.w * b.w)));
}
__device__ __forceinline__ void fma4(float4& acc, float s, float4 v) {
  acc.x = fmaf(s, v.x, acc.x);
  acc.y = fmaf(s, v.y, acc.y);
  acc.z = fmaf(s, v.z, acc.z);
  acc.w = fmaf(s, v.w, acc.w);
}

// Four channels of a pixel, or four masks, as shared memory keeps them: f32
// as a float4, bf16 as four bf16 in 8 bytes (the inputs' own values, so
// exact).
template <typename T>
struct Packed4;
template <>
struct Packed4<float> {
  using type = float4;
  __device__ __forceinline__ static float4 pack(const float* v) {
    return make_float4(v[0], v[1], v[2], v[3]);
  }
  __device__ __forceinline__ static float4 unpack(float4 p) { return p; }
};
template <>
struct Packed4<__nv_bfloat16> {
  using type = uint2;
  // the upper half of an f32 that holds a bf16 value
  __device__ __forceinline__ static unsigned bits(float v) { return __float_as_uint(v) >> 16; }
  __device__ __forceinline__ static uint2 pack(const float* v) {
    return make_uint2(bits(v[0]) | bits(v[1]) << 16, bits(v[2]) | bits(v[3]) << 16);
  }
  __device__ __forceinline__ static float4 unpack(uint2 p) {
    return make_float4(__uint_as_float(p.x << 16), __uint_as_float(p.x & 0xffff0000u),
                       __uint_as_float(p.y << 16), __uint_as_float(p.y & 0xffff0000u));
  }
};

// Shared memory of one block, in bytes; every region starts on 16 bytes.
// The regions of fixed size come first.  Then the field's region, which
// first holds the masks' cells as they came, and last the io region: the
// grad and prev windows as they came, later the outputs in their own
// layout.  The last two depend on the mask layout.
template <typename T, int K, int MP>
struct BwdShape {
  using P4 = typename Packed4<T>::type;
  static constexpr int V = 16 / sizeof(T);
  static constexpr int kPad = K / 2, kKK = K * K;
  static constexpr int kHP = kTileH + K - 1, kWP = kTileW + K - 1;   // tile with halo
  static constexpr int kN = kHP * kWP;
  static constexpr int kPer = (kN + kThreads - 1) / kThreads;       // staged pixels a thread
  static constexpr int kMPP = (MP + 3) / 4 * 4;          // kernel values per tap
  static constexpr int kKernBytes = 4 * kKK * kMPP;
  static constexpr int kPackedBytes = sizeof(P4) * kN;   // grad or prev
  static constexpr int kMaskBytes = sizeof(P4) * kMPP / 4 * kTilePix;  // transform masks
  static constexpr int kM01Bytes = 8 * kTilePix;         // background masks, f32
  static constexpr int kRawWindow = kHP * ((kWP + kAlignPx) * kMaxChannels + V);
  static constexpr int kRawTile = kTileH * (kTileW * kMaxChannels + V);
  static constexpr int kFixedBytes =
      kKernBytes + 2 * kPackedBytes + kMaskBytes + kM01Bytes + sizeof(T) * kRawTile;
  static constexpr int kFieldBytes = 4 * kN * kKK;       // later g_eff of the tile
  // mask cells a tile and its halo span: a tile starts on a cell where r
  // divides its sides
  __host__ __device__ static constexpr int cells(int tile, int r) {
    return tile % r ? (tile + 2 * kPad + r - 2) / r + 1
                    : (kPad + r - 1) / r + (tile + kPad - 1) / r + 1;
  }
  __host__ __device__ static constexpr int field_bytes(int nc, int r) {
    const int m = sizeof(T) * cells(kTileH, r) * (cells(kTileW, r) * r * r * nc + V);
    return ((m > kFieldBytes ? m : kFieldBytes) + 15) / 16 * 16;
  }
  __host__ __device__ static constexpr int io_elements(int nc) {
    const int in = 2 * kRawWindow, out = 2 * kRawTile + kTileH * (kTileW * nc + V);
    return in > out ? in : out;
  }
  __host__ __device__ static constexpr size_t bytes(int nc, int r) {
    return kFixedBytes + field_bytes(nc, r) + sizeof(T) * io_elements(nc);
  }
};

// one tile's windows in the tensors and in shared memory
template <typename T>
struct BwdGeometry {
  int b, h0, w0, h1, w1, r_lo, c_lo;
  Window in, io, m_in, m_out;       // grad/prev with halo, the tile, mask cells in and out
  int cy0, cx0, cell;               // the first staged mask cell, cell elements

  __device__ __forceinline__ BwdGeometry(int tile_x, int tile_y, int sample, int H, int W,
                                         int C, int nc, int r, int pad) {
    b = sample;
    h0 = tile_y * kTileH;
    w0 = tile_x * kTileW;
    h1 = min(h0 + kTileH, H);
    w1 = min(w0 + kTileW, W);
    r_lo = max(h0 - pad, 0);
    c_lo = max(w0 - pad, 0);
    // the halo window starts on a 16-byte boundary of its rows where it can
    const int step = 16 / gcd16(C * (int)sizeof(T));
    if ((W * C * (int)sizeof(T)) % 16 == 0) c_lo -= c_lo % step;
    const int r_hi = min(h0 + kTileH + pad, H), c_hi = min(w0 + kTileW + pad, W);
    in = make_window<T>(b, H, W, C, r_lo, r_hi, c_lo, c_hi);
    io = make_window<T>(b, H, W, C, h0, h1, w0, w1);
    const int Hc = H / r, Wc = W / r;
    cell = r * r * nc;
    cy0 = r_lo / r;
    cx0 = max(w0 - pad, 0) / r;
    m_in = make_window<T>(b, Hc, Wc, cell, cy0, (r_hi - 1) / r + 1, cx0, (c_hi - 1) / r + 1);
    m_out = make_window<T>(b, Hc, Wc, cell, h0 / r, (h1 - 1) / r + 1, w0 / r,
                           (w1 - 1) / r + 1);
  }
  __device__ __forceinline__ static int gcd16(int n) {
    int d = 16;
    while (n % d) d >>= 1;
    return d;
  }
};

// Offset of mask 0 of image pixel (y, x) in a staged window of cells whose
// first cell is (cy0, cx0); lg = log2 r for r in (1, 2, 4), else -1.
__device__ __forceinline__ int cell_offset(int y, int x, int r, int lg, int cy0, int cx0,
                                           int stride, int cell, int nc) {
  int cy, cx;
  if (lg >= 0) {
    cy = y >> lg;
    cx = x >> lg;
  } else {
    cy = y / r;
    cx = x / r;
  }
  return (cy - cy0) * stride + (cx - cx0) * cell + ((y - cy * r) * r + (x - cx * r)) * nc;
}

// three blocks an SM in bf16 at K <= 5 (72 KB of shared memory each at
// K=5), so at most 85 registers a thread; two at K=7
template <typename T, int K, int MP>
__global__ void __launch_bounds__(kThreads, K <= 5 ? 3 : 2)
cdna_tail_bwd_tile_kernel(const T* __restrict__ grad, const T* __restrict__ prev,
                          const T* __restrict__ first, const T* __restrict__ kernels,
                          const T* __restrict__ masks, T* __restrict__ g_prev,
                          T* __restrict__ g_first, T* __restrict__ g_masks,
                          float* __restrict__ partials, int H, int W, int C, int M, int sna,
                          int r) {
  using S = BwdShape<T, K, MP>;
  using PK = Packed4<T>;
  using P4 = typename S::P4;
  constexpr int kPad = S::kPad, kKK = S::kKK, kWP = S::kWP, kN = S::kN, kPer = S::kPer;
  constexpr int kMPP = S::kMPP, kQ = kMPP / 4;
  extern __shared__ float4 smem4[];
  __shared__ unsigned long long arrived;                  // mbarrier of the bulk loads
  const int tid = threadIdx.x;
  const int offset = sna ? 2 : 1;
  const int nc = M + offset;
  const int lg = r == 1 ? 0 : r == 2 ? 1 : r == 4 ? 2 : -1;
  char* base = reinterpret_cast<char*>(smem4);
  float* s_kern = reinterpret_cast<float*>(base);                   // [K*K][kMPP]
  P4* s_g = reinterpret_cast<P4*>(base + S::kKernBytes);            // [kN]
  P4* s_x = s_g + kN;                                               // [kN]
  P4* s_mt = s_x + kN;                                              // [kQ][256]
  float2* s_m01 = reinterpret_cast<float2*>(s_mt + kQ * kTilePix);  // [256]
  T* raw_first = reinterpret_cast<T*>(s_m01 + kTilePix);
  char* field = base + S::kFixedBytes;
  T* raw_m = reinterpret_cast<T*>(field);        // the masks' cells as they came,
  float* s_eff = reinterpret_cast<float*>(field);  // then the field [kN][K*K],
  float* s_geff = s_eff;                         // then g_eff of the tile [256][K*K]
  T* raw_g = reinterpret_cast<T*>(field + S::field_bytes(nc, r));   // the io region
  T* raw_x = raw_g + S::kRawWindow;
  T* out_prev = raw_g;                                              // later the outputs
  T* out_first = out_prev + S::kRawTile;
  T* out_m = out_first + S::kRawTile;
  const BwdGeometry<T> g(blockIdx.x, blockIdx.y, blockIdx.z, H, W, C, nc, r, kPad);

  // this sample's CDNA kernels, loaded first so that their latency passes
  // while the copies below are issued
  constexpr int kKernPer = (kKK * kMPP + kThreads - 1) / kThreads;
  const T* kb = kernels + (long)g.b * kKK * M;
  T k_regs[kKernPer];
#pragma unroll
  for (int n = 0; n < kKernPer; ++n) {
    const int i = tid + n * kThreads;
    const int t = i / kMPP, m = i - t * kMPP;
    if (i < kKK * kMPP && m < M) k_regs[n] = kb[t * M + m];
  }

  // 1. the inputs' bytes into shared memory
  const SpanT<const T> spans[4] = {{grad + g.in.origin, raw_g, g.in.rows, g.in.len},
                                   {prev + g.in.origin, raw_x, g.in.rows, g.in.len},
                                   {first + g.io.origin, raw_first, g.io.rows, g.io.len},
                                   {masks + g.m_in.origin, raw_m, g.m_in.rows, g.m_in.len}};
  bool bulk = true;
#pragma unroll
  for (int i = 0; i < 4; ++i) bulk = bulk && spans[i].whole_words();
  if (bulk) {
    if (tid == 0) {
      mbarrier_init(&arrived);
      unsigned bytes = 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) bytes += spans[i].len * sizeof(T);
      mbarrier_expect(&arrived, bytes);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        bulk_load(spans[i].s, spans[i].g, spans[i].len * sizeof(T), &arrived);
    }
  } else {
    copy_in<kThreads>(spans[0].g, g.in.rows, g.in.g_stride, g.in.len, raw_g, g.in.stride);
    copy_in<kThreads>(spans[1].g, g.in.rows, g.in.g_stride, g.in.len, raw_x, g.in.stride);
    copy_in<kThreads>(spans[2].g, g.io.rows, g.io.g_stride, g.io.len, raw_first, g.io.stride);
    copy_in<kThreads>(spans[3].g, g.m_in.rows, g.m_in.g_stride, g.m_in.len, raw_m,
                      g.m_in.stride);
  }
#pragma unroll
  for (int n = 0; n < kKernPer; ++n) {   // as f32, M values padded to kMPP a tap
    const int i = tid + n * kThreads;
    const int m = i % kMPP;
    if (i < kKK * kMPP) s_kern[i] = m < M ? to_float(k_regs[n]) : 0.f;
  }
  if (!bulk) cp_async_wait_all();
  __syncthreads();   // the mbarrier is set up, the kernels and the copies are in
  if (bulk) mbarrier_wait(&arrived);

  // 2. the staged pixels sp = tid + it * kThreads of the tile and its halo:
  //    grad and prev packed with a zero halo, the masks into registers;
  //    then, once every thread holds its masks, the field over their bytes
  float mt[kPer][kMPP], m01[kPer][2];
#pragma unroll
  for (int it = 0; it < kPer; ++it) {
    const int sp = tid + it * kThreads;
    const int hr = sp / kWP, hc = sp - hr * kWP;
    const int h = g.h0 - kPad + hr, w = g.w0 - kPad + hc;
    const bool inside = sp < kN && h >= 0 && h < H && w >= 0 && w < W;
    float gv[kMaxChannels] = {}, xv[kMaxChannels] = {}, mv[kMPP + 2] = {};
    if (inside) {
      const int at = (h - g.r_lo) * g.in.stride + (w - g.c_lo) * C;
#pragma unroll
      for (int c = 0; c < kMaxChannels; ++c) {
        if (c < C) {
          gv[c] = to_float(raw_g[at + c]);
          xv[c] = to_float(raw_x[at + c]);
        }
      }
      const T* mp = raw_m + cell_offset(h, w, r, lg, g.cy0, g.cx0, g.m_in.stride, g.cell, nc);
#pragma unroll
      for (int i = 0; i < kMPP + 2; ++i)
        if (i < nc) mv[i] = to_float(mp[i]);
    }
    if (sp < kN) {
      s_g[sp] = PK::pack(gv);
      s_x[sp] = PK::pack(xv);
    }
#pragma unroll
    for (int k = 0; k < kMPP; ++k) mt[it][k] = k < M ? (sna ? mv[k + 2] : mv[k + 1]) : 0.f;
    m01[it][0] = mv[0];
    m01[it][1] = sna ? mv[1] : 0.f;
  }
  __syncthreads();   // the masks' bytes are read: the field takes their place
#pragma unroll
  for (int t = 0; t < kKK; ++t) {
    const float4* k4 = reinterpret_cast<const float4*>(s_kern + t * kMPP);
    float v[kPer] = {};
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      const float4 kv = k4[q];
#pragma unroll
      for (int it = 0; it < kPer; ++it) {
        v[it] = fmaf(mt[it][4 * q], kv.x, v[it]);
        v[it] = fmaf(mt[it][4 * q + 1], kv.y, v[it]);
        v[it] = fmaf(mt[it][4 * q + 2], kv.z, v[it]);
        v[it] = fmaf(mt[it][4 * q + 3], kv.w, v[it]);
      }
    }
#pragma unroll
    for (int it = 0; it < kPer; ++it) {
      const int sp = tid + it * kThreads;
      if (sp < kN) s_eff[sp * kKK + t] = v[it];
    }
  }
#pragma unroll
  for (int it = 0; it < kPer; ++it) {   // the tile's own masks
    const int sp = tid + it * kThreads;
    const int tr = sp / kWP - kPad, tc = sp % kWP - kPad;
    if (sp < kN && tr >= 0 && tr < kTileH && tc >= 0 && tc < kTileW) {
      const int tp = tr * kTileW + tc;
#pragma unroll
      for (int q = 0; q < kQ; ++q) s_mt[q * kTilePix + tp] = PK::pack(&mt[it][4 * q]);
      s_m01[tp] = make_float2(m01[it][0], m01[it][1]);
    }
  }
  __syncthreads();

  // 3. one pixel a thread: row `row`, column `col` of the tile
  const int col = tid % kTileW, row = tid / kTileW;
  const int h = g.h0 + row, w = g.w0 + col;
  const bool active = h < H && w < W;
  const float4 gp = PK::unpack(s_g[(row + kPad) * kWP + col + kPad]);
  const float gv[4] = {gp.x, gp.y, gp.z, gp.w};
  const float2 m01p = s_m01[row * kTileW + col];
  // g_prev: the gather of the neighbours that read this pixel through tap
  // t = (i, j), staged pixel (row - i + 2 pad, col - j + 2 pad)
  {
    float4 acc = make_float4(m01p.x * gp.x, m01p.x * gp.y, m01p.x * gp.z, m01p.x * gp.w);
#pragma unroll
    for (int i = 0; i < K; ++i) {
#pragma unroll
      for (int j = 0; j < K; ++j) {
        const int n = (row + 2 * kPad - i) * kWP + col + 2 * kPad - j;
        fma4(acc, s_eff[n * kKK + i * K + j], PK::unpack(s_g[n]));
      }
    }
    const float a[4] = {acc.x, acc.y, acc.z, acc.w};
    const int at = row * g.io.stride + col * C;
    if (active) {
#pragma unroll
      for (int c = 0; c < kMaxChannels; ++c) {
        if (c < C) {
          from_float(out_prev[at + c], a[c]);
          from_float(out_first[at + c], m01p.y * gv[c]);
        }
      }
    }
  }
  // g_eff of the pixel, in registers
  float geff[kKK];
#pragma unroll
  for (int i = 0; i < K; ++i) {
#pragma unroll
    for (int j = 0; j < K; ++j)
      geff[i * K + j] = dot4(gp, PK::unpack(s_x[(row + i) * kWP + col + j]));
  }
  __syncthreads();   // the field is read: its place takes g_eff
#pragma unroll
  for (int t = 0; t < kKK; ++t) s_geff[(row * kTileW + col) * kKK + t] = geff[t];
  // g_masks: the background terms, then g_eff times the kernels
  {
    float gm[kMPP];
#pragma unroll
    for (int k = 0; k < kMPP; ++k) gm[k] = 0.f;
#pragma unroll
    for (int t = 0; t < kKK; ++t) {
      const float4* k4 = reinterpret_cast<const float4*>(s_kern + t * kMPP);
#pragma unroll
      for (int q = 0; q < kQ; ++q) {
        const float4 kv = k4[q];
        gm[4 * q] = fmaf(geff[t], kv.x, gm[4 * q]);
        gm[4 * q + 1] = fmaf(geff[t], kv.y, gm[4 * q + 1]);
        gm[4 * q + 2] = fmaf(geff[t], kv.z, gm[4 * q + 2]);
        gm[4 * q + 3] = fmaf(geff[t], kv.w, gm[4 * q + 3]);
      }
    }
    T* gmo = nullptr;
    if (active && lg >= 0)
      gmo = out_m + cell_offset(h, w, r, lg, g.h0 >> lg, g.w0 >> lg, g.m_out.stride, g.cell, nc);
    else if (active && g_masks)   // cells that the tiles cut: straight to the tensor
      gmo = g_masks + (long)g.b * H * W * nc +
            cell_offset(h, w, r, lg, 0, 0, (W / r) * g.cell, g.cell, nc);
    if (gmo) {
      const float4 xo = PK::unpack(s_x[(row + kPad) * kWP + col + kPad]);
      const T* fo = raw_first + row * g.io.stride + col * C;
      float s1 = 0.f;
#pragma unroll
      for (int c = 0; c < kMaxChannels; ++c)
        if (c < C) s1 = fmaf(gv[c], to_float(fo[c]), s1);
      from_float(gmo[0], dot4(gp, xo));
      if (sna) from_float(gmo[1], s1);
#pragma unroll
      for (int k = 0; k < kMPP; ++k)
        if (k < M) from_float(gmo[offset + k], gm[k]);
    }
  }
  // the outputs are staged and g_eff is in place
  const SpanT<T> outs[3] = {{g_prev ? g_prev + g.io.origin : nullptr, out_prev, g.io.rows,
                             g_prev ? g.io.len : 0},
                            {g_first ? g_first + g.io.origin : nullptr, out_first, g.io.rows,
                             g_first ? g.io.len : 0},
                            {g_masks ? g_masks + g.m_out.origin : nullptr, out_m,
                             g.m_out.rows, g_masks && lg >= 0 ? g.m_out.len : 0}};
  const bool bulk_out =
      outs[0].whole_words() && outs[1].whole_words() && outs[2].whole_words();
  if (bulk_out) fence_async_shared();
  __syncthreads();
  if (bulk_out) {
    if (tid == 0) {
#pragma unroll
      for (int i = 0; i < 3; ++i)
        if (outs[i].len) bulk_store(outs[i].g, outs[i].s, outs[i].len * sizeof(T));
    }
  } else {
    copy_out<kThreads>(outs[0].g, g.io.rows, g.io.g_stride, outs[0].len, out_prev,
                       g.io.stride);
    copy_out<kThreads>(outs[1].g, g.io.rows, g.io.g_stride, outs[1].len, out_first,
                       g.io.stride);
    copy_out<kThreads>(outs[2].g, g.m_out.rows, g.m_out.g_stride, outs[2].len, out_m,
                       g.m_out.stride);
  }

  // 4. the tile's share of g_kern: the kSlices lanes of a unit (tap row i,
  //    masks 4q..4q+3) sum its 4 x K values over pixels slice, slice +
  //    kSlices, ...; the lanes' sums then meet in a fixed butterfly of
  //    shuffles, the same order every run
  if (partials) {
    constexpr int kUnits = K * kQ;
    constexpr int kSlices = kThreads / kUnits >= 32   ? 32
                            : kThreads / kUnits >= 16 ? 16
                            : kThreads / kUnits >= 8  ? 8
                                                      : 4;
    static_assert(kUnits * kSlices <= kThreads, "too few threads for g_kern's units");
    const int unit = tid / kSlices, slice = tid % kSlices;
    const int i = unit / kQ, q = unit - i * kQ;
    float4 acc[K];
#pragma unroll
    for (int j = 0; j < K; ++j) acc[j] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (unit < kUnits) {
      for (int p = slice; p < kTilePix; p += kSlices) {
        const float4 mk = PK::unpack(s_mt[q * kTilePix + p]);
        const float* ge = s_geff + p * kKK + i * K;
#pragma unroll
        for (int j = 0; j < K; ++j) fma4(acc[j], ge[j], mk);
      }
    }
#pragma unroll
    for (int d = kSlices / 2; d > 0; d /= 2) {
#pragma unroll
      for (int j = 0; j < K; ++j) {
        acc[j].x += __shfl_xor_sync(0xffffffffu, acc[j].x, d);
        acc[j].y += __shfl_xor_sync(0xffffffffu, acc[j].y, d);
        acc[j].z += __shfl_xor_sync(0xffffffffu, acc[j].z, d);
        acc[j].w += __shfl_xor_sync(0xffffffffu, acc[j].w, d);
      }
    }
    if (unit < kUnits && slice == 0) {
      float* out = partials + ((long)g.b * gridDim.x * gridDim.y + blockIdx.y * gridDim.x +
                               blockIdx.x) * kKK * M;
#pragma unroll
      for (int j = 0; j < K; ++j) {
        const float a[4] = {acc[j].x, acc[j].y, acc[j].z, acc[j].w};
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (4 * q + c < M) out[(i * K + j) * M + 4 * q + c] = a[c];
      }
    }
  }
  if (bulk_out && tid == 0) bulk_store_wait();
}

template <typename T>
__global__ void cdna_tail_bwd_kern_reduce(const float* __restrict__ partials,
                                          T* __restrict__ g_kernels, int n_tiles, int n) {
  const int b = blockIdx.y;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const float* p = partials + static_cast<long>(b) * n_tiles * n + idx;
  float s = 0.f;
  for (int i = 0; i < n_tiles; ++i) s += p[static_cast<long>(i) * n];
  from_float(g_kernels[static_cast<long>(b) * n + idx], s);
}

struct BwdArgs {
  const void *grad, *prev, *first, *kernels, *masks;
  void *g_prev, *g_first, *g_kernels, *g_masks, *partials;
  int B, H, W, C, M, sna, r;
  cudaStream_t stream;
};

template <typename T, int K, int MP>
int launch(const BwdArgs& a) {
  using S = BwdShape<T, K, MP>;
  const int tiles_x = (a.W + kTileW - 1) / kTileW, tiles_y = (a.H + kTileH - 1) / kTileH;
  if (tiles_y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = S::bytes(a.M + (a.sna ? 2 : 1), a.r);
  static SmemOptIn opt_in;   // above 48 KB shared memory is opt-in, per device
  const cudaError_t set = opt_in.ensure(cdna_tail_bwd_tile_kernel<T, K, MP>, smem);
  if (set != cudaSuccess) return static_cast<int>(set);
  float* part = a.g_kernels ? static_cast<float*>(a.partials) : nullptr;
  cdna_tail_bwd_tile_kernel<T, K, MP><<<dim3(tiles_x, tiles_y, a.B), kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.grad), static_cast<const T*>(a.prev),
      static_cast<const T*>(a.first), static_cast<const T*>(a.kernels),
      static_cast<const T*>(a.masks), static_cast<T*>(a.g_prev), static_cast<T*>(a.g_first),
      static_cast<T*>(a.g_masks), part, a.H, a.W, a.C, a.M, a.sna, a.r);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !a.g_kernels) return static_cast<int>(err);
  const int n = K * K * a.M;
  cdna_tail_bwd_kern_reduce<T><<<dim3((n + 127) / 128, a.B), 128, 0, a.stream>>>(
      part, static_cast<T*>(a.g_kernels), tiles_x * tiles_y, n);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int K>
int dispatch_m(const BwdArgs& a) {
  if (a.M <= 10) return launch<T, K, 10>(a);
  return launch<T, K, kMaxMasks>(a);
}

template <typename T>
int dispatch_k(int K, const BwdArgs& a) {
  switch (K) {
    case 3:
      return dispatch_m<T, 3>(a);
    case 5:
      return dispatch_m<T, 5>(a);
    case 7:
      return dispatch_m<T, 7>(a);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// The wrapper (ops/cdna_tail.py fused_warp_composite_backward) checks shapes,
// types and contiguity.  dtype: 0 = f32, 1 = bf16.  mask_block: the block
// factor r of the masks' layout (0 or 1: full resolution).  Null g_* pointers
// skip those gradients; partials is (B, ceil(H/8) * ceil(W/32), K*K*M) f32
// scratch, needed with g_kernels.  Returns the cudaError_t of the launches
// (0 on success).
extern "C" int cdna_tail_backward(const void* grad, const void* prev, const void* first,
                                  const void* kernels, const void* masks, void* g_prev,
                                  void* g_first, void* g_kernels, void* g_masks,
                                  void* partials, int B, int H, int W, int C, int K, int M,
                                  int sna, int dtype, int mask_block, void* stream) {
  const int r = mask_block > 1 ? mask_block : 1;
  if (C < 1 || C > kMaxChannels || M < 1 || M > kMaxMasks || B > 65535 || H % r ||
      W % r || (g_kernels && !partials))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0 || H <= 0 || W <= 0) return 0;
  const BwdArgs a{grad,    prev,     first, kernels, masks, g_prev, g_first,
                  g_kernels, g_masks, partials, B, H, W, C, M, sna, r,
                  static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return dispatch_k<float>(K, a);
  if (dtype == 1) return dispatch_k<__nv_bfloat16>(K, a);
  return static_cast<int>(cudaErrorInvalidValue);
}
