// Fused CDNA warp-and-composite tail for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of visual_foresight_tpu/ops/pallas_cdna.py:
//   fused_warp_composite_eff (body _warp_kernel) and
//   fused_warp_composite_chw (body _warp_kernel_chw),
// and also folds in the mask x CDNA-kernel contraction that the TPU path left
// to XLA (visual_foresight_tpu/ops/cdna_warp.py effective_pixel_kernels), so
// the (B, H, W, K*K) effective-kernel field never reaches device memory.
// A second kernel serves the Pallas function's own contract (the field given,
// entry cdna_tail_eff_forward) and, in its DNA mode (entry
// cdna_tail_dna_forward), makes DNA's field from the DNA head's logits and
// the masks itself; see "Effective-kernel entry and DNA mode".
//
// For every output pixel (b, h, w), with offset = 2 if SNA else 1:
//   eff[t]   = sum_m masks[b,h,w,offset+m] * kernels[b,t/K,t%K,m]      (t < K*K)
//   out_x[c] = x[b,h,w,c]*m0 (+ first_x[b,h,w,c]*m1 if SNA)
//            + sum_t eff[t] * x[b, h+t/K-K/2, w+t%K-K/2, c]   (zero outside)
// for x = the previous frame (C channels) and the pixel distributions (P
// channels, P may be 0).  Accumulation is in f32; outputs are written in the
// input dtype (f32 or bf16).  Frames, distributions and outputs are
// contiguous NHWC; the CDNA kernels are (B, K, K, M).  The masks come in one
// of two layouts, chosen by the block factor r:
//   r <= 1: (B, H, W, nc), nc = M + offset (full resolution);
//   r >  1: (B, H/r, W/r, r*r*nc) as the model's low-resolution mask head
//           leaves them: pixel (r*hb+i, r*wb+j), mask m sits at channel
//           (i*r+j)*nc + m of low-resolution pixel (hb, wb).
//
// Bound on an H100 SXM at the serving shapes (48x64, C=3, P=1, K=5, M=10,
// SNA, bf16), per sample: the kernel must read prev and first (18,432 bytes
// each), both distributions (6,144 each), the masks (73,728) and the CDNA
// kernels (500), and write the frame (18,432) and the distribution (6,144):
// 147,956 bytes, so 29.6 MB and 8.8 us at B=200, 113.6 MB and 33.9 us at
// B=768, at 3.35 TB/s.  Its arithmetic is 250 FMAs per pixel for the
// effective kernels, about 100 for the taps and 8 for the compositing:
// 0.44 GFLOP (6.6 us at 67 TFLOP/s of f32) at B=200, 1.69 GFLOP (25 us) at
// B=768.  So it is bound by bytes, the masks being half of them, but the
// arithmetic is three quarters of the bound: it fits only if the FMA pipe
// is kept busy while the bytes move.  At the registration path's shape (two
// distributions a camera, C=3, P=2, B=768) the distributions add 6,144
// bytes in each of their three tensors: 166,388 bytes a sample, 127.8 MB and
// 38.1 us at B=768.  Its five channels take two packed planes below, so the
// taps cost 200 FMAs a pixel instead of 100 (460 in all, 2.2 GFLOP, 32 us):
// bound by bytes still, with the FMAs nearer the bound.
//
// The first design (one thread a pixel, everything but the CDNA kernels read
// straight from global memory) ran at 8.8-9.3 times its byte bound, limited
// by its 370 load/store instructions a pixel beside 350 FMAs, not by device
// memory; so the kernel is tiled.  One block of 128 threads owns a tile of 8
// rows x 64 columns of one sample:
//   * the tensors' bytes pass through shared memory as they are.  Where a
//     tile's input window (with its halo), its part of the SNA background and
//     its masks (in either layout) are each one run of whole 16-byte words -
//     at the serving shapes they are - one thread hands the five runs to the
//     copy engine (cp.async.bulk, completion on an mbarrier) and the outputs
//     leave the same way; elsewhere every thread copies 16 bytes at a time
//     (cp.async) where a run's alignment allows, and scalar elements for the
//     rest;
//   * the input tile is then restaged as f32 with the C frame channels and
//     the P distribution channels of a pixel packed side by side, one plane
//     of float4 where C + P <= 4 and two planes up to 8, so one 16-byte
//     shared load a plane brings all channels of a tap with no conversion in
//     the inner loop; the halo outside the image is zero, so the inner loop
//     has no bounds test.  With two planes a thread holds 32 accumulators
//     and a window of two float4 a row, and the staging is sized for the
//     call's own C + P with the outputs written over the restaged window,
//     so that C + P = 5 fits four blocks an SM;
//   * a thread reads its pixels' masks from the staged bytes in 8-byte words
//     (a pixel's 12 bf16 values are 24 contiguous bytes in both layouts);
//   * each thread computes four vertically neighbouring pixels.  One 8-
//     or 16-byte shared load of CDNA kernel values (padded from M=10 to 12
//     per tap) feeds four times as many FMAs, and the sliding window of
//     K+3 taps per tap column is loaded once for the four pixels: 40 packed
//     loads for 4 pixels at K=5 instead of 400 scalar ones.  Neighbouring
//     threads own neighbouring columns, so their 16-byte shared loads fall
//     on consecutive addresses.  The loop over tap columns stays rolled, so
//     its body (280 FMAs, 23 shared loads at K=5, M=10) fits the instruction
//     cache.
// That leaves about 30 shared loads and 350 FMAs per pixel in the main loop:
// the kernel is then bound by instruction throughput (about 2,300 instructions a
// thread and tile, 1,400 of them FMAs) with the loads and stores of
// neighbouring blocks overlapping only in part, at about 2.4 times the byte
// bound at B=768.  The contraction over the masks stays on the FMA pipe in
// both types: tensor-core fragments (mma.sync.m16n8k16) spread a pixel's
// taps over the four lanes of a quad, which this sliding window cannot use.
// It serves K in (3, 5, 7), M <= 16, C and P up to 4 each, r in (1, 2, 4),
// any H and W; the caller expands masks of another block factor, which no
// model builds, to full resolution.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tile_io.cuh"

namespace {

constexpr int kMaxChannels = 4;   // C and P each at most 4
constexpr int kMaxMasks = 16;     // M at most 16

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_float(float& d, float v) { d = v; }
__device__ __forceinline__ void from_float(__nv_bfloat16& d, float v) {
  d = __float2bfloat16(v);
}

// ---------------------------------------------------------------------------
// The tiled kernel.
// ---------------------------------------------------------------------------

constexpr int kTileW = 64;
constexpr int kTileH = 8;
constexpr int kPx = 4;                                   // pixels per thread, in a column
constexpr int kTilePix = kTileW * kTileH;
constexpr int kTiledThreads = kTilePix / kPx;            // 128
constexpr int kPack = 4;                                 // packed channels per pixel

// Eight bytes of shared memory as floats.
__device__ __forceinline__ void unpack(const float*, uint2 w, float* out) {
  out[0] = __uint_as_float(w.x);
  out[1] = __uint_as_float(w.y);
}
__device__ __forceinline__ void unpack(const __nv_bfloat16*, uint2 w, float* out) {
  out[0] = __uint_as_float(w.x << 16);
  out[1] = __uint_as_float(w.x & 0xffff0000u);
  out[2] = __uint_as_float(w.y << 16);
  out[3] = __uint_as_float(w.y & 0xffff0000u);
}

// Shared memory of one block: NP planes of packed f32 pixels (C + P <= 4 *
// NP), kernel values padded to a multiple of four per tap, then the
// tensors' own bytes: the input window, the tile's SNA background, the
// outputs and the masks.  Two planes are sized for the call's own C + P and
// write the outputs over the restaged window, so that C + P = 5 (the
// registration path) fits four blocks an SM; one plane, held at four by
// its registers, keeps them apart.
template <typename T, int K, int MP, int NP>
struct TiledShape {
  static constexpr int V = 16 / sizeof(T);
  static constexpr int kPad = K / 2;
  static constexpr int kTileWP = kTileW + K - 1;         // staged tile with halo
  static constexpr int kTileHP = kTileH + K - 1;
  static constexpr int kMPP = (MP + 3) / 4 * 4;          // kernel values per tap
  static constexpr int kKernelFloats = K * K * kMPP;
  static constexpr int kTileFloats = kTileHP * kTileWP * kPack * NP;
  static constexpr int kRawMask = kTilePix * (MP + 2) + kTileH * V;
  static constexpr int kOwnOut = NP == 1;                // the outputs' own region
  __host__ __device__ static constexpr int channels(int c_plus_p) {
    return NP == 1 ? kPack : c_plus_p;
  }
  // the window and the background (or the outputs), in elements of T,
  // rounded to 16 bytes
  __host__ __device__ static constexpr int raw_in(int ch) {
    return (kTileHP * (kTileWP * ch + 2 * V) + V - 1) / V * V;
  }
  __host__ __device__ static constexpr int raw_io(int ch) {
    return (kTileH * (kTileW * ch + 2 * V) + V - 1) / V * V;
  }
  static constexpr size_t bytes(int ch) {
    return sizeof(float) * (kKernelFloats + kTileFloats) +
           sizeof(T) * (raw_in(ch) + (1 + kOwnOut) * raw_io(ch) + kRawMask);
  }
};

// Where one tile's data lies, in the tensors and in shared memory.
template <typename T>
struct TileGeometry {
  int b, h0, w0, h1, w1;
  int r_lo, c_lo;                  // corner of the input window with its halo
  Window in_c, in_p, io_c, io_p;   // input window and the tile itself, C and P channels
  long m_origin, m_gstride;        // the tile's masks: runs of cells
  int m_rows, m_len, m_stride, cell;

  __device__ __forceinline__ TileGeometry(int tile_x, int tile_y, int sample, int H,
                                          int W, int C, int P, int nc, int lg, int pad) {
    b = sample;
    h0 = tile_y * kTileH;
    w0 = tile_x * kTileW;
    h1 = min(h0 + kTileH, H);
    w1 = min(w0 + kTileW, W);
    r_lo = max(h0 - pad, 0);
    c_lo = max(w0 - pad, 0);
    const int r_hi = min(h0 + kTileH + pad, H), c_hi = min(w0 + kTileW + pad, W);
    in_c = make_window<T>(b, H, W, C, r_lo, r_hi, c_lo, c_hi);
    in_p = make_window<T>(b, H, W, P, r_lo, r_hi, c_lo, c_hi);
    io_c = make_window<T>(b, H, W, C, h0, h1, w0, w1);
    io_p = make_window<T>(b, H, W, P, h0, h1, w0, w1);
    // masks: cells are low-resolution pixels (r = 1: a cell is a pixel)
    const int Hb = H >> lg, Wb = W >> lg;
    const int hb0 = h0 >> lg, hb1 = h1 >> lg, wb0 = w0 >> lg, wb1 = w1 >> lg;
    cell = nc << (2 * lg);
    m_origin = (((long)b * Hb + hb0) * Wb + wb0) * cell;
    if (wb0 == 0 && wb1 == Wb) {
      m_rows = 1;
      m_len = (hb1 - hb0) * Wb * cell;
      m_gstride = 0;
      m_stride = Wb * cell;
    } else {
      m_rows = hb1 - hb0;
      m_len = (wb1 - wb0) * cell;
      m_gstride = (long)Wb * cell;
      m_stride = round_up_vec<T>((wb1 - wb0) * cell);
    }
  }
};

// The input window of frame channels (raw_c) and distribution channels
// (raw_p), staged as they came, restaged as packed f32 pixels with the halo:
// NP planes of float4, plane q holding channels 4q..4q+3 of every staged
// pixel (the C frame channels first, then the P distribution channels), so
// that neighbouring threads' 16-byte loads fall on consecutive addresses.
// Zero outside the image and in the channels not in use.
template <typename T, int K, int NP>
__device__ __forceinline__ void stage_tile(float4* __restrict__ tile, const T* __restrict__ raw_c,
                                           const T* __restrict__ raw_p,
                                           const TileGeometry<T>& g, int H, int W, int C,
                                           int P) {
  constexpr int kPad = K / 2, kTileWP = kTileW + K - 1, kTileHP = kTileH + K - 1;
  constexpr int kN = kTileHP * kTileWP;
#pragma unroll
  for (int sp0 = 0; sp0 < kN; sp0 += kTiledThreads) {
    const int sp = sp0 + threadIdx.x;
    if (sp >= kN) break;
    const int trow = sp / kTileWP;
    const int h = g.h0 - kPad + trow;
    const int w = g.w0 - kPad + sp - trow * kTileWP;
    float v[kPack * NP] = {};
    if (h >= 0 && h < H && w >= 0 && w < W) {
      const T* pc = raw_c + (h - g.r_lo) * g.in_c.stride + (w - g.c_lo) * C;
      const T* pp = raw_p + (h - g.r_lo) * g.in_p.stride + (w - g.c_lo) * P - C;
#pragma unroll
      for (int ch = 0; ch < kPack * NP; ++ch) {
        if (ch < C) v[ch] = to_float(pc[ch]);
        else if (ch < C + P) v[ch] = to_float(pp[ch]);
      }
    }
#pragma unroll
    for (int q = 0; q < NP; ++q)
      tile[q * kN + sp] = make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
  }
}

// The tile's outputs, composited in shared memory in their own layout and
// type, to global memory: one bulk store each where both are runs of whole
// 16-byte words, else 16 bytes (or one element) a thread.
template <typename T>
__device__ __forceinline__ void store_outputs(T* __restrict__ out_img,
                                              T* __restrict__ out_distrib,
                                              const TileGeometry<T>& g, T* raw_out,
                                              T* raw_od, int P) {
  const SpanT<T> outs[2] = {
      {out_img + g.io_c.origin, raw_out, g.io_c.rows, g.io_c.len},
      {out_distrib + g.io_p.origin, raw_od, g.io_p.rows, P ? g.io_p.len : 0}};
  const bool bulk_out = outs[0].whole_words() && outs[1].whole_words();
  if (bulk_out) fence_async_shared();
  __syncthreads();
  if (bulk_out) {
    if (threadIdx.x == 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
        if (outs[i].len) bulk_store(outs[i].g, outs[i].s, outs[i].len * sizeof(T));
      bulk_store_wait();
    }
  } else {
    copy_out<kTiledThreads>(out_img + g.io_c.origin, g.io_c.rows, g.io_c.g_stride,
                            g.io_c.len, raw_out, g.io_c.stride);
    copy_out<kTiledThreads>(out_distrib + g.io_p.origin, g.io_p.rows, g.io_p.g_stride,
                            outs[1].len, raw_od, g.io_p.stride);
  }
}

// Two planes at the serving shapes (K <= 5, M <= 10) run four blocks an SM
// where C + P = 5: at most 128 registers a thread.
template <typename T, int K, int MP, int NP>
__global__ void __launch_bounds__(kTiledThreads, NP == 2 && K <= 5 && MP <= 10 ? 4 : 1)
cdna_tail_tiled_kernel(const T* __restrict__ prev, const T* __restrict__ first,
                       const T* __restrict__ prev_distrib,
                       const T* __restrict__ first_distrib,
                       const T* __restrict__ kernels, const T* __restrict__ masks,
                       T* __restrict__ out_img, T* __restrict__ out_distrib, int H,
                       int W, int C, int P, int M, int sna, int lg) {
  using S = TiledShape<T, K, MP, NP>;
  constexpr int kPad = S::kPad, kTileWP = S::kTileWP, kTileHP = S::kTileHP;
  constexpr int kMPP = S::kMPP;
  constexpr int kN = kTileHP * kTileWP;                  // staged pixels a plane
  extern __shared__ float4 smem4[];
  __shared__ unsigned long long arrived;                 // mbarrier of the bulk loads
  float* s_k = reinterpret_cast<float*>(smem4);          // [K*K][kMPP]
  float4* tile4 = reinterpret_cast<float4*>(s_k + S::kKernelFloats);   // [NP][kN]
  T* raw_prev = reinterpret_cast<T*>(tile4 + NP * kN);
  const int ch = S::channels(C + P);
  T* raw_first = raw_prev + S::raw_in(ch);
  T* raw_out = S::kOwnOut ? raw_first + S::raw_io(ch) : raw_prev;   // or the window
  T* raw_m = raw_first + (1 + S::kOwnOut) * S::raw_io(ch);

  using Span = SpanT<const T>;
  const int tid = threadIdx.x;
  const int offset = sna ? 2 : 1;
  const int nc = M + offset;
  const TileGeometry<T> g(blockIdx.x, blockIdx.y, blockIdx.z, H, W, C, P, nc, lg, kPad);
  T* raw_pd = raw_prev + g.in_c.size;
  T* raw_fd = raw_first + g.io_c.size;
  T* raw_od = raw_out + g.io_c.size;

  // 1. the tensors' bytes into shared memory: where every run is one span
  //    of whole 16-byte words, one thread hands them to the copy engine;
  //    else each thread copies 16 bytes at a time, or element by element
  const Span spans[5] = {
      {prev + g.in_c.origin, raw_prev, g.in_c.rows, g.in_c.len},
      {prev_distrib + g.in_p.origin, raw_pd, g.in_p.rows, P ? g.in_p.len : 0},
      {first + g.io_c.origin, raw_first, g.io_c.rows, sna ? g.io_c.len : 0},
      {first_distrib + g.io_p.origin, raw_fd, g.io_p.rows, sna && P ? g.io_p.len : 0},
      {masks + g.m_origin, raw_m, g.m_rows, g.m_len}};
  bool bulk = true;
#pragma unroll
  for (int i = 0; i < 5; ++i) bulk = bulk && spans[i].whole_words();
  if (bulk) {
    if (tid == 0) {
      mbarrier_init(&arrived);
      unsigned bytes = 0;
#pragma unroll
      for (int i = 0; i < 5; ++i) bytes += spans[i].len * sizeof(T);
      mbarrier_expect(&arrived, bytes);
#pragma unroll
      for (int i = 0; i < 5; ++i)
        if (spans[i].len)
          bulk_load(spans[i].s, spans[i].g, spans[i].len * sizeof(T), &arrived);
    }
  } else {
    copy_in<kTiledThreads>(spans[0].g, g.in_c.rows, g.in_c.g_stride, g.in_c.len, raw_prev,
                           g.in_c.stride);
    copy_in<kTiledThreads>(spans[1].g, g.in_p.rows, g.in_p.g_stride, spans[1].len, raw_pd,
                           g.in_p.stride);
    copy_in<kTiledThreads>(spans[2].g, g.io_c.rows, g.io_c.g_stride, spans[2].len, raw_first,
                           g.io_c.stride);
    copy_in<kTiledThreads>(spans[3].g, g.io_p.rows, g.io_p.g_stride, spans[3].len, raw_fd,
                           g.io_p.stride);
    copy_in<kTiledThreads>(spans[4].g, g.m_rows, g.m_gstride, g.m_len, raw_m, g.m_stride);
  }
  // this sample's CDNA kernels as f32, M values padded to kMPP per tap
  const T* kb = kernels + (long)g.b * K * K * M;
  constexpr int kPerThread = (S::kKernelFloats + kTiledThreads - 1) / kTiledThreads;
  T k_regs[kPerThread];
#pragma unroll
  for (int n = 0; n < kPerThread; ++n) {
    const int i = tid + n * kTiledThreads;
    const int t = i / kMPP, m = i - t * kMPP;
    if (i < S::kKernelFloats && m < M) k_regs[n] = kb[t * M + m];
  }
#pragma unroll
  for (int n = 0; n < kPerThread; ++n) {
    const int i = tid + n * kTiledThreads;
    const int m = i % kMPP;
    if (i < S::kKernelFloats) s_k[i] = m < M ? to_float(k_regs[n]) : 0.f;
  }
  if (!bulk) cp_async_wait_all();
  __syncthreads();   // the mbarrier is set up, the kernels and the copies are in
  if (bulk) mbarrier_wait(&arrived);

  // 2. the input tile with its halo as packed f32 pixels
  stage_tile<T, K, NP>(tile4, raw_prev, raw_pd, g, H, W, C, P);
  __syncthreads();

  // 3. four pixels of one column per thread: rows r0..r0+3 of the tile
  const int col = tid & (kTileW - 1);
  const int r0 = (tid / kTileW) * kPx;
  if (g.w0 + col < W && g.h0 + r0 < H) {
    constexpr int kPerWord = 8 / sizeof(T);
    constexpr int kWords = (MP + 2 + kPerWord - 1) / kPerWord;
    const bool by_words = (nc * sizeof(T)) % 8 == 0;
    const int words = nc / kPerWord;
    const int sub_mask = (1 << lg) - 1;
    float mt[kPx][MP], m0[kPx], m1[kPx];
#pragma unroll
    for (int px = 0; px < kPx; ++px) {
      const int prow = r0 + px;
      const T* mp = raw_m + (prow >> lg) * g.m_stride + (col >> lg) * g.cell +
                    (((prow & sub_mask) << lg) + (col & sub_mask)) * nc;
      float vals[kWords * kPerWord] = {};
      if (by_words) {
#pragma unroll
        for (int q = 0; q < kWords; ++q)
          if (q < words)
            unpack(mp, reinterpret_cast<const uint2*>(mp)[q], vals + q * kPerWord);
      } else {
#pragma unroll
        for (int m = 0; m < MP + 2; ++m)
          if (m < nc) vals[m] = to_float(mp[m]);
      }
      m0[px] = vals[0];
      m1[px] = vals[1];
      if (sna) {
#pragma unroll
        for (int m = 0; m < MP; ++m) mt[px][m] = vals[m + 2];
      } else {
#pragma unroll
        for (int m = 0; m < MP; ++m) mt[px][m] = vals[m + 1];
      }
      if (M < MP) {
#pragma unroll
        for (int m = 0; m < MP; ++m)
          if (m >= M) mt[px][m] = 0.f;
      }
    }
    float4 acc[kPx][NP];
#pragma unroll
    for (int px = 0; px < kPx; ++px) {
#pragma unroll
      for (int q = 0; q < NP; ++q) acc[px][q] = make_float4(0.f, 0.f, 0.f, 0.f);
    }

#pragma unroll 1   // rolled: the body of one tap column stays in the instruction cache
    for (int j = 0; j < K; ++j) {
      float4 win[kPx + K - 1][NP];
#pragma unroll
      for (int rr = 0; rr < kPx + K - 1; ++rr) {
#pragma unroll
        for (int q = 0; q < NP; ++q) win[rr][q] = tile4[q * kN + (r0 + rr) * kTileWP + col + j];
      }
#pragma unroll
      for (int i = 0; i < K; ++i) {
        float kv[kMPP];
        const float4* k4 = reinterpret_cast<const float4*>(s_k + (i * K + j) * kMPP);
#pragma unroll
        for (int q = 0; q < kMPP / 4; ++q) {
          if (4 * q + 2 < MP) {
            const float4 v = k4[q];
            kv[4 * q] = v.x;
            kv[4 * q + 1] = v.y;
            kv[4 * q + 2] = v.z;
            kv[4 * q + 3] = v.w;
          } else {
            const float2 v = *reinterpret_cast<const float2*>(k4 + q);
            kv[4 * q] = v.x;
            kv[4 * q + 1] = v.y;
            kv[4 * q + 2] = 0.f;
            kv[4 * q + 3] = 0.f;
          }
        }
#pragma unroll
        for (int px = 0; px < kPx; ++px) {
          float e = 0.f;
#pragma unroll
          for (int m = 0; m < MP; ++m) e = fmaf(mt[px][m], kv[m], e);
#pragma unroll
          for (int q = 0; q < NP; ++q) {
            const float4 x = win[px + i][q];
            acc[px][q].x = fmaf(e, x.x, acc[px][q].x);
            acc[px][q].y = fmaf(e, x.y, acc[px][q].y);
            acc[px][q].z = fmaf(e, x.z, acc[px][q].z);
            acc[px][q].w = fmaf(e, x.w, acc[px][q].w);
          }
        }
      }
    }

    // compositing, and the results in the outputs' own layout and type
#pragma unroll
    for (int px = 0; px < kPx; ++px) {
      const int prow = r0 + px;
      if (g.h0 + prow < H) {
        float xs[kPack * NP], as[kPack * NP];
#pragma unroll
        for (int q = 0; q < NP; ++q) {
          const float4 x = tile4[q * kN + (prow + kPad) * kTileWP + col + kPad];
          xs[4 * q] = x.x;
          xs[4 * q + 1] = x.y;
          xs[4 * q + 2] = x.z;
          xs[4 * q + 3] = x.w;
          as[4 * q] = acc[px][q].x;
          as[4 * q + 1] = acc[px][q].y;
          as[4 * q + 2] = acc[px][q].z;
          as[4 * q + 3] = acc[px][q].w;
        }
        const int at_c = prow * g.io_c.stride + col * C;
        const int at_p = prow * g.io_p.stride + col * P - C;
#pragma unroll
        for (int ch = 0; ch < kPack * NP; ++ch) {
          float v = fmaf(xs[ch], m0[px], as[ch]);
          if (ch < C) {
            if (sna) v = fmaf(to_float(raw_first[at_c + ch]), m1[px], v);
            from_float(raw_out[at_c + ch], v);
          } else if (ch < C + P) {
            if (sna) v = fmaf(to_float(raw_fd[at_p + ch]), m1[px], v);
            from_float(raw_od[at_p + ch], v);
          }
        }
      }
    }
  }
  // 4. the outputs' bytes to global memory, the same two ways
  store_outputs(out_img, out_distrib, g, raw_out, raw_od, P);
}

// ---------------------------------------------------------------------------
// Effective-kernel entry and DNA mode.
//
// The effective-kernel entry serves the contract of the Pallas function
// itself (fused_warp_composite_eff): the per-pixel kernel field eff (B, H, W,
// K*K) and the background masks bg (B, H, W, nbg), nbg = 1 or 2, come from
// the caller.  The DNA mode (kDna) reads what the DNA head and the mask head
// leave instead - the logits l (B, H, W, K*K) in the compute type T and the
// softmax masks (B, H, W, nc) in T or f32 - and makes the field per pixel in
// f32, as visual_foresight_tpu/models/cdna.py:461-466 does:
//   pk  = relu(l - 1e-12) + 1e-12;   pk /= sum_t pk
//   eff = round_T(pk * round_TM(sum_m masks[offset + m]));   bg = round_T(masks[:offset])
// The two roundings to the compute type keep the port's arithmetic JAX's.
//
// Bound on an H100 SXM at DNA's serving shapes (48x64, C=3, P=1, K=5, SNA,
// bf16), per sample.  Effective-kernel entry: prev and first (18,432 bytes
// each), both distributions (6,144 each), the field (153,600), the two
// background masks (12,288), the frame and the distribution written (18,432
// + 6,144): 239,616 bytes, so 184.0 MB and 54.9 us at B=768, 47.9 MB and 14.3
// us at B=200, at 3.35 TB/s.  DNA mode: the field's 153,600 bytes of logits
// and 147,456 bytes of f32 masks (12 a pixel) in place of the field and the
// background masks: 374,784 bytes, 287.8 MB and 85.9 us at B=768, 75.0 MB and
// 22.4 us at B=200.  About 108 FMAs a pixel (25 taps x 4 channels, 8 for
// compositing) and, in the DNA mode, about ten more operations a tap for
// the field (250 a pixel): bound by bytes either way.
//
// What held the first design (one thread a pixel, everything read from
// global memory) at 2.8-3.4 times its bound was load instructions: per pixel
// 25 two-byte field loads with neighbouring threads 50 bytes apart, 100
// neighbour loads at 6- and 2-byte strides behind a bounds test each, for
// 108 FMAs.  The redesign takes the tiled kernel's machinery: one block of
// 128 threads owns a tile of 8 rows x 64 columns of one sample, and each
// thread computes four vertically neighbouring pixels;
//   * the frame and distribution window with its halo, the tile's part of
//     the SNA background, its field (logits) and its masks come into shared
//     memory as they are: where each is one run of whole 16-byte words (at
//     W = 64 a tile spans whole rows, so its field is one run of 512 x 25
//     values) one thread hands them to the copy engine (cp.async.bulk on an
//     mbarrier), elsewhere 16-byte cp.async or single elements;
//   * the frame and distributions are restaged as packed f32 pixels with a
//     zero halo, one plane of float4 where C + P <= 4 and two planes up to 8,
//     so the inner loop has no bounds test and one 16-byte shared load
//     brings four channels of a tap; the sliding window of K+3 rows serves
//     the four pixels of a column;
//   * the field stays where it landed, in its own type: a thread reads tap
//     t of its pixel at a stride of K*K values from its neighbour's, which
//     falls on distinct banks in f32 and on at most two words a bank in
//     bf16.  Restaging it tap-major as f32 would double its shared memory
//     (51,200 bytes a tile at K=5) and cost a pass of stores for reads that
//     are already free of conflicts;
//   * the DNA mode makes the field in place: each thread normalizes its own
//     four pixels' logits, weighs them by the transform masks' total and
//     writes the rounded field over them, so no other thread waits on it;
//   * the outputs are composited into the shared copy of the input window,
//     free once it is restaged, and leave with bulk stores.
// It serves K in (3, 5, 7), C <= 4, P <= 4, any H and W, SNA on and off,
// f32 and bf16.
// ---------------------------------------------------------------------------

constexpr float kReluShift = 1e-12f;   // visual_foresight_tpu/models/cdna.py:463

// v rounded to the type T (f32: unchanged).
template <typename T>
__device__ __forceinline__ float round_to(float v);
template <>
__device__ __forceinline__ float round_to<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// Shared memory of one block, in bytes; every region starts on 16 bytes.
// The field's masks are nm channels of TM a pixel.
template <typename T, typename TM, int K, int NP>
struct EffShape {
  static constexpr int V = 16 / sizeof(T), VM = 16 / sizeof(TM);
  static constexpr int kTileWP = kTileW + K - 1, kTileHP = kTileH + K - 1;
  static constexpr int kTileBytes = 16 * NP * kTileHP * kTileWP;
  // the input window as it came (later the outputs), the tile's SNA
  // background and field, in elements of T
  static constexpr int kRawIn = kTileHP * (kTileWP * kPack * NP + 2 * V);
  static constexpr int kRawIo = kTileH * (kTileW * kPack * NP + 2 * V);
  static constexpr int kRawField = kTileH * (kTileW * K * K + V);
  static constexpr size_t bytes(int nm) {
    return kTileBytes + sizeof(T) * (kRawIn + kRawIo + kRawField) +
           sizeof(TM) * kTileH * (kTileW * nm + VM);
  }
};

template <typename T, typename TM, int K, int NP, bool kDna>
__global__ void __launch_bounds__(kTiledThreads)
cdna_tail_eff_kernel(const T* __restrict__ prev, const T* __restrict__ first,
                     const T* __restrict__ prev_distrib,
                     const T* __restrict__ first_distrib, const T* __restrict__ field,
                     const TM* __restrict__ masks, T* __restrict__ out_img,
                     T* __restrict__ out_distrib, int H, int W, int C, int P, int nm,
                     int sna) {
  using S = EffShape<T, TM, K, NP>;
  constexpr int kKK = K * K, kPad = K / 2, kTileWP = S::kTileWP;
  constexpr int kN = S::kTileHP * kTileWP;                 // staged pixels a plane
  extern __shared__ float4 smem4[];
  __shared__ unsigned long long arrived;                    // mbarrier of the bulk loads
  float4* tile = smem4;                                     // [NP][kN]
  T* raw_prev = reinterpret_cast<T*>(smem4 + NP * kN);
  T* raw_first = raw_prev + S::kRawIn;
  T* raw_field = raw_first + S::kRawIo;
  TM* raw_m = reinterpret_cast<TM*>(raw_field + S::kRawField);
  T* raw_out = raw_prev;                                    // once the window is restaged

  const int tid = threadIdx.x;
  const TileGeometry<T> g(blockIdx.x, blockIdx.y, blockIdx.z, H, W, C, P, nm, 0, kPad);
  const Window fw = make_window<T>(g.b, H, W, kKK, g.h0, g.h1, g.w0, g.w1);
  const Window mw = make_window<TM>(g.b, H, W, nm, g.h0, g.h1, g.w0, g.w1);
  T* raw_pd = raw_prev + g.in_c.size;
  T* raw_fd = raw_first + g.io_c.size;
  T* raw_od = raw_out + g.io_c.size;

  // 1. the tensors' bytes into shared memory, as the tiled kernel brings them
  const SpanT<const T> spans[5] = {
      {prev + g.in_c.origin, raw_prev, g.in_c.rows, g.in_c.len},
      {prev_distrib + g.in_p.origin, raw_pd, g.in_p.rows, P ? g.in_p.len : 0},
      {first + g.io_c.origin, raw_first, g.io_c.rows, sna ? g.io_c.len : 0},
      {first_distrib + g.io_p.origin, raw_fd, g.io_p.rows, sna && P ? g.io_p.len : 0},
      {field + fw.origin, raw_field, fw.rows, fw.len}};
  const SpanT<const TM> mspan = {masks + mw.origin, raw_m, mw.rows, mw.len};
  bool bulk = mspan.whole_words();
#pragma unroll
  for (int i = 0; i < 5; ++i) bulk = bulk && spans[i].whole_words();
  if (bulk) {
    if (tid == 0) {
      mbarrier_init(&arrived);
      unsigned bytes = mspan.len * sizeof(TM);
#pragma unroll
      for (int i = 0; i < 5; ++i) bytes += spans[i].len * sizeof(T);
      mbarrier_expect(&arrived, bytes);
#pragma unroll
      for (int i = 0; i < 5; ++i)
        if (spans[i].len)
          bulk_load(spans[i].s, spans[i].g, spans[i].len * sizeof(T), &arrived);
      bulk_load(mspan.s, mspan.g, mspan.len * sizeof(TM), &arrived);
    }
  } else {
    copy_in<kTiledThreads>(spans[0].g, g.in_c.rows, g.in_c.g_stride, g.in_c.len, raw_prev,
                           g.in_c.stride);
    copy_in<kTiledThreads>(spans[1].g, g.in_p.rows, g.in_p.g_stride, spans[1].len, raw_pd,
                           g.in_p.stride);
    copy_in<kTiledThreads>(spans[2].g, g.io_c.rows, g.io_c.g_stride, spans[2].len, raw_first,
                           g.io_c.stride);
    copy_in<kTiledThreads>(spans[3].g, g.io_p.rows, g.io_p.g_stride, spans[3].len, raw_fd,
                           g.io_p.stride);
    copy_in<kTiledThreads>(spans[4].g, fw.rows, fw.g_stride, fw.len, raw_field, fw.stride);
    copy_in<kTiledThreads>(mspan.g, mw.rows, mw.g_stride, mw.len, raw_m, mw.stride);
    cp_async_wait_all();
  }
  __syncthreads();   // the mbarrier is set up, the copies are in
  if (bulk) mbarrier_wait(&arrived);

  // 2. the input tile with its halo as packed f32 pixels; in the DNA mode
  //    each thread makes its own four pixels' field over their logits
  stage_tile<T, K, NP>(tile, raw_prev, raw_pd, g, H, W, C, P);
  const int col = tid & (kTileW - 1);
  const int r0 = (tid / kTileW) * kPx;
  const bool active = g.w0 + col < W && g.h0 + r0 < H;
  if (kDna && active) {
    const int offset = sna ? 2 : 1;
#pragma unroll
    for (int px = 0; px < kPx; ++px) {
      if (g.h0 + r0 + px < H) {
        T* f = raw_field + (r0 + px) * fw.stride + col * kKK;
        const TM* m = raw_m + (r0 + px) * mw.stride + col * nm;
        float pk[kKK], total = 0.f, trans = 0.f;
#pragma unroll
        for (int t = 0; t < kKK; ++t) {
          pk[t] = fmaxf(to_float(f[t]) - kReluShift, 0.f) + kReluShift;
          total += pk[t];
        }
        for (int c = offset; c < nm; ++c) trans += to_float(m[c]);
        trans = round_to<TM>(trans);
        // pk / total, correctly rounded as JAX's division is: a product with
        // the rounded reciprocal and one correction of its residual
        // (Markstein) instead of an IEEE division per tap
        const float inv = 1.f / total;
#pragma unroll
        for (int t = 0; t < kKK; ++t) {
          const float q = pk[t] * inv;
          from_float(f[t], fmaf(fmaf(-q, total, pk[t]), inv, q) * trans);
        }
      }
    }
  }
  __syncthreads();

  // 3. four pixels of one column per thread: rows r0..r0+3 of the tile
  if (active) {
    const T* f[kPx];
    float4 acc[kPx][NP];
#pragma unroll
    for (int px = 0; px < kPx; ++px) {
      f[px] = raw_field + (r0 + px) * fw.stride + col * kKK;
#pragma unroll
      for (int q = 0; q < NP; ++q) acc[px][q] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int j = 0; j < K; ++j) {
      float4 win[kPx + K - 1][NP];
#pragma unroll
      for (int rr = 0; rr < kPx + K - 1; ++rr) {
#pragma unroll
        for (int q = 0; q < NP; ++q) win[rr][q] = tile[q * kN + (r0 + rr) * kTileWP + col + j];
      }
#pragma unroll
      for (int i = 0; i < K; ++i) {
#pragma unroll
        for (int px = 0; px < kPx; ++px) {
          const float e = to_float(f[px][i * K + j]);
#pragma unroll
          for (int q = 0; q < NP; ++q) {
            const float4 x = win[px + i][q];
            acc[px][q].x = fmaf(e, x.x, acc[px][q].x);
            acc[px][q].y = fmaf(e, x.y, acc[px][q].y);
            acc[px][q].z = fmaf(e, x.z, acc[px][q].z);
            acc[px][q].w = fmaf(e, x.w, acc[px][q].w);
          }
        }
      }
    }

    // compositing, and the results in the outputs' own layout and type
#pragma unroll
    for (int px = 0; px < kPx; ++px) {
      const int prow = r0 + px;
      if (g.h0 + prow < H) {
        const TM* m = raw_m + prow * mw.stride + col * nm;
        const float m0 = round_to<T>(to_float(m[0]));
        const float m1 = sna ? round_to<T>(to_float(m[1])) : 0.f;
        float xs[kPack * NP], as[kPack * NP];
#pragma unroll
        for (int q = 0; q < NP; ++q) {
          const float4 x = tile[q * kN + (prow + kPad) * kTileWP + col + kPad];
          xs[4 * q] = x.x;
          xs[4 * q + 1] = x.y;
          xs[4 * q + 2] = x.z;
          xs[4 * q + 3] = x.w;
          as[4 * q] = acc[px][q].x;
          as[4 * q + 1] = acc[px][q].y;
          as[4 * q + 2] = acc[px][q].z;
          as[4 * q + 3] = acc[px][q].w;
        }
        const int at_c = prow * g.io_c.stride + col * C;
        const int at_p = prow * g.io_p.stride + col * P - C;
#pragma unroll
        for (int ch = 0; ch < kPack * NP; ++ch) {
          float v = fmaf(xs[ch], m0, as[ch]);
          if (ch < C) {
            if (sna) v = fmaf(to_float(raw_first[at_c + ch]), m1, v);
            from_float(raw_out[at_c + ch], v);
          } else if (ch < C + P) {
            if (sna) v = fmaf(to_float(raw_fd[at_p + ch]), m1, v);
            from_float(raw_od[at_p + ch], v);
          }
        }
      }
    }
  }
  // 4. the outputs' bytes to global memory
  store_outputs(out_img, out_distrib, g, raw_out, raw_od, P);
}

// ---------------------------------------------------------------------------
// Launches.
// ---------------------------------------------------------------------------

struct Args {
  const void *prev, *first, *prev_distrib, *first_distrib, *kernels, *masks;
  void *out_img, *out_distrib;
  int B, H, W, C, P, M, sna, r;
  cudaStream_t stream;
};

template <typename T, int K, int MP, int NP>
cudaError_t launch_tiled(const Args& a, int lg) {
  using S = TiledShape<T, K, MP, NP>;
  static SmemOptIn opt_in;   // above 48 KB shared memory is opt-in, per device
  const cudaError_t err =
      opt_in.ensure(cdna_tail_tiled_kernel<T, K, MP, NP>, S::bytes(kPack * NP));
  if (err != cudaSuccess) return err;
  const int tiles_y = (a.H + kTileH - 1) / kTileH;
  if (tiles_y > 65535) return cudaErrorInvalidValue;
  const dim3 grid((a.W + kTileW - 1) / kTileW, tiles_y, a.B);
  const size_t smem = S::bytes(S::channels(a.C + a.P));
  cdna_tail_tiled_kernel<T, K, MP, NP><<<grid, kTiledThreads, smem, a.stream>>>(
      static_cast<const T*>(a.prev), static_cast<const T*>(a.first),
      static_cast<const T*>(a.prev_distrib), static_cast<const T*>(a.first_distrib),
      static_cast<const T*>(a.kernels), static_cast<const T*>(a.masks),
      static_cast<T*>(a.out_img), static_cast<T*>(a.out_distrib), a.H, a.W, a.C, a.P,
      a.M, a.sna, lg);
  return cudaGetLastError();
}

template <typename T, int K, int NP>
cudaError_t launch_tiled_masks(const Args& a, int lg) {
  if (a.M <= 10) return launch_tiled<T, K, 10, NP>(a, lg);
  return launch_tiled<T, K, kMaxMasks, NP>(a, lg);
}

// the tiled kernel packs C + P <= 4 channels into one plane, up to 8 into two
template <typename T, int K>
cudaError_t launch(const Args& a) {
  const int r = a.r > 1 ? a.r : 1;
  if (a.C + a.P > 2 * kPack || (r != 1 && r != 2 && r != 4)) return cudaErrorInvalidValue;
  const int lg = r == 4 ? 2 : r - 1;
  if (a.C + a.P <= kPack) return launch_tiled_masks<T, K, 1>(a, lg);
  return launch_tiled_masks<T, K, 2>(a, lg);
}

// The tiled kernel's residency at a shape, for measurement: the blocks an
// SM can hold at the dynamic shared memory its launch asks for.
template <typename T, int K, int MP, int NP>
cudaError_t tiled_occupancy(int c_plus_p, int* blocks, int* smem) {
  using S = TiledShape<T, K, MP, NP>;
  const cudaError_t err = cudaFuncSetAttribute(
      cdna_tail_tiled_kernel<T, K, MP, NP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)S::bytes(kPack * NP));
  if (err != cudaSuccess) return err;
  *smem = (int)S::bytes(S::channels(c_plus_p));
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, cdna_tail_tiled_kernel<T, K, MP, NP>, kTiledThreads, *smem);
}

template <typename T, int K>
cudaError_t tiled_occupancy_k(int C, int P, int M, int* blocks, int* smem) {
  if (C + P > 2 * kPack) return cudaErrorInvalidValue;
  if (C + P <= kPack)
    return M <= 10 ? tiled_occupancy<T, K, 10, 1>(C + P, blocks, smem)
                   : tiled_occupancy<T, K, kMaxMasks, 1>(C + P, blocks, smem);
  return M <= 10 ? tiled_occupancy<T, K, 10, 2>(C + P, blocks, smem)
                 : tiled_occupancy<T, K, kMaxMasks, 2>(C + P, blocks, smem);
}

template <typename T>
cudaError_t tiled_occupancy_t(int C, int P, int K, int M, int* blocks, int* smem) {
  switch (K) {
    case 3:
      return tiled_occupancy_k<T, 3>(C, P, M, blocks, smem);
    case 5:
      return tiled_occupancy_k<T, 5>(C, P, M, blocks, smem);
    case 7:
      return tiled_occupancy_k<T, 7>(C, P, M, blocks, smem);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch_k(int K, const Args& a) {
  switch (K) {
    case 3:
      return launch<T, 3>(a);
    case 5:
      return launch<T, 5>(a);
    case 7:
      return launch<T, 7>(a);
    default:
      return cudaErrorInvalidValue;
  }
}

struct EffArgs {
  const void *prev, *first, *prev_distrib, *first_distrib, *field, *masks;
  void *out_img, *out_distrib;
  int B, H, W, C, P, nm, sna;
  cudaStream_t stream;
};

template <typename T, typename TM, int K, int NP, bool kDna>
cudaError_t launch_eff(const EffArgs& a) {
  using S = EffShape<T, TM, K, NP>;
  static SmemOptIn opt_in;   // above 48 KB shared memory is opt-in, per device
  const cudaError_t err = opt_in.ensure(cdna_tail_eff_kernel<T, TM, K, NP, kDna>,
                                        S::bytes(kDna ? kMaxMasks + 2 : 2));
  if (err != cudaSuccess) return err;
  const int tiles_y = (a.H + kTileH - 1) / kTileH;
  if (tiles_y > 65535) return cudaErrorInvalidValue;
  const dim3 grid((a.W + kTileW - 1) / kTileW, tiles_y, a.B);
  cdna_tail_eff_kernel<T, TM, K, NP, kDna><<<grid, kTiledThreads, S::bytes(a.nm), a.stream>>>(
      static_cast<const T*>(a.prev), static_cast<const T*>(a.first),
      static_cast<const T*>(a.prev_distrib), static_cast<const T*>(a.first_distrib),
      static_cast<const T*>(a.field), static_cast<const TM*>(a.masks),
      static_cast<T*>(a.out_img), static_cast<T*>(a.out_distrib), a.H, a.W, a.C, a.P,
      a.nm, a.sna);
  return cudaGetLastError();
}

// one plane of packed channels where C + P <= 4, two up to 8
template <typename T, typename TM, int K, bool kDna>
cudaError_t launch_eff_planes(const EffArgs& a) {
  if (a.C + a.P <= kPack) return launch_eff<T, TM, K, 1, kDna>(a);
  return launch_eff<T, TM, K, 2, kDna>(a);
}

template <typename T, typename TM, bool kDna>
cudaError_t dispatch_eff(int K, const EffArgs& a) {
  switch (K) {
    case 3:
      return launch_eff_planes<T, TM, 3, kDna>(a);
    case 5:
      return launch_eff_planes<T, TM, 5, kDna>(a);
    case 7:
      return launch_eff_planes<T, TM, 7, kDna>(a);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point for ctypes.  dtype: 0 = float32, 1 = bfloat16.
// mask_block: the block factor r of the mask layout (0 or 1: full
// resolution; 2 or 4: blocked; any other is refused).  Returns the cudaError_t of the launch (0 on success).
extern "C" int cdna_tail_forward(const void* prev, const void* first,
                                 const void* prev_distrib, const void* first_distrib,
                                 const void* kernels, const void* masks,
                                 void* out_img, void* out_distrib, int B, int H,
                                 int W, int C, int P, int K, int M, int sna,
                                 int dtype, int mask_block, void* stream) {
  if (B <= 0 || B > 65535 || H <= 0 || W <= 0 || C < 1 || C > kMaxChannels ||
      P < 0 || P > kMaxChannels || M < 1 || M > kMaxMasks ||
      (mask_block != 0 && mask_block != 1 && mask_block != 2 && mask_block != 4))
    return (int)cudaErrorInvalidValue;
  if (mask_block > 1 && (H % mask_block || W % mask_block))
    return (int)cudaErrorInvalidValue;
  const Args a{prev, first, prev_distrib, first_distrib, kernels, masks, out_img,
               out_distrib, B, H, W, C, P, M, sna, mask_block,
               static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return (int)dispatch_k<float>(K, a);
  if (dtype == 1) return (int)dispatch_k<__nv_bfloat16>(K, a);
  return (int)cudaErrorInvalidValue;
}

// Plain C entry point of the tiled kernel's residency: the blocks of 128
// threads an SM holds at C frame and P distribution channels, K and M, and
// the dynamic shared memory of one block, in bytes.  dtype as above.
// Returns the cudaError_t of the query (0 on success).
extern "C" int cdna_tail_tiled_occupancy(int C, int P, int K, int M, int dtype,
                                         int* blocks, int* smem) {
  if (C < 1 || C > kMaxChannels || P < 0 || P > kMaxChannels || M < 1 ||
      M > kMaxMasks)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0) return (int)tiled_occupancy_t<float>(C, P, K, M, blocks, smem);
  if (dtype == 1) return (int)tiled_occupancy_t<__nv_bfloat16>(C, P, K, M, blocks, smem);
  return (int)cudaErrorInvalidValue;
}

// Plain C entry point of the effective-kernel entry.  eff: (B, H, W, K*K);
// bg: (B, H, W, nbg), nbg = 1 or 2 (2 with SNA).  dtype as above.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int cdna_tail_eff_forward(const void* prev, const void* first,
                                     const void* prev_distrib, const void* first_distrib,
                                     const void* eff, const void* bg, void* out_img,
                                     void* out_distrib, int B, int H, int W, int C, int P,
                                     int K, int nbg, int sna, int dtype, void* stream) {
  if (B <= 0 || B > 65535 || H <= 0 || W <= 0 || C < 1 || C > kMaxChannels || P < 0 ||
      P > kMaxChannels || nbg < 1 || nbg > 2 || (sna && nbg < 2) ||
      (long)H * W > (1L << 30))
    return (int)cudaErrorInvalidValue;
  const EffArgs a{prev, first, prev_distrib, first_distrib, eff, bg, out_img, out_distrib,
                  B, H, W, C, P, nbg, sna, static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return (int)dispatch_eff<float, float, false>(K, a);
  if (dtype == 1) return (int)dispatch_eff<__nv_bfloat16, __nv_bfloat16, false>(K, a);
  return (int)cudaErrorInvalidValue;
}

// Plain C entry point of the DNA mode.  logits: (B, H, W, K*K) of dtype;
// masks: (B, H, W, nc), nc = the transform masks + (2 if SNA else 1), of
// mask_dtype (0 = float32, 1 = bfloat16; bfloat16 only with a bfloat16
// dtype).  Returns the cudaError_t of the launch (0 on success).
extern "C" int cdna_tail_dna_forward(const void* prev, const void* first,
                                     const void* prev_distrib, const void* first_distrib,
                                     const void* logits, const void* masks, void* out_img,
                                     void* out_distrib, int B, int H, int W, int C, int P,
                                     int K, int nc, int sna, int dtype, int mask_dtype,
                                     void* stream) {
  if (B <= 0 || B > 65535 || H <= 0 || W <= 0 || C < 1 || C > kMaxChannels || P < 0 ||
      P > kMaxChannels || nc < (sna ? 3 : 2) || nc > kMaxMasks + 2 ||
      (long)H * W > (1L << 30))
    return (int)cudaErrorInvalidValue;
  const EffArgs a{prev, first, prev_distrib, first_distrib, logits, masks, out_img,
                  out_distrib, B, H, W, C, P, nc, sna, static_cast<cudaStream_t>(stream)};
  if (dtype == 0 && mask_dtype == 0) return (int)dispatch_eff<float, float, true>(K, a);
  if (dtype == 1 && mask_dtype == 0)
    return (int)dispatch_eff<__nv_bfloat16, float, true>(K, a);
  if (dtype == 1 && mask_dtype == 1)
    return (int)dispatch_eff<__nv_bfloat16, __nv_bfloat16, true>(K, a);
  return (int)cudaErrorInvalidValue;
}
