// Fused 3x3 SAME conv + bias + ReLU over NHWC, and its ReLU-masked
// input-gradient backward, for Hopper (sm_90a).
//
// Replaces style_transfer2_tpu/ops/pallas/conv.py: conv3x3_bias_relu
// (_fwd_kernel through _fwd_call) and its custom vjp (_bwd_kernel through
// _bwd_call / _cvr_bwd).
//
//   forward:  y  = ReLU(conv3x3_SAME(x, w) + b)          w: (3, 3, Cin, Cout)
//   backward: dx = conv3x3_SAME(g * [y > 0], wt)         wt = flip(w)^T
//                                                        (3, 3, Cout, Cin)
//
// What bounds it on this card: arithmetic. At the 512px main-path shapes
// the trunk is ~55 GMAC per forward and K = 9*Cin is 27..4608, so the
// kernels do ~70..600 multiply-adds per byte they read from device memory,
// far above the memory roofline. Both kernels keep a block's operands on
// chip: a block owns an 8x16 pixel tile by 64 output channels and stages
// its input tile with a 1-pixel halo in BOTH H and W (the TPU kernel tiled
// whole rows only because of Mosaic's block-shape rules) plus the matching
// weight slice in shared memory, a few input channels at a time. The halo,
// the SAME zero padding, odd H and W, Cin = 3 and Cout not a multiple of 64
// are masks on load and store.
//
//   float32:  FP32 FMA, never TF32, so the float32 mode stays exact. Each
//             thread keeps an 8-pixel x 4-channel accumulator in registers,
//             reusing each input value across the three horizontal taps and
//             each weight across 8 pixels. Bound by the FMA issue rate
//             (67 TFLOP/s peak).
//   bfloat16: tensor cores through mma.sync m16n8k16 (bf16 operands, f32
//             accumulation, one rounding on store), 32 input channels staged
//             per pass with 16-byte loads; each warp owns two 16-pixel rows
//             of the tile by 64 channels and reads its A fragments straight
//             from the staged halo tile with ldmatrix, so im2col never
//             exists. Bound by the unpipelined staging and the ldmatrix
//             traffic; wgmma with a TMA-fed ring is later work.
//
// The backward takes one of three paths, chosen by shape
// (ops/conv.py:bwd_plan), because the forward's tile loses to cuDNN at two
// kinds of backward shape:
//   narrow: dx with Cout <= 8 (conv1_1: 3 channels), float32 or bfloat16.
//           A 64-channel tile would spend 61 of every 64 FMAs on zero
//           weights; this kernel gives each thread 2 pixels x all Cout
//           outputs and is bound by memory (g and y, read once).
//   split:  float32 deep layers whose (pixel tile x 64 channels) grid ends in a
//           wave that leaves much of the card idle (the tile kernel holds
//           one block per SM). The cotangent channels are split across
//           blocks into partial outputs, summed in split order by a
//           second small pass (no atomics: two calls give the same bits).
//   tile:   everything else.
// The split and tile paths stage g and y 16 bytes at a time, mask in
// registers and read the next channel slice into registers while the
// current one is multiplied (the forward staged one element at a time,
// with nothing in flight while it computed).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <algorithm>
#include <cstddef>
#include <cstdint>

namespace {

constexpr int TH = 8;     // output rows per block
constexpr int TW = 16;    // output columns per block
constexpr int TC = 64;    // output channels per block
constexpr int THREADS = 256;

// ---------------------------------------------------------------- float32

constexpr int KC = 8;     // input channels staged per pass (FMA kernels)

// Forward. x: (N, H, W, Cin); w: (3, 3, Cin, Cout); b: (Cout,);
// out: (N, H, W, Cout). Grid: (ceil(H/TH) * ceil(W/TW), ceil(Cout/TC), N).
__global__ void __launch_bounds__(THREADS)
conv3x3_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   const float* __restrict__ b, float* __restrict__ out,
                   int H, int W, int Cin, int Cout) {
  __shared__ float s_in[KC][TH + 2][TW + 2];
  __shared__ __align__(16) float s_w[9][KC][TC];

  const int tiles_w = (W + TW - 1) / TW;
  const int h0 = (blockIdx.x / tiles_w) * TH;
  const int w0 = (blockIdx.x % tiles_w) * TW;
  const int co0 = blockIdx.y * TC;
  const size_t img = (size_t)blockIdx.z * H * W;
  const int tid = threadIdx.x;
  const int cg = tid % 16;          // channels co0 + 4*cg .. +3
  const int pg = tid / 16;          // pixels: row pg/2, columns 8*(pg%2)..+7
  const int pr = pg >> 1;
  const int pc = (pg & 1) * 8;

  float acc[8][4];
#pragma unroll
  for (int p = 0; p < 8; ++p)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[p][j] = 0.f;

  for (int k0 = 0; k0 < Cin; k0 += KC) {
    // Input tile with its halo; consecutive threads take consecutive
    // channels of one pixel. Out-of-image pixels are the SAME zeros.
    for (int i = tid; i < KC * (TH + 2) * (TW + 2); i += THREADS) {
      const int k = i % KC;
      const int pix = i / KC;
      const int r = pix / (TW + 2);
      const int c = pix % (TW + 2);
      const int gh = h0 + r - 1;
      const int gw = w0 + c - 1;
      const int gk = k0 + k;
      float v = 0.f;
      if (gh >= 0 && gh < H && gw >= 0 && gw < W && gk < Cin)
        v = x[(img + (size_t)gh * W + gw) * Cin + gk];
      s_in[k][r][c] = v;
    }
    // Weight slice (9, KC, TC); consecutive threads take consecutive
    // output channels.
    for (int i = tid; i < 9 * KC * TC; i += THREADS) {
      const int co = i % TC;
      const int k = (i / TC) % KC;
      const int tap = i / (TC * KC);
      const int gk = k0 + k;
      const int gco = co0 + co;
      s_w[tap][k][co] = (gk < Cin && gco < Cout)
                            ? w[((size_t)tap * Cin + gk) * Cout + gco]
                            : 0.f;
    }
    __syncthreads();

#pragma unroll
    for (int k = 0; k < KC; ++k) {
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        float xin[10];
#pragma unroll
        for (int j = 0; j < 10; ++j) xin[j] = s_in[k][pr + dy][pc + j];
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const float4 wv =
              *reinterpret_cast<const float4*>(&s_w[dy * 3 + dx][k][cg * 4]);
#pragma unroll
          for (int p = 0; p < 8; ++p) {
            const float xv = xin[p + dx];
            acc[p][0] = fmaf(xv, wv.x, acc[p][0]);
            acc[p][1] = fmaf(xv, wv.y, acc[p][1]);
            acc[p][2] = fmaf(xv, wv.z, acc[p][2]);
            acc[p][3] = fmaf(xv, wv.w, acc[p][3]);
          }
        }
      }
    }
    __syncthreads();
  }

  const int gh = h0 + pr;
  if (gh >= H) return;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int co = co0 + cg * 4 + j;
    if (co >= Cout) continue;
    const float bias = b[co];
#pragma unroll
    for (int p = 0; p < 8; ++p) {
      const int gw = w0 + pc + p;
      if (gw >= W) continue;
      out[(img + (size_t)gh * W + gw) * Cout + co] =
          fmaxf(acc[p][j] + bias, 0.f);
    }
  }
}

// g * [y > 0], four channels at a time.
__device__ __forceinline__ float4 relu_mask4(float4 g, float4 y) {
  return make_float4(y.x > 0.f ? g.x : 0.f, y.y > 0.f ? g.y : 0.f,
                     y.z > 0.f ? g.z : 0.f, y.w > 0.f ? g.w : 0.f);
}

// Masked backward, the tile path. g, y: (N, H, W, K) cotangent and forward
// output; wt: (3, 3, K, Cout) the flipped, transposed forward weights;
// out: (S, N, H, W, Cout). Split s of S sums the cotangent channels
// [s * kspan, min(K, (s + 1) * kspan)) into out[s] (kspan a multiple of
// KC), so a grid that would not fill the card gets S times the blocks;
// with S = 1, out is dx. Grid: (ceil(H/TH) * ceil(W/TW), ceil(Cout/TC),
// N * S). The same 8-pixel x 4-channel register tile as the forward. The
// next channel slice of g, y and wt is read into registers while the
// current one is multiplied, and the ReLU mask is applied in registers on
// its way to shared memory. VEC (K a multiple of 4): g and y are read 16
// bytes at a time; otherwise one element at a time.
template <bool VEC>
__global__ void __launch_bounds__(THREADS)
conv3x3_f32_bwd_kernel(const float* __restrict__ g,
                       const float* __restrict__ y,
                       const float* __restrict__ wt, float* __restrict__ out,
                       int N, int H, int W, int K, int Cout, int kspan) {
  constexpr int PIX = (TH + 2) * (TW + 2);
  // Input items per thread and slice: float4 of 4 channels (VEC) or
  // single channels, and single weights.
  constexpr int IN_ITEMS = VEC ? (PIX * KC / 4 + THREADS - 1) / THREADS
                               : (PIX * KC + THREADS - 1) / THREADS;
  constexpr int W_ITEMS = 9 * KC * TC / THREADS;
  static_assert(W_ITEMS * THREADS == 9 * KC * TC, "weights split evenly");
  __shared__ float s_in[KC][TH + 2][TW + 2];
  __shared__ __align__(16) float s_w[9][KC][TC];

  const int tiles_w = (W + TW - 1) / TW;
  const int h0 = (blockIdx.x / tiles_w) * TH;
  const int w0 = (blockIdx.x % tiles_w) * TW;
  const int co0 = blockIdx.y * TC;
  const int n = blockIdx.z % N;
  const int split = blockIdx.z / N;
  const int kbeg = split * kspan;
  const int kend = min(K, kbeg + kspan);
  const size_t img = (size_t)n * H * W;
  const int tid = threadIdx.x;
  const int cg = tid % 16;
  const int pg = tid / 16;
  const int pr = pg >> 1;
  const int pc = (pg & 1) * 8;

  float4 rg[IN_ITEMS], ry[IN_ITEMS];
  float rw[W_ITEMS];

  // Global -> registers for the slice at k0. Item i of the input tile is
  // (pixel, channel group) with the group fastest, as the channels of a
  // pixel are contiguous in memory; out-of-image pixels and channels past
  // K read as zeros.
  auto fetch = [&](int k0) {
#pragma unroll
    for (int it = 0; it < IN_ITEMS; ++it) {
      const int i = tid + it * THREADS;
      constexpr int GROUPS = VEC ? KC / 4 : KC;
      const int q = i % GROUPS;
      const int pix = i / GROUPS;
      const int gh = h0 + pix / (TW + 2) - 1;
      const int gw = w0 + pix % (TW + 2) - 1;
      const int gk = k0 + (VEC ? 4 * q : q);
      float4 gv = make_float4(0.f, 0.f, 0.f, 0.f);
      float4 yv = gv;
      if (pix < PIX && gh >= 0 && gh < H && gw >= 0 && gw < W && gk < K) {
        const size_t idx = (img + (size_t)gh * W + gw) * K + gk;
        if (VEC) {
          gv = *reinterpret_cast<const float4*>(g + idx);
          yv = *reinterpret_cast<const float4*>(y + idx);
        } else {
          gv.x = g[idx];
          yv.x = y[idx];
        }
      }
      rg[it] = gv;
      ry[it] = yv;
    }
#pragma unroll
    for (int it = 0; it < W_ITEMS; ++it) {
      const int i = tid + it * THREADS;
      const int co = i % TC;
      const int k = (i / TC) % KC;
      const int tap = i / (TC * KC);
      const int gk = k0 + k;
      const int gco = co0 + co;
      rw[it] = (gk < K && gco < Cout)
                   ? wt[((size_t)tap * K + gk) * Cout + gco] : 0.f;
    }
  };

  // Registers -> shared memory, the mask applied on the way.
  auto stash = [&]() {
#pragma unroll
    for (int it = 0; it < IN_ITEMS; ++it) {
      const int i = tid + it * THREADS;
      constexpr int GROUPS = VEC ? KC / 4 : KC;
      const int q = i % GROUPS;
      const int pix = i / GROUPS;
      if (pix >= PIX) continue;
      float* dst = &s_in[0][0][0] + pix;
      constexpr int PLANE = PIX;
      if (VEC) {
        const float4 v = relu_mask4(rg[it], ry[it]);
        dst[(4 * q) * PLANE] = v.x;
        dst[(4 * q + 1) * PLANE] = v.y;
        dst[(4 * q + 2) * PLANE] = v.z;
        dst[(4 * q + 3) * PLANE] = v.w;
      } else {
        dst[q * PLANE] = ry[it].x > 0.f ? rg[it].x : 0.f;
      }
    }
#pragma unroll
    for (int it = 0; it < W_ITEMS; ++it)
      (&s_w[0][0][0])[tid + it * THREADS] = rw[it];
  };

  float acc[8][4];
#pragma unroll
  for (int p = 0; p < 8; ++p)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[p][j] = 0.f;

  if (kbeg < kend) fetch(kbeg);
  for (int k0 = kbeg; k0 < kend; k0 += KC) {
    stash();
    __syncthreads();
    if (k0 + KC < kend) fetch(k0 + KC);

#pragma unroll
    for (int k = 0; k < KC; ++k) {
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        float xin[10];
#pragma unroll
        for (int j = 0; j < 10; ++j) xin[j] = s_in[k][pr + dy][pc + j];
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const float4 wv =
              *reinterpret_cast<const float4*>(&s_w[dy * 3 + dx][k][cg * 4]);
#pragma unroll
          for (int p = 0; p < 8; ++p) {
            const float xv = xin[p + dx];
            acc[p][0] = fmaf(xv, wv.x, acc[p][0]);
            acc[p][1] = fmaf(xv, wv.y, acc[p][1]);
            acc[p][2] = fmaf(xv, wv.z, acc[p][2]);
            acc[p][3] = fmaf(xv, wv.w, acc[p][3]);
          }
        }
      }
    }
    __syncthreads();
  }

  const int gh = h0 + pr;
  if (gh >= H) return;
  float* dst = out + (size_t)split * N * H * W * Cout;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int co = co0 + cg * 4 + j;
    if (co >= Cout) continue;
#pragma unroll
    for (int p = 0; p < 8; ++p) {
      const int gw = w0 + pc + p;
      if (gw >= W) continue;
      dst[(img + (size_t)gh * W + gw) * Cout + co] = acc[p][j];
    }
  }
}

// dx = sum over s of parts[s], in split order. parts: (S, n) floats.
__global__ void sum_splits_kernel(const float* __restrict__ parts,
                                  float* __restrict__ dx, long long n,
                                  int splits) {
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       e < n; e += (long long)gridDim.x * blockDim.x) {
    float v = parts[e];
    for (int s = 1; s < splits; ++s) v += parts[s * n + e];
    dx[e] = v;
  }
}

// Masked backward, the narrow path (float32 and bfloat16): Cout <= 8 (conv1_1's dx: K = 64
// cotangent channels, Cout = 3), where the tile path would multiply zero
// weights in 61 of its 64 output channels. The work is 9*K*Cout FMAs per
// pixel against 8*K bytes of g and y read, so it is bound by memory. Each
// thread owns NR_RPT pixels of one column by all Cout outputs (padded to
// 4*CO4); a block of NR_THREADS covers NR_ROWS x NR_COLS pixels and stages
// the masked g tile with its 1-pixel halo, NR_KC channels at a time, as
// float4 channel quads, beside that slice's weights. A thread reads each
// staged quad once per column tap for NR_RPT + 2 rows, so the staged tile
// is reused across the three row taps. g, y: (N, H, W, K), K a multiple of
// 4; wt: (3, 3, K, Cout); dx: (N, H, W, Cout); all of element type T,
// float or bfloat16 (bf16 values widen to float on load, the sums are
// float, and dx is rounded once on store, as in the bf16 tile kernel).
// Grid: (ceil(H/NR_ROWS) * ceil(W/NR_COLS), 1, N).
constexpr int NR_COLS = 32;
constexpr int NR_RPT = 2;
constexpr int NR_THREADS = 128;
constexpr int NR_ROWS = NR_RPT * NR_THREADS / NR_COLS;   // 8
constexpr int NR_KC = 16;
constexpr int NR_PIX = (NR_ROWS + 2) * (NR_COLS + 2);
// Floats per channel-quad plane: NR_PIX quads, padded to 8 mod 32 so that
// the staging stores of neighbouring lanes (4 quads of 2 pixels) fall in
// distinct banks.
constexpr int NR_PLANE = (NR_PIX * 4 + 31) / 32 * 32 + 8;

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);   // 8-byte aligned
  const float2 lo =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <int CO4, typename T>
__global__ void __launch_bounds__(NR_THREADS)
conv3x3_bwd_narrow_kernel(const T* __restrict__ g, const T* __restrict__ y,
                          const T* __restrict__ wt, T* __restrict__ dx,
                          int H, int W, int K, int Cout) {
  constexpr int CP = 4 * CO4;
  __shared__ __align__(16) float s_g[NR_KC / 4][NR_PLANE];
  __shared__ __align__(16) float s_w[9][NR_KC][CP];

  const int tiles_w = (W + NR_COLS - 1) / NR_COLS;
  const int h0 = (blockIdx.x / tiles_w) * NR_ROWS;
  const int w0 = (blockIdx.x % tiles_w) * NR_COLS;
  const size_t img = (size_t)blockIdx.z * H * W;
  const int tid = threadIdx.x;
  const int cx = tid % NR_COLS;
  const int r0 = (tid / NR_COLS) * NR_RPT;

  float acc[NR_RPT][CP];
#pragma unroll
  for (int r = 0; r < NR_RPT; ++r)
#pragma unroll
    for (int j = 0; j < CP; ++j) acc[r][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += NR_KC) {
    // Item i = (pixel, quad), quad fastest: four lanes read one pixel's
    // 64 contiguous bytes of g (and of y).
#pragma unroll 4
    for (int i = tid; i < NR_PIX * (NR_KC / 4); i += NR_THREADS) {
      const int q = i % (NR_KC / 4);
      const int pix = i / (NR_KC / 4);
      const int gh = h0 + pix / (NR_COLS + 2) - 1;
      const int gw = w0 + pix % (NR_COLS + 2) - 1;
      const int gk = k0 + 4 * q;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (gh >= 0 && gh < H && gw >= 0 && gw < W && gk < K) {
        const size_t idx = (img + (size_t)gh * W + gw) * K + gk;
        v = relu_mask4(load4(g + idx), load4(y + idx));
      }
      *reinterpret_cast<float4*>(&s_g[q][4 * pix]) = v;
    }
    for (int i = tid; i < 9 * NR_KC * CP; i += NR_THREADS) {
      const int co = i % CP;
      const int k = (i / CP) % NR_KC;
      const int tap = i / (CP * NR_KC);
      const int gk = k0 + k;
      s_w[tap][k][co] =
          (gk < K && co < Cout)
              ? widen(wt[((size_t)tap * K + gk) * Cout + co]) : 0.f;
    }
    __syncthreads();

#pragma unroll
    for (int q = 0; q < NR_KC / 4; ++q) {
#pragma unroll
      for (int dxt = 0; dxt < 3; ++dxt) {
        float4 v[NR_RPT + 2];
#pragma unroll
        for (int r = 0; r < NR_RPT + 2; ++r)
          v[r] = *reinterpret_cast<const float4*>(
              &s_g[q][4 * ((r0 + r) * (NR_COLS + 2) + cx + dxt)]);
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            float wv[CP];
#pragma unroll
            for (int c4 = 0; c4 < CO4; ++c4) {
              const float4 w4 = *reinterpret_cast<const float4*>(
                  &s_w[dy * 3 + dxt][4 * q + kk][4 * c4]);
              wv[4 * c4] = w4.x;
              wv[4 * c4 + 1] = w4.y;
              wv[4 * c4 + 2] = w4.z;
              wv[4 * c4 + 3] = w4.w;
            }
#pragma unroll
            for (int r = 0; r < NR_RPT; ++r) {
              const float4 s = v[r + dy];
              const float xv = kk == 0 ? s.x : kk == 1 ? s.y
                             : kk == 2 ? s.z : s.w;
#pragma unroll
              for (int j = 0; j < CP; ++j)
                acc[r][j] = fmaf(xv, wv[j], acc[r][j]);
            }
          }
        }
      }
    }
    __syncthreads();
  }

  const int gw = w0 + cx;
  if (gw >= W) return;
#pragma unroll
  for (int r = 0; r < NR_RPT; ++r) {
    const int gh = h0 + r0 + r;
    if (gh >= H) continue;
    T* dst = dx + (img + (size_t)gh * W + gw) * Cout;
#pragma unroll
    for (int j = 0; j < CP; ++j)
      if (j < Cout) store1(dst + j, acc[r][j]);
  }
}

// --------------------------------------------------------------- bfloat16

using bf16 = __nv_bfloat16;
constexpr int MMA_THREADS = 128;   // 4 warps; warp w owns tile rows 2w, 2w+1
constexpr int BK = 32;             // input channels staged per pass
constexpr int IN_LD = BK + 8;      // smem elements per staged pixel (80 B:
                                   // ldmatrix rows hit distinct banks)
constexpr int W_LD = TC + 8;       // smem elements per weight row (144 B)
constexpr int IN_ELEMS = (TH + 2) * (TW + 2) * IN_LD;
constexpr int W_ELEMS = 9 * BK * W_LD;
constexpr int MMA_SMEM = (IN_ELEMS + W_ELEMS) * (int)sizeof(bf16);

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

// d += a (16x16, row) * b (16x8, col); bf16 operands, f32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Zeroes the lanes of 8 packed bf16 values v whose y is not > 0.
__device__ __forceinline__ uint4 relu_mask8(uint4 v, uint4 y) {
  uint32_t* pv = reinterpret_cast<uint32_t*>(&v);
  const uint32_t* py = reinterpret_cast<const uint32_t*>(&y);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&py[i]));
    const uint32_t keep = (f.x > 0.f ? 0x0000ffffu : 0u) |
                          (f.y > 0.f ? 0xffff0000u : 0u);
    pv[i] &= keep;
  }
  return v;
}

// The same contract as conv3x3_f32_kernel, in bfloat16 with f32
// accumulation on the tensor cores (mma.sync m16n8k16). Per pass the block
// stages BK input channels of the halo tile and of the 9 weight taps; per
// tap and 16-channel step each warp loads its two 16-pixel A fragments
// straight from the halo tile with ldmatrix (a tap is a shifted window of
// staged pixels, so im2col never exists) and four 16x16 B fragments with
// ldmatrix.trans, and issues 16 MMAs into 2 x 8 accumulator tiles.
// VEC_IN (Cin a multiple of 8): the input tile is staged 16 bytes at a
// time; VEC_OUT (Cout a multiple of 8): so are the weight rows, and the
// store writes channel pairs. Otherwise (conv1_1: Cin = 3 forward, Cout = 3
// backward) that side goes element by element.
template <bool BWD, bool VEC_IN, bool VEC_OUT>
__global__ void __launch_bounds__(MMA_THREADS)
conv3x3_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ y,
                    const bf16* __restrict__ w, const bf16* __restrict__ b,
                    bf16* __restrict__ out, int H, int W, int Cin,
                    int Cout) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* s_in = reinterpret_cast<bf16*>(smem_raw);   // [(TH+2)(TW+2)][IN_LD]
  bf16* s_w = s_in + IN_ELEMS;                      // [9 * BK][W_LD]

  const int tiles_w = (W + TW - 1) / TW;
  const int h0 = (blockIdx.x / tiles_w) * TH;
  const int w0 = (blockIdx.x % tiles_w) * TW;
  const int co0 = blockIdx.y * TC;
  const size_t img = (size_t)blockIdx.z * H * W;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const bf16 zero = __float2bfloat16(0.f);

  float acc[2][TC / 8][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nb = 0; nb < TC / 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][nb][e] = 0.f;

  for (int k0 = 0; k0 < Cin; k0 += BK) {
    // Input tile with its halo; out-of-image pixels and channels past Cin
    // are zeros.
    if (VEC_IN) {
      for (int i = tid; i < (TH + 2) * (TW + 2) * (BK / 8);
           i += MMA_THREADS) {
        const int v8 = i % (BK / 8);
        const int pix = i / (BK / 8);
        const int gh = h0 + pix / (TW + 2) - 1;
        const int gw = w0 + pix % (TW + 2) - 1;
        const int gk = k0 + v8 * 8;
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (gh >= 0 && gh < H && gw >= 0 && gw < W && gk < Cin) {
          const size_t idx = (img + (size_t)gh * W + gw) * Cin + gk;
          val = *reinterpret_cast<const uint4*>(x + idx);
          if (BWD) val = relu_mask8(val, *reinterpret_cast<const uint4*>(
                                             y + idx));
        }
        *reinterpret_cast<uint4*>(s_in + pix * IN_LD + v8 * 8) = val;
      }
    } else {
      for (int i = tid; i < (TH + 2) * (TW + 2) * BK; i += MMA_THREADS) {
        const int k = i % BK;
        const int pix = i / BK;
        const int gh = h0 + pix / (TW + 2) - 1;
        const int gw = w0 + pix % (TW + 2) - 1;
        const int gk = k0 + k;
        bf16 v = zero;
        if (gh >= 0 && gh < H && gw >= 0 && gw < W && gk < Cin) {
          const size_t idx = (img + (size_t)gh * W + gw) * Cin + gk;
          v = x[idx];
          if (BWD && !(__bfloat162float(y[idx]) > 0.f)) v = zero;
        }
        s_in[pix * IN_LD + k] = v;
      }
    }
    // Weight rows (tap, k) of TC output channels.
    if (VEC_OUT) {
      for (int i = tid; i < 9 * BK * (TC / 8); i += MMA_THREADS) {
        const int v8 = i % (TC / 8);
        const int row = i / (TC / 8);
        const int gk = k0 + row % BK;
        const int gco = co0 + v8 * 8;
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (gk < Cin && gco < Cout)
          val = *reinterpret_cast<const uint4*>(
              w + ((size_t)(row / BK) * Cin + gk) * Cout + gco);
        *reinterpret_cast<uint4*>(s_w + row * W_LD + v8 * 8) = val;
      }
    } else {
      for (int i = tid; i < 9 * BK * TC; i += MMA_THREADS) {
        const int co = i % TC;
        const int row = i / TC;
        const int gk = k0 + row % BK;
        const int gco = co0 + co;
        s_w[row * W_LD + co] =
            (gk < Cin && gco < Cout)
                ? w[((size_t)(row / BK) * Cin + gk) * Cout + gco]
                : zero;
      }
    }
    __syncthreads();

#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3;
      const int dx = tap % 3;
#pragma unroll
      for (int ks = 0; ks < BK / 16; ++ks) {
        // A: pixels (2 warp + mi + dy, lane%16 + dx), channels ks*16 +
        // 8*(lane/16) .. +7 — the four 8x8 quarters of a 16x16 fragment.
        uint32_t a[2][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
          ldmatrix_x4(a[mi], smem_addr(
              s_in + ((2 * warp + mi + dy) * (TW + 2) + lane % 16 + dx)
                         * IN_LD + ks * 16 + (lane / 16) * 8));
#pragma unroll
        for (int nj = 0; nj < TC / 16; ++nj) {
          // B: k rows ks*16 + lane%16, channels nj*16 + 8*(lane/16) .. +7,
          // transposed into two 16x8 column fragments.
          uint32_t bq[4];
          ldmatrix_x4_trans(bq, smem_addr(
              s_w + (tap * BK + ks * 16 + lane % 16) * W_LD + nj * 16
                  + (lane / 16) * 8));
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
            mma_bf16(acc[mi][2 * nj], a[mi], bq[0], bq[1]);
            mma_bf16(acc[mi][2 * nj + 1], a[mi], bq[2], bq[3]);
          }
        }
      }
    }
    __syncthreads();
  }

  // Accumulator (row g or g + 8 = pixel, columns 2t, 2t + 1 = channels):
  // bias, ReLU, one rounding to bf16, masked store.
  const int g = lane / 4;
  const int t = lane % 4;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
    const int gh = h0 + 2 * warp + mi;
    if (gh >= H) continue;
#pragma unroll
    for (int nb = 0; nb < TC / 8; ++nb) {
      const int co = co0 + nb * 8 + 2 * t;
      if (co >= Cout) continue;
      const bool pair = co + 1 < Cout;
      float b0 = 0.f, b1 = 0.f;
      if (!BWD) {
        b0 = __bfloat162float(b[co]);
        if (pair) b1 = __bfloat162float(b[co + 1]);
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int gw = w0 + g + 8 * half;
        if (gw >= W) continue;
        float v0 = acc[mi][nb][2 * half] + b0;
        float v1 = acc[mi][nb][2 * half + 1] + b1;
        if (!BWD) {
          v0 = fmaxf(v0, 0.f);
          v1 = fmaxf(v1, 0.f);
        }
        bf16* dst = out + (img + (size_t)gh * W + gw) * Cout + co;
        if (VEC_OUT) {
          *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(
              v0, v1);
        } else {
          dst[0] = __float2bfloat16(v0);
          if (pair) dst[1] = __float2bfloat16(v1);
        }
      }
    }
  }
}

template <bool BWD, bool VEC_IN, bool VEC_OUT>
int launch_bf16(const dim3& grid, cudaStream_t st, const void* x,
                const void* y, const void* w, const void* b, void* out,
                int h, int wd, int cin, int cout) {
  // Above 48 KB, dynamic shared memory must be allowed explicitly, once
  // per kernel.
  static const cudaError_t attr = cudaFuncSetAttribute(
      conv3x3_bf16_kernel<BWD, VEC_IN, VEC_OUT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, MMA_SMEM);
  if (attr != cudaSuccess) return (int)attr;
  conv3x3_bf16_kernel<BWD, VEC_IN, VEC_OUT>
      <<<grid, MMA_THREADS, MMA_SMEM, st>>>(
      (const bf16*)x, (const bf16*)y, (const bf16*)w, (const bf16*)b,
      (bf16*)out, h, wd, cin, cout);
  return (int)cudaGetLastError();
}

template <bool BWD>
int launch_bf16_any(const dim3& grid, cudaStream_t st, const void* x,
                    const void* y, const void* w, const void* b, void* out,
                    int h, int wd, int cin, int cout) {
  const bool vin = cin % 8 == 0;
  const bool vout = cout % 8 == 0;
  if (vin && vout)
    return launch_bf16<BWD, true, true>(grid, st, x, y, w, b, out, h, wd,
                                        cin, cout);
  if (vin)
    return launch_bf16<BWD, true, false>(grid, st, x, y, w, b, out, h, wd,
                                         cin, cout);
  if (vout)
    return launch_bf16<BWD, false, true>(grid, st, x, y, w, b, out, h, wd,
                                         cin, cout);
  return launch_bf16<BWD, false, false>(grid, st, x, y, w, b, out, h, wd,
                                        cin, cout);
}

dim3 tile_grid(int n, int h, int wd, int cout) {
  return dim3(((h + TH - 1) / TH) * ((wd + TW - 1) / TW),
              (cout + TC - 1) / TC, n);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after the
// launch (0 = success); -1 for an unknown dtype.
extern "C" int st2_conv3x3_fwd(int dtype, const void* x, const void* w,
                               const void* b, void* y, int n, int h, int wd,
                               int cin, int cout, void* stream) {
  const dim3 grid = tile_grid(n, h, wd, cout);
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) {
    conv3x3_f32_kernel<<<grid, THREADS, 0, st>>>(
        (const float*)x, (const float*)w, (const float*)b, (float*)y, h, wd,
        cin, cout);
    return (int)cudaGetLastError();
  }
  if (dtype != 1) return -1;
  return launch_bf16_any<false>(grid, st, x, nullptr, w, b, y, h, wd, cin,
                                cout);
}

// g, y: (n, h, wd, cin) cotangent and forward output; wt: (3, 3, cin, cout)
// the flipped, in/out-transposed forward weights; dx: (n, h, wd, cout).
// path (ops/conv.py:bwd_plan): 0 = the tile kernel (float32 or bfloat16);
// 1 = the narrow kernel (float32 or bfloat16; cout <= 8, cin a multiple
// of 4); 2 = the
// float32 tile kernel split over `splits` ranges of kspan cotangent
// channels into parts (splits, n, h, wd, cout), then summed in split order
// into dx. Returns the first nonzero cudaGetLastError(), or -1 for a path,
// dtype or shape the kernels do not take.
extern "C" int st2_conv3x3_bwd(int dtype, int path, const void* g,
                               const void* y, const void* wt, void* dx,
                               void* parts, int n, int h, int wd, int cin,
                               int cout, int splits, int kspan,
                               void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (path == 1) {
    if (cout > 8 || cin % 4 != 0 || dtype < 0 || dtype > 1) return -1;
    const dim3 grid(((h + NR_ROWS - 1) / NR_ROWS) *
                        ((wd + NR_COLS - 1) / NR_COLS), 1, n);
    if (dtype == 1 && cout <= 4)
      conv3x3_bwd_narrow_kernel<1, bf16><<<grid, NR_THREADS, 0, st>>>(
          (const bf16*)g, (const bf16*)y, (const bf16*)wt, (bf16*)dx, h, wd,
          cin, cout);
    else if (dtype == 1)
      conv3x3_bwd_narrow_kernel<2, bf16><<<grid, NR_THREADS, 0, st>>>(
          (const bf16*)g, (const bf16*)y, (const bf16*)wt, (bf16*)dx, h, wd,
          cin, cout);
    else if (cout <= 4)
      conv3x3_bwd_narrow_kernel<1, float><<<grid, NR_THREADS, 0, st>>>(
          (const float*)g, (const float*)y, (const float*)wt, (float*)dx, h,
          wd, cin, cout);
    else
      conv3x3_bwd_narrow_kernel<2, float><<<grid, NR_THREADS, 0, st>>>(
          (const float*)g, (const float*)y, (const float*)wt, (float*)dx, h,
          wd, cin, cout);
    return (int)cudaGetLastError();
  }
  if (dtype == 1 && path == 0)
    return launch_bf16_any<true>(tile_grid(n, h, wd, cout), st, g, y, wt,
                                 nullptr, dx, h, wd, cin, cout);
  if (dtype != 0) return -1;
  const float* gf = (const float*)g;
  const float* yf = (const float*)y;
  const float* wf = (const float*)wt;
  const bool vec = cin % 4 == 0;
  if (path == 0) {
    splits = 1;
    kspan = cin;
  } else if (path != 2 || splits < 2 || kspan % KC != 0 ||
             (long long)(splits - 1) * kspan >= cin ||
             (long long)splits * kspan < cin) {
    return -1;
  }
  float* out = path == 2 ? (float*)parts : (float*)dx;
  const dim3 grid = tile_grid(n * splits, h, wd, cout);
  if (vec)
    conv3x3_f32_bwd_kernel<true><<<grid, THREADS, 0, st>>>(
        gf, yf, wf, out, n, h, wd, cin, cout, kspan);
  else
    conv3x3_f32_bwd_kernel<false><<<grid, THREADS, 0, st>>>(
        gf, yf, wf, out, n, h, wd, cin, cout, kspan);
  int err = (int)cudaGetLastError();
  if (err || path != 2) return err;
  const long long total = (long long)n * h * wd * cout;
  const int blocks = (int)std::min<long long>((total + 255) / 256, 4096);
  sum_splits_kernel<<<blocks, 256, 0, st>>>((const float*)parts, (float*)dx,
                                            total, splits);
  return (int)cudaGetLastError();
}
