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
// far above the memory roofline. Every kernel keeps a block's operands on
// chip: a block owns a pixel tile by a block of output channels and stages
// its input tile with a 1-pixel halo in BOTH H and W (the TPU kernel tiled
// whole rows only because of Mosaic's block-shape rules) plus the matching
// weight slice in shared memory, a few input channels at a time. The halo,
// the SAME zero padding, odd H and W, Cin = 3 and Cout not a multiple of the
// channel block are masks on load and store.
//
//   float32:  FP32 FMA, never TF32, so the float32 mode stays exact; bound
//             by the FMA issue rate (67 TFLOP/s peak). The forward takes
//             one of three paths, chosen by shape (ops/conv.py:fwd_plan):
//     tile:   Cin and Cout multiples of 4, 16-byte aligned operands. A
//             block owns 16x16 pixels by 64 channels and each thread 8
//             pixels x 8 channels, 64 accumulators; input and weights are
//             staged 16 bytes at a time by cp.async into a two-stage ring,
//             so the next channel slice is in flight while the current one
//             is multiplied, and the outputs leave as 16-byte stores of 4
//             channels.
//     split:  the same kernel where its grid would end in a wave that
//             leaves much of the card idle (it holds one block per SM at
//             254-255 registers a thread): the input channels are split
//             across blocks into partial sums, which a second pass adds in
//             split order before it adds the bias and applies the ReLU (no
//             atomics: two calls give the same bits).
//     scalar: every other shape (conv1_1: Cin = 3) and unaligned views:
//             8x16 pixels by 64 channels, 8 pixels x 4 channels a thread,
//             staged one element at a time.
//             The split planners are held to the card by `python -m
//             style_transfer2_tpu_torch.split_sweep` (every split count of
//             each forward and backward shape beside the planned one; its
//             --fit scores the planners' constants on that output).
//   bfloat16: two kernels, chosen by shape (ops/conv.py: fwd_plan,
//             bwd_plan).
//     wgmma, wgmma_split: conv3x3_wgmma.cu, for Cin and Cout multiples of
//             8 and 16-byte aligned operands: Hopper's warpgroup MMAs fed
//             by a 4-stage ring (the weights by bulk copies, the halo tile
//             by cp.async), 16 x 16 pixels by 128 channels a block, and the
//             input channels split across blocks where the grid would
//             leave the card idle. Its note says what bounds it and what
//             the design does about that.
//     tile:   the mma.sync kernel below, for every other shape (conv1_1's
//             Cin = 3; Cin or Cout not a multiple of 8) and unaligned
//             views: mma.sync
//             m16n8k16 (bf16 operands, f32 accumulation, one rounding on
//             store), 32 input channels staged per pass, 16 bytes at a time
//             where the channels come in eights and the pointers are 16-byte
//             aligned, else one element at a time; each warp owns two
//             16-pixel rows of an 8 x 16 tile by 64 channels and reads its A
//             fragments straight from the staged halo tile with ldmatrix.
//             Its staging is unpipelined (a barrier on each side of every
//             slice), which held it to 17-23% of its bound at the deep
//             layers; conv1_1's forward (3 input channels) is bound by
//             memory and latency there, and beats cuDNN.
//
// The backward takes one of three paths, chosen by shape
// (ops/conv.py:bwd_plan), because the 8x16-by-64 tile loses to cuDNN at two
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
// current one is multiplied (the mask rules out the forward's cp.async:
// the staged values are not the loaded bytes).

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

// Forward, the scalar path. x: (N, H, W, Cin); w: (3, 3, Cin, Cout); b:
// (Cout,); out: (N, H, W, Cout). Grid: (ceil(H/TH) * ceil(W/TW),
// ceil(Cout/TC), N).
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

// ------------------------------------------------ float32 forward, vector

// The forward's tile and split paths (Cin and Cout multiples of 4, 16-byte
// aligned operands). A block owns FTH x FTW pixels by FTC output channels,
// and each of its 256 threads 8 consecutive pixels of one row by 8
// channels (co0 + 4*cg .. +3 and co0 + 32 + 4*cg .. +3, so that eight
// neighbouring lanes read 128 contiguous bytes of a staged weight row): 64
// accumulators, each staged weight used by 8 pixels and each staged input
// by 8 channels times 3 horizontal taps. Per pass FK input channels of the
// halo tile and of the 9 weight taps are copied 16 bytes at a time with
// cp.async into a two-stage ring, so the next slice is in flight while the
// current one is multiplied, one barrier a pass. Input pixels are staged
// channel-minor, so a thread reads 4 channels of a pixel in one 16-byte
// load. ptxas gives the kernel 254-255 registers and no spills, so one
// block runs per SM; held to 128 registers for two it spills and runs
// 1.3-1.9x slower, and 8 x 16 pixels by 128 channels (as many outputs a
// block) ran 1-2% slower at the deep shapes on an H100.
constexpr int FK = 8;           // input channels staged per pass
constexpr int FTH = 16;         // output rows per block
constexpr int FTW = 16;         // output columns per block
constexpr int FTC = 64;         // output channels per block
constexpr int FCG = FTC / 8;    // threads across the channels
static_assert(THREADS / FCG * 8 == FTH * FTW, "threads tile the pixels");
constexpr int FHALO = (FTH + 2) * (FTW + 2);   // staged pixels
constexpr int F_IN = FHALO * FK;               // floats a stage: input
constexpr int F_W = 9 * FK * FTC;              // floats a stage: weights
constexpr int FSTAGES = 2;
constexpr int FWD_SMEM = FSTAGES * (F_IN + F_W) * (int)sizeof(float);
constexpr int F_IN_COPIES = (F_IN / 4 + THREADS - 1) / THREADS;
constexpr int F_W_COPIES = (F_W / 4 + THREADS - 1) / THREADS;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  const uint32_t dst = (uint32_t)__cvta_generic_to_shared(smem);
  const int n = pred ? 16 : 0;   // 0: no read, 16 zero bytes written
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__device__ __forceinline__ float lane4(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

__device__ __forceinline__ float4 bias_relu4(float4 a, float4 b) {
  return make_float4(fmaxf(a.x + b.x, 0.f), fmaxf(a.y + b.y, 0.f),
                     fmaxf(a.z + b.z, 0.f), fmaxf(a.w + b.w, 0.f));
}

// x: (N, H, W, Cin); w: (3, 3, Cin, Cout); b: (Cout,); out: (S, N, H, W,
// Cout). Split s of S sums the input channels [s * kspan, min(Cin, (s + 1)
// * kspan)) (kspan a multiple of FK). raw: out[s] gets the bare partial
// sums (the split path; sum_splits_bias_relu_kernel finishes them);
// otherwise (S = 1) ReLU(sum + b), the tile path. Grid: (ceil(H/FTH) *
// ceil(W/FTW), ceil(Cout/FTC), N * S); dynamic shared memory FWD_SMEM.
__global__ void __launch_bounds__(THREADS)
conv3x3_f32_fwd_kernel(const float* __restrict__ x,
                       const float* __restrict__ w,
                       const float* __restrict__ b, float* __restrict__ out,
                       int N, int H, int W, int Cin, int Cout, int kspan,
                       bool raw) {
  extern __shared__ __align__(16) float fwd_smem[];

  const int tiles_w = (W + FTW - 1) / FTW;
  const int h0 = (blockIdx.x / tiles_w) * FTH;
  const int w0 = (blockIdx.x % tiles_w) * FTW;
  const int co0 = blockIdx.y * FTC;
  const int n = blockIdx.z % N;
  const int split = blockIdx.z / N;
  const int kbeg = split * kspan;
  const int kend = min(Cin, kbeg + kspan);
  const size_t img = (size_t)n * H * W;
  const int tid = threadIdx.x;
  const int cg = tid % FCG;
  const int pg = tid / FCG;
  const int pr = pg >> 1;
  const int pc = (pg & 1) * 8;

  // Stage `st` <- channels [k0, k0 + FK): the halo tile as [pixel][FK]
  // and the weights as [tap][FK][FTC]. Out-of-image pixels, channels at or
  // past kend and output channels past Cout are zero-filled (no read).
  auto stage = [&](int st, int k0) {
    float* s_in = fwd_smem + st * (F_IN + F_W);
    float* s_w = s_in + F_IN;
#pragma unroll
    for (int it = 0; it < F_IN_COPIES; ++it) {
      const int i = tid + it * THREADS;
      if (i >= F_IN / 4) break;
      const int q = i % (FK / 4);
      const int pix = i / (FK / 4);
      const int gh = h0 + pix / (FTW + 2) - 1;
      const int gw = w0 + pix % (FTW + 2) - 1;
      const int gk = k0 + 4 * q;
      const bool ok = gh >= 0 && gh < H && gw >= 0 && gw < W && gk < kend;
      cp_async16(s_in + 4 * i,
                 ok ? x + (img + (size_t)gh * W + gw) * Cin + gk : x, ok);
    }
#pragma unroll
    for (int it = 0; it < F_W_COPIES; ++it) {
      const int i = tid + it * THREADS;
      if (i >= F_W / 4) break;
      const int q = i % (FTC / 4);
      const int k = (i / (FTC / 4)) % FK;
      const int tap = i / (FTC / 4 * FK);
      const int gk = k0 + k;
      const int gco = co0 + 4 * q;
      const bool ok = gk < kend && gco < Cout;
      cp_async16(s_w + 4 * i,
                 ok ? w + ((size_t)tap * Cin + gk) * Cout + gco : w, ok);
    }
    cp_async_commit();
  };

  float acc[8][8];
#pragma unroll
  for (int p = 0; p < 8; ++p)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[p][j] = 0.f;

  const int passes = (kend - kbeg + FK - 1) / FK;
  if (passes > 0) stage(0, kbeg);
  for (int it = 0; it < passes; ++it) {
    // This pass's copies have landed for every thread, and every thread
    // is done with the stage the next copies overwrite.
    cp_async_wait<0>();
    __syncthreads();
    if (it + 1 < passes) stage((it + 1) % FSTAGES, kbeg + (it + 1) * FK);
    const float* s_in = fwd_smem + (it % FSTAGES) * (F_IN + F_W);
    const float* s_w = s_in + F_IN;
#pragma unroll
    for (int kq = 0; kq < FK / 4; ++kq) {
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        // 10 pixels of the halo row by 4 channels: the 8 outputs' three
        // horizontal taps.
        const float* src = s_in + ((pr + dy) * (FTW + 2) + pc) * FK + 4 * kq;
        float4 xv[10];
#pragma unroll
        for (int j = 0; j < 10; ++j)
          xv[j] = *reinterpret_cast<const float4*>(src + j * FK);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
          for (int dx = 0; dx < 3; ++dx) {
            const float* wr =
                s_w + ((dy * 3 + dx) * FK + 4 * kq + kk) * FTC + 4 * cg;
            const float4 wa = *reinterpret_cast<const float4*>(wr);
            const float4 wb = *reinterpret_cast<const float4*>(wr + FTC / 2);
#pragma unroll
            for (int p = 0; p < 8; ++p) {
              const float xs = lane4(xv[p + dx], kk);
              acc[p][0] = fmaf(xs, wa.x, acc[p][0]);
              acc[p][1] = fmaf(xs, wa.y, acc[p][1]);
              acc[p][2] = fmaf(xs, wa.z, acc[p][2]);
              acc[p][3] = fmaf(xs, wa.w, acc[p][3]);
              acc[p][4] = fmaf(xs, wb.x, acc[p][4]);
              acc[p][5] = fmaf(xs, wb.y, acc[p][5]);
              acc[p][6] = fmaf(xs, wb.z, acc[p][6]);
              acc[p][7] = fmaf(xs, wb.w, acc[p][7]);
            }
          }
        }
      }
    }
  }

  // 16-byte stores of 4 consecutive channels (Cout is a multiple of 4, so
  // a group lies wholly inside or outside it).
  const int gh = h0 + pr;
  if (gh >= H) return;
  const int c_lo = co0 + 4 * cg;
  const int c_hi = c_lo + FTC / 2;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 b_lo = zero, b_hi = zero;
  if (!raw) {
    if (c_lo < Cout) b_lo = *reinterpret_cast<const float4*>(b + c_lo);
    if (c_hi < Cout) b_hi = *reinterpret_cast<const float4*>(b + c_hi);
  }
  float* dst = out + (size_t)split * N * H * W * Cout;
#pragma unroll
  for (int p = 0; p < 8; ++p) {
    const int gw = w0 + pc + p;
    if (gw >= W) break;
    float* o = dst + (img + (size_t)gh * W + gw) * Cout;
    const float4 lo = make_float4(acc[p][0], acc[p][1], acc[p][2], acc[p][3]);
    const float4 hi = make_float4(acc[p][4], acc[p][5], acc[p][6], acc[p][7]);
    if (c_lo < Cout)
      *reinterpret_cast<float4*>(o + c_lo) = raw ? lo : bias_relu4(lo, b_lo);
    if (c_hi < Cout)
      *reinterpret_cast<float4*>(o + c_hi) = raw ? hi : bias_relu4(hi, b_hi);
  }
}

// y = ReLU(sum over s of parts[s] + b), the partials summed in split order
// and the bias added after the whole sum. parts: (S, n4) float4s of
// consecutive channels; b: (cout4,) float4s.
__global__ void sum_splits_bias_relu_kernel(const float4* __restrict__ parts,
                                            const float4* __restrict__ b,
                                            float4* __restrict__ y,
                                            long long n4, int cout4,
                                            int splits) {
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       e < n4; e += (long long)gridDim.x * blockDim.x) {
    float4 v = parts[e];
    for (int s = 1; s < splits; ++s) {
      const float4 p = parts[s * n4 + e];
      v.x += p.x;
      v.y += p.y;
      v.z += p.z;
      v.w += p.w;
    }
    y[e] = bias_relu4(v, b[e % cout4]);
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
// VEC_IN (Cin a multiple of 8, x and y 16-byte aligned): the input tile is
// staged 16 bytes at a time; VEC_OUT (Cout a multiple of 8, w 16-byte
// aligned): so are the weight rows, and the store writes channel pairs.
// Otherwise (conv1_1: Cin = 3 forward; an unaligned view) that side goes
// element by element.
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

// VEC_IN where the channels come in eights and x (and y) are 16-byte
// aligned, VEC_OUT where Cout does and w is 16-byte and out 4-byte aligned:
// a view into a larger tensor may start at any element.
template <bool BWD>
int launch_bf16_any(const dim3& grid, cudaStream_t st, const void* x,
                    const void* y, const void* w, const void* b, void* out,
                    int h, int wd, int cin, int cout) {
  const bool vin = cin % 8 == 0 &&
                   ((uintptr_t)x | (uintptr_t)(BWD ? y : x)) % 16 == 0;
  const bool vout = cout % 8 == 0 && (uintptr_t)w % 16 == 0 &&
                    (uintptr_t)out % 4 == 0;
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

// conv3x3_wgmma.cu: the bfloat16 wgmma kernel, unsplit or split.
int conv3x3_bf16_wgmma(bool bwd, const void* x, const void* y,
                       const void* w, const void* b, void* out, void* parts,
                       int n, int h, int wd, int cin, int cout, int splits,
                       int kspan, cudaStream_t st);

// x: (n, h, wd, cin); w: (3, 3, cin, cout); b: (cout,); y: (n, h, wd,
// cout). dtype: 0 = float32, 1 = bfloat16. path (ops/conv.py:fwd_plan):
// 0 = the tile kernel (bfloat16: mma.sync, any shape and alignment;
// float32 with cin and cout multiples of 4 and every pointer 16-byte
// aligned); 2 = the float32 tile kernel split over `splits` ranges of
// kspan input channels into parts (splits, n, h, wd, cout), then summed in
// split order, the bias added and the ReLU applied into y (the same
// conditions); 3 = the float32 scalar kernel, any shape and alignment;
// 4 = the bfloat16 wgmma kernel (cin and cout multiples of 8, 16-byte
// aligned operands, w blocked by ops/conv.py:wgmma_weights); 5 = the same
// split like path 2, its float32 partials in parts. Returns the first
// nonzero cudaGetLastError(), or -1 for a path, dtype or shape the kernels
// do not take.
extern "C" int st2_conv3x3_fwd(int dtype, int path, const void* x,
                               const void* w, const void* b, void* y,
                               void* parts, int n, int h, int wd, int cin,
                               int cout, int splits, int kspan,
                               void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 1 && path == 0)
    return launch_bf16_any<false>(tile_grid(n, h, wd, cout), st, x, nullptr,
                                  w, b, y, h, wd, cin, cout);
  if (dtype == 1 && (path == 4 || path == 5))
    return conv3x3_bf16_wgmma(false, x, nullptr, w, b, y, parts, n, h, wd,
                              cin, cout, path == 4 ? 1 : splits, kspan, st);
  if (dtype != 0) return -1;
  if (path == 3) {
    conv3x3_f32_kernel<<<tile_grid(n, h, wd, cout), THREADS, 0, st>>>(
        (const float*)x, (const float*)w, (const float*)b, (float*)y, h, wd,
        cin, cout);
    return (int)cudaGetLastError();
  }
  const uintptr_t addr = (uintptr_t)x | (uintptr_t)w | (uintptr_t)b |
                         (uintptr_t)y | (uintptr_t)parts;
  if (cin % 4 != 0 || cout % 4 != 0 || addr % 16 != 0) return -1;
  if (path == 0) {
    splits = 1;
    kspan = cin;
  } else if (path != 2 || splits < 2 || kspan % FK != 0 ||
             (long long)(splits - 1) * kspan >= cin ||
             (long long)splits * kspan < cin) {
    return -1;
  }
  const bool raw = path == 2;
  float* out = raw ? (float*)parts : (float*)y;
  // Above 48 KB, dynamic shared memory must be allowed explicitly, once.
  static const cudaError_t attr = cudaFuncSetAttribute(
      conv3x3_f32_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      FWD_SMEM);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid(((h + FTH - 1) / FTH) * ((wd + FTW - 1) / FTW),
                  (cout + FTC - 1) / FTC, n * splits);
  conv3x3_f32_fwd_kernel<<<grid, THREADS, FWD_SMEM, st>>>(
      (const float*)x, (const float*)w, (const float*)b, out, n, h, wd, cin,
      cout, kspan, raw);
  const int err = (int)cudaGetLastError();
  if (err || !raw) return err;
  const long long n4 = (long long)n * h * wd * cout / 4;
  const int blocks = (int)std::min<long long>((n4 + 255) / 256, 4096);
  sum_splits_bias_relu_kernel<<<blocks, 256, 0, st>>>(
      (const float4*)parts, (const float4*)b, (float4*)y, n4, cout / 4,
      splits);
  return (int)cudaGetLastError();
}

// g, y: (n, h, wd, cin) cotangent and forward output; wt: (3, 3, cin, cout)
// the flipped, in/out-transposed forward weights; dx: (n, h, wd, cout).
// path (ops/conv.py:bwd_plan): 0 = the tile kernel (float32 or bfloat16);
// 1 = the narrow kernel (float32 or bfloat16; cout <= 8, cin a multiple
// of 4); 2 = the float32 tile kernel split over `splits` ranges of kspan
// cotangent channels into parts (splits, n, h, wd, cout), then summed in
// split order into dx; 4 and 5 = the bfloat16 wgmma kernel, unsplit and
// split, as in st2_conv3x3_fwd (wt blocked likewise). Returns the first
// nonzero cudaGetLastError(), or -1 for a path, dtype or shape the kernels
// do not take.
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
  if (dtype == 1 && (path == 4 || path == 5))
    return conv3x3_bf16_wgmma(true, g, y, wt, nullptr, dx, parts, n, h, wd,
                              cin, cout, path == 4 ? 1 : splits, kspan, st);
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
