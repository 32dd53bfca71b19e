// Fused style-loss branch for Hopper (sm_90a).
//
// Replaces style_transfer2_tpu/ops/pallas/style_kernel.py:
// fused_style_branch (_style_kernel through _fused_padded). For one style
// layer's feature map X (M x C, float32, M = h*w) and its target Gram
// G_style (C x C):
//
//   G      = X^T X / size                    size = M*C
//   G_diff = G - G_style
//   s_grad = X G_diff * 2 / (C^2 * size)
//
// The TPU kernel carried the C x C accumulator across a sequential grid in
// VMEM. On Hopper blocks run in parallel, and a 512 x 512 float32 Gram
// (1 MB) does not fit in one SM, so the branch is three launches on one
// stream:
//   (a) split-M Gram over the upper triangle: block (t, s) computes the
//       64 x 64 tile t = (i, j), i <= j, of X_s^T X_s over its M-chunk s
//       and writes it to a partials buffer. G is symmetric, so the tiles
//       below the diagonal are never computed (36 of 64 tiles at C = 512);
//   (b) a fixed-order reduction over the chunks, whose epilogue writes
//       G * inv_size - G_style at (i, j) and, off the diagonal, at (j, i),
//       each element minus its own G_style entry (G_style need not be
//       exactly symmetric). Partials rather than atomics keep the result
//       identical from run to run. It stays a launch of its own: folded
//       into (a), the last block of a tile would sum all of that tile's
//       partials alone, one SM reading 16 MB at C = 64; here up to 32
//       chunk ways per element share the sum, in a fixed order;
//   (c) s_grad = X G_diff with * 2/(C^2 size) in the epilogue, on 64-row
//       tiles, or 32-row tiles where M is too short to fill the card.
// The ragged M edge (and any C that is not a multiple of 64) is masked, so
// M is never padded; C must be a multiple of 4 and X 16-byte aligned (the
// wrapper sees to both). The split and the tile rows come from the card's
// SM count (ops/style.py: gram_plan, grad_tile_rows).
//
// Lanes: the batched engine runs B independent jobs, and each style layer
// has B feature maps and B target Grams, stacked lane-major. Every launch
// takes the lane in its last grid dimension (z for (a) and (c), y for (b)),
// and each lane reads and writes only its own slices of x, G_style, the
// partials, G_diff and s_grad, in the same fixed order as a lone map: no
// sum runs across lanes, so each lane's bits do not depend on the others.
// (a) and (c) index the lanes' stacked rows rather than offset a pointer,
// which would spill (a) at its register cap.
// One lane launches the grids it always did.
//
// What bounds it on this card: the FP32 FMA rate. At the 512px taps the two
// products need M*C*(C+1) (the symmetric Gram's upper triangle) plus
// 2*M*C^2, about 2.4 GFLOP (36 us at 67 TFLOP/s), against up to 30 us of
// memory traffic (X read and s_grad written once), and the 768x1024 taps
// are 4x that. So the design is an FP32 SIMT GEMM pair: 64 threads a
// block, each with an 8 x 8 accumulator
// (64 FMAs per four 16-byte shared-memory reads), operands staged 16 rows
// deep with cp.async 16-byte copies into a two-stage ring so the next
// slice loads while this one is multiplied, and about 8 blocks resident
// per SM (register caps through __launch_bounds__) to hide the rest. Both
// products read rows of X that are contiguous in C: the Gram stages them
// as they are, and the gradient product keeps X's row-major order in
// shared memory and reads four k at a time along each row (a broadcast
// within the warp), so X is never transposed. Plain FP32 FMA, never TF32.
// PERF.md gives the share of that bound it reaches at each tap.
//
// bfloat16 taps (the JAX package's bf16 loss feed, engine/objective.py:
// the Gram and the gradient product as two einsums over the bf16 tap, the
// Gram accumulated in float32 and the gradient emitted in bf16) take two
// kernels of their own, one a phase, on Hopper's warpgroup tensor cores
// (wgmma.mma_async from shared memory, csrc/wgmma.cuh):
//   (a'') gram_bf16_kernel: the split-M Gram, X bf16, float32 sums, into
//         the float32 partials that (b) reduces as it always did;
//   (c'') style_grad_bf16_kernel: X (M x C, bf16) times D (C x C, float32
//         rounded to bf16 as it is staged, as the JAX feed's
//         gram_diff.astype(bf16) rounds; or D already bf16), float32
//         accumulation, one rounding of each output to bf16. No scale: the
//         feed folds every factor into D or into one scalar multiply.
// What bounds them: bytes. At the 512px taps the Gram reads X (47 MB over
// the four taps, 14 us at 3.35 TB/s) and the product reads X and writes
// its bf16 product (28 us), against 2.4 GFLOP (2.4 us at 989 TFLOP/s);
// only the product at C = 512 comes near the card's ridge (256 FLOP a
// byte against about 295), so there the tensor cores' rate counts too.
// The design, for this card's memory:
//   * Persistent, one 256-thread block (two warpgroups) an SM. X arrives
//     by the TMA engine: one thread keeps a ring of 4-8 stages filled two
//     to six stages ahead of the MMAs, each stage boxes of 64 channels
//     (128 bytes) by 64-256 rows that complete on the stage's mbarrier,
//     zero-filled past M and C by the tensor map (encoded on the host at
//     each call). A first version staged X by 16-byte cp.async from every
//     thread: on an H100 it ran as fast without its MMAs as with them and
//     2.4-9x faster without its copies, about 8 bytes a cycle an SM.
//   * The boxes land in the 128-byte swizzle that wgmma reads: the Gram
//     takes both operands MN-major from the same boxes (A = X^T, B = X);
//     the product takes X K-major and D N-major from its panel.
//   * The Gram: the channels fall in blocks of BN (64 where C <= 64, else
//     128) and an item is the BN x BN block (I, J), I <= J, of G; each
//     block of the grid walks one long chunk of rows of one item, the plan
//     (ops/style.py _bf16_plan) sizing the chunks so that items x chunks x
//     lanes fill the card once: at most an SM's worth of partial tiles a
//     tile, against 512 chunks of 384 rows at 512px's conv1_1 in the
//     mma.sync kernel this replaced. At BN = 128 warpgroup w owns the 64
//     rows of i-block 2 I + w, so X's rows are read 4 times at C = 512
//     (the 64 x 128 items of a first version read them 6.5 times); at BN =
//     64 the two warpgroups take alternate k-steps, added once at the end
//     (0's + 1's). A partial's bits depend on nothing but the chunk; (b)
//     then sums the chunks in its fixed order.
//   * The product: a block keeps one column panel of D (C x BN) resident
//     and walks a contiguous range of the lanes' 128-row slabs, and the
//     panels of a slab run at once on neighbouring blocks, so X comes from
//     device memory once (at 2880x3840 the mma.sync kernel's grid re-read
//     conv2_1's to conv4_1's X 2-8 times). A slab's product is rounded in
//     shared memory and leaves in 16-byte stores of whole rows.
// C must be a multiple of 8 (every bf16 tap of VGG-19 is one of 64), at
// most 512 for the product (D's panel stays resident); the ragged M edge
// and a C that is not a multiple of the blocks are masked. No atomics: two
// calls give the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstddef>
#include <cstdint>

#include "wgmma.cuh"

namespace {

constexpr int T = 64;        // output tile edge
constexpr int KD = 16;       // reduction depth of one pipeline stage
constexpr int THREADS = 64;  // 8 x 8 threads, 8 x 8 outputs each
constexpr int STAGES = 2;
// Resident blocks per SM the GEMM kernels are compiled for: 8 blocks of 2
// warps cap the Gram at 128 registers a thread; the gradient product holds
// 32 more live values (X's rows four k deep) and spills below 168, so it
// is compiled for 6.
constexpr int MIN_BLOCKS = 8;
constexpr int GRAD_MIN_BLOCKS = 6;
// 16-byte copies per thread for one operand's stage (KD x T floats).
constexpr int COPIES = KD * T / 4 / THREADS;
static_assert(COPIES * THREADS * 4 == KD * T, "stage must split evenly");

// 16-byte asynchronous copy global -> shared; zero-fills when !pred.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  const uint32_t dst = (uint32_t)__cvta_generic_to_shared(smem);
  const int n = pred ? 16 : 0;
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

// A thread's 8 rows (or columns) of a 64-wide tile: 4*q .. 4*q + 3 and
// 32 + 4*q .. 32 + 4*q + 3. Eight neighbouring lanes then read 128
// contiguous bytes of a staged row, which no two of them share a bank in.
__device__ __forceinline__ int lane8(int q, int i) {
  return (i < 4 ? 4 * q : 28 + 4 * q) + i;
}

__device__ __forceinline__ void load8(float (&v)[8], const float* row,
                                      int q) {
  const float4 lo = *reinterpret_cast<const float4*>(row + 4 * q);
  const float4 hi = *reinterpret_cast<const float4*>(row + 32 + 4 * q);
  v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
  v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
}

__device__ __forceinline__ void outer8(float (&acc)[8][8],
                                       const float (&a)[8],
                                       const float (&b)[8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
}

// Upper-triangle tile t (row-major over i <= j) of an nt x nt tile grid.
__device__ __forceinline__ void tile_of(int t, int nt, int& i, int& j) {
  i = 0;
  while (t >= nt - i) {
    t -= nt - i;
    ++i;
  }
  j = i + t;
}

// (a) partials[s, t] = sum over rows m of chunk s of X[m, i-tile]^T
// X[m, j-tile]. Grid: (n_tiles, n_chunks, lanes).
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
gram_partials_kernel(const float* __restrict__ x,
                     float* __restrict__ partials, int m, int c, int nt,
                     int chunk) {
  __shared__ __align__(16) float s_a[STAGES][KD][T];
  __shared__ __align__(16) float s_b[STAGES][KD][T];
  int ti, tj;
  tile_of(blockIdx.x, nt, ti, tj);
  const bool diag = ti == tj;
  const int i0 = ti * T;
  const int j0 = tj * T;
  // The lanes' maps are one (lanes * m, c) matrix, lane z owning rows
  // z*m .. z*m + m - 1: the lane moves the chunk's row range, and no
  // pointer is offset (a live 64-bit offset spills at this kernel's cap).
  const int m_begin = blockIdx.z * m + blockIdx.y * chunk;
  const int m_end = min(m_begin + chunk, (int)(blockIdx.z + 1) * m);
  const int tid = threadIdx.x;
  const int tx = tid % 8;
  const int ty = tid / 8;

  // One stage: KD rows x 16 float4 of each operand; a diagonal tile's two
  // operands are the same columns, staged once.
  auto stage = [&](int st, int r0) {
#pragma unroll
    for (int it = 0; it < COPIES; ++it) {
      const int e = tid + it * THREADS;
      const int kk = e / (T / 4);
      const int q = e % (T / 4);
      const int row = r0 + kk;
      const bool in_row = row < m_end;
      const float* src = x + (size_t)(in_row ? row : m_begin) * c;
      const int ca = i0 + 4 * q;
      cp_async16(&s_a[st][kk][4 * q], src + (ca < c ? ca : 0),
                 in_row && ca < c);
      if (!diag) {
        const int cb = j0 + 4 * q;
        cp_async16(&s_b[st][kk][4 * q], src + (cb < c ? cb : 0),
                   in_row && cb < c);
      }
    }
    cp_async_commit();
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const int n_k = (m_end - m_begin + KD - 1) / KD;
  stage(0, m_begin);
  for (int kt = 0; kt < n_k; ++kt) {
    if (kt + 1 < n_k) {
      stage((kt + 1) % STAGES, m_begin + (kt + 1) * KD);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int st = kt % STAGES;
    const float(*sb)[T] = diag ? s_a[st] : s_b[st];
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      float a[8], b[8];
      load8(a, s_a[st][kk], ty);
      load8(b, sb[kk], tx);
      outer8(acc, a, b);
    }
    __syncthreads();
  }

  float* dst = partials + (((size_t)blockIdx.z * gridDim.y + blockIdx.y) *
                                gridDim.x + blockIdx.x) * T * T;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float* row = dst + lane8(ty, i) * T;
    *reinterpret_cast<float4*>(row + 4 * tx) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    *reinterpret_cast<float4*>(row + 32 + 4 * tx) =
        make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
  }
}

// (b) G = sum_s partials[s, t]; gdiff = G * inv_size - gram_style at
// (i, j) and its mirror (j, i). A block of RED_THREADS takes RED_THREADS /
// ways consecutive elements of the upper tiles (coalesced reads) by `ways`
// chunk ways (a power of two, about 32 chunks a way): way y sums the
// chunks y, y + ways, ..., then ways 0 .. ways-1 are added in that order,
// so the order of every sum is fixed by n_chunks alone. Grid:
// (n_tiles * T * T * ways / RED_THREADS, lanes). TARGET false writes the
// Gram itself (gram_style unread): a shard's phase-1 partial Gram under
// spatial sharding. A template argument, so that the fused branch's
// instance is the code it always was, bit for bit (a run-time test of the
// target changed the fused branch's results on an H100).
constexpr int RED_THREADS = 256;

template <bool TARGET>
__global__ void __launch_bounds__(RED_THREADS)
gram_diff_kernel(const float* __restrict__ partials,
                 const float* __restrict__ gram_style,
                 float* __restrict__ gdiff, int c, int nt, int n_tiles,
                 int n_chunks, int ways, float inv_size) {
  __shared__ float s_sum[RED_THREADS];
  const int width = RED_THREADS / ways;
  const int x = threadIdx.x % width;
  const int way = threadIdx.x / width;
  const int e = blockIdx.x * width + x;   // n_tiles * T * T is a multiple
  const size_t stride = (size_t)n_tiles * T * T;
  partials += (size_t)blockIdx.y * n_chunks * stride;
  if (TARGET) gram_style += (size_t)blockIdx.y * c * c;
  gdiff += (size_t)blockIdx.y * c * c;
  float sum = 0.f;
#pragma unroll 4
  for (int s = way; s < n_chunks; s += ways)
    sum += partials[s * stride + e];
  s_sum[threadIdx.x] = sum;
  __syncthreads();
  if (way != 0) return;
  float total = s_sum[x];
  for (int y = 1; y < ways; ++y) total += s_sum[y * width + x];
  int ti, tj;
  tile_of(e / (T * T), nt, ti, tj);
  const int gi = ti * T + (e % (T * T)) / T;
  const int gj = tj * T + e % T;
  if (gi >= c || gj >= c) return;
  const float g = total * inv_size;
  if (TARGET) {
    gdiff[(size_t)gi * c + gj] = g - gram_style[(size_t)gi * c + gj];
    if (ti != tj)
      gdiff[(size_t)gj * c + gi] = g - gram_style[(size_t)gj * c + gi];
  } else {
    gdiff[(size_t)gi * c + gj] = g;
    if (ti != tj) gdiff[(size_t)gj * c + gi] = g;
  }
}

// (c) sgrad[m, j] = scale * sum_k X[m, k] gdiff[k, j]. RT rows per thread:
// 8 (a 64-row tile, thread rows as lane8) or 4 (a 32-row tile, rows
// 4*ty .. 4*ty + 3), the latter for a short M whose 64-row grid would
// leave the card half empty. Grid: (ceil(M/(8*RT)), ceil(C/T), lanes).
template <int RT>
__global__ void __launch_bounds__(THREADS, GRAD_MIN_BLOCKS)
style_grad_kernel(const float* __restrict__ x,
                  const float* __restrict__ gdiff, float* __restrict__ sgrad,
                  int m, int c, float scale) {
  constexpr int TM = 8 * RT;
  constexpr int A_COPIES = TM * KD / 4 / THREADS;
  static_assert(A_COPIES * THREADS * 4 == TM * KD, "stage splits evenly");
  __shared__ __align__(16) float s_a[STAGES][TM][KD];  // X rows as they are
  __shared__ __align__(16) float s_b[STAGES][KD][T];   // gdiff rows
  // Rows of x and sgrad, and of gdiff, are the lanes' stacked: lane z
  // owns rows z*m .. z*m + m - 1 of x and sgrad, z*c .. z*c + c - 1 of
  // gdiff (no pointer is offset, as in the Gram).
  const int r0 = blockIdx.z * m + blockIdx.x * TM;
  const int r_end = (blockIdx.z + 1) * m;
  const int j0 = blockIdx.y * T;
  const int tid = threadIdx.x;
  const int tx = tid % 8;
  const int ty = tid / 8;

  auto stage = [&](int st, int k0) {
#pragma unroll
    for (int it = 0; it < A_COPIES; ++it) {
      const int e = tid + it * THREADS;
      const int row = e / (KD / 4);
      const int q = e % (KD / 4);
      const int gr = r0 + row;
      const int gk = k0 + 4 * q;
      const bool ok = gr < r_end && gk < c;
      cp_async16(&s_a[st][row][4 * q],
                 x + (ok ? (size_t)gr * c + gk : 0), ok);
    }
#pragma unroll
    for (int it = 0; it < COPIES; ++it) {
      const int e = tid + it * THREADS;
      const int kk = e / (T / 4);
      const int q = e % (T / 4);
      const int gk = k0 + kk;
      const int gj = j0 + 4 * q;
      const bool ok = gk < c && gj < c;
      cp_async16(&s_b[st][kk][4 * q],
                 gdiff + (ok ? (size_t)(blockIdx.z * c + gk) * c + gj : 0),
                 ok);
    }
    cp_async_commit();
  };
  auto row_of = [&](int i) { return RT == 8 ? lane8(ty, i) : 4 * ty + i; };

  float acc[RT][8];
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const int n_k = (c + KD - 1) / KD;
  stage(0, 0);
  for (int kt = 0; kt < n_k; ++kt) {
    if (kt + 1 < n_k) {
      stage((kt + 1) % STAGES, (kt + 1) * KD);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int st = kt % STAGES;
#pragma unroll
    for (int k4 = 0; k4 < KD; k4 += 4) {
      // X[row, k4 .. k4 + 3] for the thread's rows: one 16-byte read
      // each, the same address across the 8 lanes of a row group.
      float4 xa[RT];
#pragma unroll
      for (int i = 0; i < RT; ++i)
        xa[i] = *reinterpret_cast<const float4*>(&s_a[st][row_of(i)][k4]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        float b[8];
        load8(b, s_b[st][k4 + kk], tx);
#pragma unroll
        for (int i = 0; i < RT; ++i) {
          const float a = kk == 0 ? xa[i].x : kk == 1 ? xa[i].y
                        : kk == 2 ? xa[i].z : xa[i].w;
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a, b[j], acc[i][j]);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int gr = r0 + row_of(i);
    if (gr >= r_end) continue;
    float* row = sgrad + (size_t)gr * c;
    const int ja = j0 + 4 * tx;
    const int jb = j0 + 32 + 4 * tx;
    if (ja < c)
      *reinterpret_cast<float4*>(row + ja) =
          make_float4(acc[i][0] * scale, acc[i][1] * scale,
                      acc[i][2] * scale, acc[i][3] * scale);
    if (jb < c)
      *reinterpret_cast<float4*>(row + jb) =
          make_float4(acc[i][4] * scale, acc[i][5] * scale,
                      acc[i][6] * scale, acc[i][7] * scale);
  }
}

// (b) over the float32 partials of (a) or (a'), launched on `st`.
int reduce_gram(const float* partials, const float* gram_style, float* gdiff,
                int c, int n_chunks, int lanes, float inv_size,
                cudaStream_t st) {
  const int nt = (c + T - 1) / T;
  const int n_tiles = nt * (nt + 1) / 2;
  int ways = 1;
  while (ways < 32 && ways * 64 <= n_chunks) ways *= 2;
  const dim3 grid(n_tiles * T * T * ways / RED_THREADS, lanes);
  if (gram_style)
    gram_diff_kernel<true><<<grid, RED_THREADS, 0, st>>>(
        partials, gram_style, gdiff, c, nt, n_tiles, n_chunks, ways,
        inv_size);
  else
    gram_diff_kernel<false><<<grid, RED_THREADS, 0, st>>>(
        partials, gram_style, gdiff, c, nt, n_tiles, n_chunks, ways,
        inv_size);
  return (int)cudaGetLastError();
}

// The two halves of the branch, launched on `st`: (a) and (b), the Gram
// difference (or, with no target, the Gram itself), and (c), the gradient
// product. Each returns the first nonzero cudaGetLastError() of its
// launches.
int launch_gram(const float* x, const float* gram_style, float* partials,
                float* gdiff, int m, int c, int chunk, int n_chunks,
                int lanes, float inv_size, cudaStream_t st) {
  const int nt = (c + T - 1) / T;
  const int n_tiles = nt * (nt + 1) / 2;
  gram_partials_kernel<<<dim3(n_tiles, n_chunks, lanes), THREADS, 0, st>>>(
      x, partials, m, c, nt, chunk);
  const int err = (int)cudaGetLastError();
  if (err) return err;
  return reduce_gram(partials, gram_style, gdiff, c, n_chunks, lanes,
                     inv_size, st);
}

int launch_grad(const float* x, const float* gdiff, float* sgrad, int m,
                int c, int grad_rows, int lanes, float grad_scale,
                cudaStream_t st) {
  const int nt = (c + T - 1) / T;
  const dim3 grid((m + grad_rows - 1) / grad_rows, nt, lanes);
  if (grad_rows == 64)
    style_grad_kernel<8><<<grid, THREADS, 0, st>>>(x, gdiff, sgrad, m, c,
                                                   grad_scale);
  else
    style_grad_kernel<4><<<grid, THREADS, 0, st>>>(x, gdiff, sgrad, m, c,
                                                   grad_scale);
  return (int)cudaGetLastError();
}

bool bad_args(const float* x, const float* gdiff, int m, int c, int lanes) {
  return c % 4 != 0 || ((uintptr_t)x | (uintptr_t)gdiff) % 16 != 0 ||
         lanes < 1 || lanes > 65535 ||
         (int64_t)lanes * (m > c ? m : c) > INT32_MAX;
}

}  // namespace

// x: (lanes, m, c) float32, 16-byte aligned, c a multiple of 4, lanes * m
// and lanes * c below 2^31 (the kernels index the lanes' stacked rows);
// gram_style, gdiff: (lanes, c, c); partials: (lanes, n_chunks, n_tiles,
// 64, 64) scratch with n_tiles = nt (nt + 1) / 2, nt = ceil(c / 64); sgrad:
// (lanes, m, c). chunk * n_chunks >= m, chunk a multiple of 16; grad_rows:
// the gradient product's tile rows, 64 or 32. Returns the first nonzero
// cudaGetLastError() of the three launches, or -1 for arguments the
// kernels do not take.
extern "C" int st2_style_branch(const float* x, const float* gram_style,
                                float* partials, float* gdiff, float* sgrad,
                                int m, int c, int chunk, int n_chunks,
                                int grad_rows, int lanes, float inv_size,
                                float grad_scale, void* stream) {
  if (bad_args(x, gdiff, m, c, lanes) || (grad_rows != 64 && grad_rows != 32))
    return -1;
  cudaStream_t st = (cudaStream_t)stream;
  const int err = launch_gram(x, gram_style, partials, gdiff, m, c, chunk,
                              n_chunks, lanes, inv_size, st);
  if (err) return err;
  return launch_grad(x, gdiff, sgrad, m, c, grad_rows, lanes, grad_scale,
                     st);
}

// Spatial sharding splits the branch at the sum over M, which crosses the
// shards (ops/style.py style_branch_sharded). Phase 1, on each shard's
// rows: gdiff = X^T X * inv_size - gram_style, with inv_size 1 / the WHOLE
// map's size, and gram_style null for no target (each shard's partial
// Gram; the caller sums them over the shards and subtracts G_style once).
// Phase 2, on each shard's rows against the summed G_diff: sgrad = X
// G_diff * grad_scale. Arguments as st2_style_branch's; the same kernels
// and the same fixed orders, so each phase's bits are those of the fused
// branch's half over the same rows.
extern "C" int st2_style_gram(const float* x, const float* gram_style,
                              float* partials, float* gdiff, int m, int c,
                              int chunk, int n_chunks, int lanes,
                              float inv_size, void* stream) {
  if (bad_args(x, gdiff, m, c, lanes)) return -1;
  return launch_gram(x, gram_style, partials, gdiff, m, c, chunk, n_chunks,
                     lanes, inv_size, (cudaStream_t)stream);
}

extern "C" int st2_style_grad(const float* x, const float* gdiff,
                              float* sgrad, int m, int c, int grad_rows,
                              int lanes, float grad_scale, void* stream) {
  if (bad_args(x, gdiff, m, c, lanes) || (grad_rows != 64 && grad_rows != 32))
    return -1;
  return launch_grad(x, gdiff, sgrad, m, c, grad_rows, lanes, grad_scale,
                     (cudaStream_t)stream);
}

// ------------------------------------------------------------- bfloat16

namespace {

namespace hp = hopper;
using bf16 = __nv_bfloat16;

constexpr int WG = 128;               // threads of a warpgroup
constexpr int BF_THREADS = 2 * WG;    // two warpgroups a block
constexpr int SMEM_MAX = 232448;      // a block's dynamic shared memory
constexpr int BOX_W = 64;             // channels of a TMA box: 128 bytes
constexpr int ALIGN = 1024;           // a 128-byte swizzle atom repeats

// The tensor map of x (lanes, m, c) bf16 for boxes of 64 channels by
// `rows` rows of one lane, swizzled by 128 bytes as wgmma reads them;
// rows past m and channels past c arrive as zeros.
int x_map(CUtensorMap* map, const void* x, int m, int c, int lanes,
          int rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)c, (cuuint64_t)m,
                              (cuuint64_t)lanes};
  const cuuint64_t strides[2] = {(cuuint64_t)c * 2, (cuuint64_t)m * c * 2};
  const cuuint32_t box[3] = {BOX_W, (cuuint32_t)rows, 1};
  const cuuint32_t steps[3] = {1, 1, 1};
  return hp::encode_tiled(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                          const_cast<void*>(x), dims, strides, box, steps,
                          CU_TENSOR_MAP_SWIZZLE_128B);
}

// (a'') The Gram. Its channels fall in blocks of BN (64 where C <= 64,
// else 128), and an item is the BN x BN block (I, J), I <= J, of G: at BN
// = 128 warpgroup w computes the 64 rows of i-block 2 I + w over all the
// item's rows of X; at BN = 64 (one item) the two warpgroups split each
// stage's k-steps instead. A stage is ROWS rows of the item's channels as
// TMA boxes of 64 channels (block I's, then block J's off the diagonal).
// At C = 512 the rows of X are read 4 times over the 10 items, once at C
// = 128.
template <int BN>
struct GramCfg {
  static constexpr bool SPLIT_K = BN == 64;
  static constexpr int ROWS = BN == 64 ? 256 : 64;    // a stage's rows
  static constexpr int STAGES = 6;
  static constexpr int BOX = ROWS * 128;              // bytes of a box
  // k-steps of 16 rows a warpgroup takes from a stage.
  static constexpr int KSTEPS = ROWS / 16 / (SPLIT_K ? 2 : 1);
  static constexpr int FLUSH = 128 / KSTEPS;          // stages a run
};

__host__ __device__ __forceinline__ int gram_bn(int c) {
  return c <= 64 ? 64 : 128;
}

// Boxes of the largest stage: blocks I's and J's where some item lies off
// the diagonal (iff c > BN), else block I's.
__host__ __device__ __forceinline__ int gram_boxes(int c) {
  const int per_block = gram_bn(c) / BOX_W;
  return c > gram_bn(c) ? 2 * per_block : per_block;
}

int gram_items(int c) {
  const int nb = (c + gram_bn(c) - 1) / gram_bn(c);
  return nb * (nb + 1) / 2;
}

int gram_rows(int c) {
  return gram_bn(c) == 64 ? GramCfg<64>::ROWS : GramCfg<128>::ROWS;
}

// Dynamic shared memory of the Gram kernel at c: the ring of the largest
// stage and its mbarriers, or the two warpgroups' float32 sums after it,
// whichever is larger, and room to align the ring to 1024 bytes.
// ops/style.py _bf16_plan mirrors this.
int gram_smem(int c) {
  const int ring = GramCfg<64>::STAGES *
                   (gram_boxes(c) * gram_rows(c) * 128 + 8);
  const int sums = 2 * 64 * (gram_bn(c) + 8) * 4;
  return (ring > sums ? ring : sums) + ALIGN;
}

// partials[z, s, t] for the 64 x 64 tiles t of item blockIdx.y that lie
// on or above the diagonal: the sum over the rows of chunk s = blockIdx.x
// of lane z = blockIdx.z of X[m, i-tile]^T X[m, j-tile], in the layout
// (b) reduces. One thread keeps the ring's TMA loads STAGES - 2 stages
// ahead, each stage's boxes completing on its mbarrier. Both operands are
// read MN-major from the swizzled boxes: A (X^T, 64 channels i by 16 rows)
// and B (X, 16 rows by BN channels j). Each warpgroup sums into float32
// accumulators in runs of 2048 rows, each run added into its running
// total; at BN = 64 the block adds the two warpgroups' totals (0's + 1's)
// once at the end. One partial a block and tile, in a fixed order.
template <int BN>
__global__ void __launch_bounds__(BF_THREADS, 1)
gram_bf16_kernel(const __grid_constant__ CUtensorMap map,
                 float* __restrict__ partials, int m, int c, int chunk) {
  using Cfg = GramCfg<BN>;
  constexpr int AHEAD = Cfg::STAGES - 2;
  constexpr int PER_BLOCK = BN / BOX_W;
  extern __shared__ __align__(ALIGN) unsigned char smem[];
  const uint32_t raw = hp::smem_u32(smem);
  const uint32_t ring = (raw + ALIGN - 1) & ~(uint32_t)(ALIGN - 1);
  const int nt = (c + 63) / 64;
  const int nb = (c + BN - 1) / BN;
  int bi = 0;                   // item blockIdx.y: (bi, bj), row-major
  int t = blockIdx.y;
  while (t >= nb - bi) {
    t -= nb - bi;
    ++bi;
  }
  const int bj = bi + t;
  const bool diag = bi == bj;
  const int boxes = diag ? PER_BLOCK : 2 * PER_BLOCK;
  const int stage_bytes = boxes * Cfg::BOX;
  const int z = blockIdx.z;
  const int r_begin = blockIdx.x * chunk;
  const int r_end = min(r_begin + chunk, m);
  const int n_k = (r_end - r_begin + Cfg::ROWS - 1) / Cfg::ROWS;
  const int tid = threadIdx.x;
  const int wg = tid / WG;
  const int a_box = Cfg::SPLIT_K ? 0 : wg;
  const int b_box = diag ? 0 : PER_BLOCK;
  const uint32_t bars = ring + Cfg::STAGES * gram_boxes(c) * Cfg::BOX;
  if (tid == 0) {
    for (int s = 0; s < Cfg::STAGES; ++s) hp::mbar_init(bars + 8 * s, 1);
    hp::fence_mbar_init();
  }
  __syncthreads();

  // Stage st <- rows r0 .. r0 + ROWS - 1 of the item's channels (thread 0).
  auto stage = [&](int st, int r0) {
    const uint32_t dst = ring + st * stage_bytes;
    const uint32_t bar = bars + 8 * st;
    hp::mbar_expect(bar, stage_bytes);
    for (int b = 0; b < boxes; ++b)
      hp::tma_load_3d(dst + b * Cfg::BOX, &map,
                      (b < PER_BLOCK ? bi * BN : bj * BN - BN) + BOX_W * b,
                      r0, z, bar);
  };

  // The tensor cores sum into acc for FLUSH stages at a time, each run
  // then added into total in float32: a chunk of 2880x3840's conv1_1 is
  // about 84 000 rows, and one running sum over all of them strayed 1.1e-4
  // from float64 on an H100.
  float acc[BN / 2], total[BN / 2];
#pragma unroll
  for (int j = 0; j < BN / 2; ++j) total[j] = 0.f;
  if (tid == 0)
    for (int s = 0; s < AHEAD && s < n_k; ++s)
      stage(s, r_begin + s * Cfg::ROWS);
  int it = 0;
  for (int run = 0; run < n_k; run += Cfg::FLUSH) {
    const int run_end = min(run + Cfg::FLUSH, n_k);
    for (; it < run_end; ++it) {
      // The loads run AHEAD stages ahead of the MMAs, and one stage's
      // MMAs stay in flight while the next stage's are issued: the stage
      // a load overwrites was read by MMAs two stages back, which every
      // thread has waited for before the barrier that precedes the load.
      const int st = it % Cfg::STAGES;
      hp::mbar_wait(bars + 8 * st, (it / Cfg::STAGES) & 1);
      __syncthreads();
      const uint32_t base = ring + st * stage_bytes;
      hp::wgmma_fence();
#pragma unroll
      for (int h = 0; h < Cfg::KSTEPS; ++h) {
        // k-step ks: rows 16 ks .. 16 ks + 15, 2048 bytes into each box;
        // 8-row groups 1024 bytes apart (SBO), boxes (64 channels) BOX
        // apart (LBO). A run's first MMA starts acc afresh.
        const int ks = Cfg::SPLIT_K ? 2 * h + wg : h;
        const uint64_t da = hp::smem_desc_sw128(
            base + a_box * Cfg::BOX + ks * 2048, Cfg::BOX, 1024);
        const uint64_t db = hp::smem_desc_sw128(
            base + b_box * Cfg::BOX + ks * 2048, Cfg::BOX, 1024);
        hp::wgmma_ss<BN, 1>(acc, da, db, h > 0 || it > run);
      }
      hp::wgmma_commit();
      const int next = it + AHEAD;
      if (tid == 0 && next < n_k) stage(next % Cfg::STAGES,
                                        r_begin + next * Cfg::ROWS);
      hp::wgmma_wait<1>();
    }
    hp::wgmma_wait<0>();
#pragma unroll
    for (int j = 0; j < BN / 2; ++j) {
      hp::fence_operand(acc[j]);
      total[j] += acc[j];
    }
  }
  __syncthreads();              // every MMA and load is done: the ring is free

  // Accumulator j: row 16 wq + g (+ 8 where (j / 2) is odd), column
  // 8 (j / 4) + 2 t (+ 1 for odd j); each warpgroup's into its own sums.
  constexpr int P = BN + 8;     // floats a row of the sums
  float* sums = reinterpret_cast<float*>(smem + (ring - raw));
  const int wq = (tid % WG) / 32;
  const int g = (tid % 32) / 4;
  const int t4 = tid % 4;
  float* mine = sums + wg * 64 * P;
#pragma unroll
  for (int j = 0; j < BN / 2; j += 2) {
    const int r = 16 * wq + g + 8 * ((j / 2) % 2);
    const int col = 8 * (j / 4) + 2 * t4;
    *reinterpret_cast<float2*>(mine + r * P + col) =
        make_float2(total[j], total[j + 1]);
  }
  __syncthreads();
  const int n_tiles = nt * (nt + 1) / 2;
  // The item's 64 x 64 tiles (it, jt) on or above the diagonal: warpgroup
  // w's rows (it = 2 bi + w) at BN = 128, the two warpgroups' sum at 64.
#pragma unroll
  for (int w = 0; w < (Cfg::SPLIT_K ? 1 : 2); ++w) {
#pragma unroll
    for (int h = 0; h < PER_BLOCK; ++h) {
      const int ti = Cfg::SPLIT_K ? bi : PER_BLOCK * bi + w;
      const int tj = PER_BLOCK * bj + h;
      if (tj < ti || tj >= nt) continue;
      const int tile = ti * nt - ti * (ti - 1) / 2 + (tj - ti);
      float4* dst = reinterpret_cast<float4*>(
          partials + (((size_t)z * gridDim.x + blockIdx.x) * n_tiles + tile)
                         * T * T);
      const float* src = sums + w * 64 * P + 64 * h;
      for (int e = tid; e < T * T / 4; e += BF_THREADS) {
        const int r = e / (T / 4);
        const int q = e % (T / 4);
        float4 v = *reinterpret_cast<const float4*>(src + r * P + 4 * q);
        if (Cfg::SPLIT_K) {
          const float4 b = *reinterpret_cast<const float4*>(
              src + (64 + r) * P + 4 * q);
          v = make_float4(v.x + b.x, v.y + b.y, v.z + b.z, v.w + b.w);
        }
        dst[e] = v;
      }
    }
  }
}

// (c'') The gradient product. A slab is P_ROWS rows of one lane's X (an
// m64 tile a warpgroup); a slice is its next 64 channels, one TMA box.
constexpr int P_ROWS = 128;
constexpr int P_K = 64;
constexpr int P_SLICE = P_ROWS * 128;     // bytes of a slice
constexpr int D_BATCH = 8;                // D's pieces a thread loads at once

__host__ __device__ __forceinline__ int grad_bn(int c) {
  return c <= 64 ? 64 : 128;
}

__host__ __device__ __forceinline__ int grad_kpad(int c) {
  return (c + P_K - 1) / P_K * P_K;
}

// The ring's stages: as many as fit beside D's panel.
__host__ __device__ __forceinline__ int grad_stages(int c) {
  return grad_bn(c) == 64 ? 8 : grad_kpad(c) > 256 ? 4 : 6;
}

// Dynamic shared memory of the product at c: the ring, D's column panel
// (kpad x BN bf16), the bf16 output tile, the ring's mbarriers, and room
// to align the ring to 1024 bytes. ops/style.py _grad_bf16_plan mirrors
// this.
int grad_smem(int c) {
  const int bn = grad_bn(c);
  return grad_stages(c) * (P_SLICE + 8) + grad_kpad(c) * bn * 2 +
         P_ROWS * bn * 2 + ALIGN;
}

// out[z, m, j] = bf16(sum_k X[z, m, k] D[z, k, j]), float32 sums. Grid:
// `blocks` persistent blocks, a multiple of the panels = ceil(C / BN):
// block b keeps column panel b % panels of D resident (staged once, and
// again only where its slabs cross into another lane; rounded to bf16
// while staged where d_f32) and walks its group's contiguous range of
// the lanes' slabs (group b / panels), so the panels of a slab run at
// once on neighbouring blocks and X comes from device memory once. One
// thread keeps the ring's TMA loads STAGES - 2 slices ahead; A (X) is
// read K-major from the swizzled box, B (D) N-major from the panel. A
// slab's product is rounded into shared memory (16-byte pieces of a row
// placed by row % 8, so that the warps' writes spread over the banks) and
// leaves in 16-byte stores of whole rows.
template <int BN, int STAGES>
__global__ void __launch_bounds__(BF_THREADS, 1)
style_grad_bf16_kernel(const __grid_constant__ CUtensorMap map,
                       const void* __restrict__ d, bf16* __restrict__ out,
                       int m, int c, int lanes, int d_f32) {
  constexpr int AHEAD = STAGES - 2;
  extern __shared__ __align__(ALIGN) unsigned char smem[];
  const uint32_t raw = hp::smem_u32(smem);
  const uint32_t ring = (raw + ALIGN - 1) & ~(uint32_t)(ALIGN - 1);
  unsigned char* const base = smem + (ring - raw);
  const int kpad = grad_kpad(c);
  const int nks = kpad / P_K;
  const int panels = (c + BN - 1) / BN;
  const int panel = blockIdx.x % panels;
  const int groups = gridDim.x / panels;
  const int group = blockIdx.x / panels;
  const int slabs = (m + P_ROWS - 1) / P_ROWS;          // a lane's
  const long long total = (long long)lanes * slabs;
  const int q_begin = (int)(total * group / groups);
  const int q_end = (int)(total * (group + 1) / groups);
  const int n_it = (q_end - q_begin) * nks;
  const int j0 = panel * BN;
  const int tid = threadIdx.x;
  const int wg = tid / WG;
  const uint32_t s_d = ring + STAGES * P_SLICE;
  unsigned char* const s_dp = base + STAGES * P_SLICE;
  unsigned char* const s_out = s_dp + kpad * BN * 2;
  const uint32_t bars = s_d + kpad * BN * 2 + P_ROWS * BN * 2;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) hp::mbar_init(bars + 8 * s, 1);
    hp::fence_mbar_init();
  }
  __syncthreads();

  // Slice `it` of the block (thread 0): slab q_begin + it / nks, channels
  // from (it % nks) P_K, into ring stage st.
  auto stage = [&](int st, int it) {
    const int q = q_begin + it / nks;
    const uint32_t bar = bars + 8 * st;
    hp::mbar_expect(bar, P_SLICE);
    hp::tma_load_3d(ring + st * P_SLICE, &map, (it % nks) * P_K,
                    (q % slabs) * P_ROWS, q / slabs, bar);
  };

  // Lane z's column panel of D as [k / 8][n / 8] core matrices of 8 k-rows
  // by 8 channels (128 contiguous bytes; conv3x3_wgmma.cu's B layout),
  // zero past C. Each thread loads D_BATCH pieces before it stores any,
  // so that their reads are in flight together.
  auto stage_d = [&](int z) {
    constexpr int PIECES = BN / 8;        // 16-byte pieces of a panel row
    const int n = kpad * PIECES;
    auto at = [&](int e) {                // piece e's element, or -1
      const int k = e / PIECES;
      const int col = j0 + 8 * (e % PIECES);
      return e < n && k < c && col < c ? ((long long)z * c + k) * c + col
                                       : -1LL;
    };
    auto put = [&](int e, uint4 v) {
      if (e < n)
        *reinterpret_cast<uint4*>(s_dp + ((e / PIECES / 8) * PIECES +
                                          e % PIECES) * 128 +
                                  (e / PIECES % 8) * 16) = v;
    };
    for (int e0 = tid; e0 < n; e0 += D_BATCH * BF_THREADS) {
      if (d_f32) {
        float4 lo[D_BATCH], hi[D_BATCH];
#pragma unroll
        for (int u = 0; u < D_BATCH; ++u) {
          const long long a = at(e0 + u * BF_THREADS);
          const float4* src = reinterpret_cast<const float4*>(
              static_cast<const float*>(d) + (a < 0 ? 0 : a));
          lo[u] = a < 0 ? make_float4(0.f, 0.f, 0.f, 0.f) : src[0];
          hi[u] = a < 0 ? make_float4(0.f, 0.f, 0.f, 0.f) : src[1];
        }
#pragma unroll
        for (int u = 0; u < D_BATCH; ++u) {
          const __nv_bfloat162 p0 = __floats2bfloat162_rn(lo[u].x, lo[u].y);
          const __nv_bfloat162 p1 = __floats2bfloat162_rn(lo[u].z, lo[u].w);
          const __nv_bfloat162 p2 = __floats2bfloat162_rn(hi[u].x, hi[u].y);
          const __nv_bfloat162 p3 = __floats2bfloat162_rn(hi[u].z, hi[u].w);
          put(e0 + u * BF_THREADS,
              make_uint4(*reinterpret_cast<const uint32_t*>(&p0),
                         *reinterpret_cast<const uint32_t*>(&p1),
                         *reinterpret_cast<const uint32_t*>(&p2),
                         *reinterpret_cast<const uint32_t*>(&p3)));
        }
      } else {
        uint4 v[D_BATCH];
#pragma unroll
        for (int u = 0; u < D_BATCH; ++u) {
          const long long a = at(e0 + u * BF_THREADS);
          v[u] = a < 0 ? make_uint4(0u, 0u, 0u, 0u)
                       : *reinterpret_cast<const uint4*>(
                             static_cast<const bf16*>(d) + a);
        }
#pragma unroll
        for (int u = 0; u < D_BATCH; ++u) put(e0 + u * BF_THREADS, v[u]);
      }
    }
  };

  float acc[BN / 2];
  int lane_d = -1;                // the lane whose D panel is staged
  int it = 0;
  if (tid == 0)
    for (int s = 0; s < AHEAD && s < n_it; ++s) stage(s, s);
  for (int q = q_begin; q < q_end; ++q) {
    const int z = q / slabs;
    if (z != lane_d) {
      // Every MMA of the last slab has been waited for (its epilogue), so
      // D may be restaged; the fence hands the writes to wgmma.
      stage_d(z);
      lane_d = z;
      hp::fence_proxy_async();
    }
    for (int ks = 0; ks < nks; ++ks, ++it) {
      // The ring's order is the Gram's: loads AHEAD slices ahead, one
      // slice's MMAs in flight while the next slice's are issued.
      const int st = it % STAGES;
      hp::mbar_wait(bars + 8 * st, (it / STAGES) & 1);
      __syncthreads();
      // A (X, K-major): this warpgroup's 64 rows of the box, 8-row groups
      // 1024 bytes apart, k-steps 32 bytes apart inside the swizzle. B (D,
      // N-major): core matrices 128 bytes apart along N, BN * 16 along K.
      // The slab's first MMA starts its accumulators afresh.
      const uint32_t a_base = ring + st * P_SLICE + wg * 64 * 128;
      hp::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < P_K / 16; ++kk) {
        const uint64_t da = hp::smem_desc_sw128(a_base + 32 * kk, 16, 1024);
        const uint64_t db = hp::smem_desc(
            s_d + (ks * (P_K / 8) + 2 * kk) * (BN * 16), BN * 16, 128);
        hp::wgmma_ss<BN, 0>(acc, da, db, (ks | kk) != 0);
      }
      hp::wgmma_commit();
      const int next = it + AHEAD;
      if (tid == 0 && next < n_it) stage(next % STAGES, next);
      hp::wgmma_wait<1>();
    }
    hp::wgmma_wait<0>();
#pragma unroll
    for (int j = 0; j < BN / 2; ++j) hp::fence_operand(acc[j]);
    // Accumulator j: row 16 wq + g (+ 8), column 8 (j / 4) + 2 t (+ 1):
    // into 16-byte piece (j / 4) ^ (row % 8) of the row.
    const int wq = (tid % WG) / 32;
    const int g = (tid % 32) / 4;
    const int t = tid % 4;
#pragma unroll
    for (int j = 0; j < BN / 2; j += 2) {
      const int r = 64 * wg + 16 * wq + g + 8 * ((j / 2) % 2);
      *reinterpret_cast<__nv_bfloat162*>(
          s_out + r * (BN * 2) + ((j / 4) ^ (r % 8)) * 16 + 4 * t) =
          __floats2bfloat162_rn(acc[j], acc[j + 1]);
    }
    __syncthreads();
    const int r0 = (q % slabs) * P_ROWS;
    for (int e = tid; e < P_ROWS * (BN / 8); e += BF_THREADS) {
      const int r = e / (BN / 8);
      const int cb = e % (BN / 8);
      const int row = r0 + r;
      const int col = j0 + 8 * cb;
      if (row < m && col < c)
        *reinterpret_cast<uint4*>(out + ((size_t)z * m + row) * c + col) =
            *reinterpret_cast<const uint4*>(s_out + r * (BN * 2) +
                                            (cb ^ (r % 8)) * 16);
    }
  }
}

// Above 48 KB, dynamic shared memory must be allowed explicitly: once per
// kernel, at its first launch (the eager call before any capture).
template <typename K>
cudaError_t allow_smem(K kernel) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              SMEM_MAX);
}

template <int BN>
int launch_gram_bf16(const void* x, float* partials, int m, int c,
                     int chunk, int n_chunks, int lanes, cudaStream_t st) {
  static const cudaError_t attr = allow_smem(gram_bf16_kernel<BN>);
  if (attr != cudaSuccess) return (int)attr;
  CUtensorMap map;
  const int enc = x_map(&map, x, m, c, lanes, GramCfg<BN>::ROWS);
  if (enc) return enc;
  gram_bf16_kernel<BN><<<dim3(n_chunks, gram_items(c), lanes), BF_THREADS,
                         gram_smem(c), st>>>(map, partials, m, c, chunk);
  return (int)cudaGetLastError();
}

template <int BN, int STAGES>
int launch_grad_bf16(const void* x, const void* d, bf16* out, int m, int c,
                     int lanes, int blocks, int d_f32, cudaStream_t st) {
  static const cudaError_t attr =
      allow_smem(style_grad_bf16_kernel<BN, STAGES>);
  if (attr != cudaSuccess) return (int)attr;
  CUtensorMap map;
  const int enc = x_map(&map, x, m, c, lanes, P_ROWS);
  if (enc) return enc;
  style_grad_bf16_kernel<BN, STAGES><<<blocks, BF_THREADS, grad_smem(c),
                                       st>>>(map, d, out, m, c, lanes,
                                             d_f32);
  return (int)cudaGetLastError();
}

bool bad_bf16_args(const void* x, const void* d, int m, int c, int lanes) {
  return c % 8 != 0 || ((uintptr_t)x | (uintptr_t)d) % 16 != 0 ||
         lanes < 1 || lanes > 65535 || m < 1 ||
         (int64_t)lanes * (m > c ? m : c) > INT32_MAX;
}

}  // namespace

// The bf16 Gram phase: gdiff = X^T X * inv_size - gram_style, or with a
// null gram_style the Gram itself, float32, for x (lanes, m, c) bf16 with
// c a multiple of 8 and x 16-byte aligned; partials: (lanes, n_chunks,
// n_tiles, 64, 64) float32 as st2_style_branch's; chunk a multiple of the
// kernel's stage (256 rows where c <= 64, else 128), the n_chunks chunks
// covering m (ops/style.py _bf16_plan). (a'') then (b): the reduction, its
// fixed order and its epilogue are the float32 branch's.
extern "C" int st2_style_gram_bf16(const void* x, const float* gram_style,
                                   float* partials, float* gdiff, int m,
                                   int c, int chunk, int n_chunks, int lanes,
                                   float inv_size, void* stream) {
  if (bad_bf16_args(x, gdiff, m, c, lanes) || chunk < 1 ||
      chunk % gram_rows(c) != 0 || n_chunks < 1 ||
      (int64_t)chunk * n_chunks < m ||
      (int64_t)chunk * (n_chunks - 1) >= m || gram_items(c) > 65535)
    return -1;
  cudaStream_t st = (cudaStream_t)stream;
  const int err = gram_bn(c) == 64
      ? launch_gram_bf16<64>(x, partials, m, c, chunk, n_chunks, lanes, st)
      : launch_gram_bf16<128>(x, partials, m, c, chunk, n_chunks, lanes,
                              st);
  if (err) return err;
  return reduce_gram(partials, gram_style, gdiff, c, n_chunks, lanes,
                     inv_size, st);
}

// The bf16 gradient phase: sgrad = X D, x (lanes, m, c) bf16, d (lanes, c,
// c) float32 (d_f32 1: rounded to bf16 as it is staged, as
// d.to(torch.bfloat16) rounds) or bf16 (d_f32 0), sgrad (lanes, m, c)
// bf16; c a multiple of 8 up to 512, every pointer 16-byte aligned;
// blocks: the persistent grid, a multiple of ceil(c / BN) (ops/style.py
// _grad_bf16_plan).
extern "C" int st2_style_grad_bf16(const void* x, const void* d, void* sgrad,
                                   int m, int c, int lanes, int blocks,
                                   int d_f32, void* stream) {
  const int panels = (c + grad_bn(c) - 1) / grad_bn(c);
  if (bad_bf16_args(x, d, m, c, lanes) || (uintptr_t)sgrad % 16 != 0 ||
      c > 512 || blocks < panels || blocks % panels != 0)
    return -1;
  cudaStream_t st = (cudaStream_t)stream;
  bf16* ob = (bf16*)sgrad;
  if (grad_bn(c) == 64)
    return launch_grad_bf16<64, 8>(x, d, ob, m, c, lanes, blocks, d_f32, st);
  if (grad_stages(c) == 6)
    return launch_grad_bf16<128, 6>(x, d, ob, m, c, lanes, blocks, d_f32,
                                    st);
  return launch_grad_bf16<128, 4>(x, d, ob, m, c, lanes, blocks, d_f32, st);
}
