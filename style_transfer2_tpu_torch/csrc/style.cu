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

#include <cuda_runtime.h>
#include <cstddef>
#include <cstdint>

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
// (n_tiles * T * T * ways / RED_THREADS, lanes).
constexpr int RED_THREADS = 256;

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
  gram_style += (size_t)blockIdx.y * c * c;
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
  gdiff[(size_t)gi * c + gj] = g - gram_style[(size_t)gi * c + gj];
  if (ti != tj)
    gdiff[(size_t)gj * c + gi] = g - gram_style[(size_t)gj * c + gi];
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
  if (c % 4 != 0 || ((uintptr_t)x | (uintptr_t)gdiff) % 16 != 0 ||
      (grad_rows != 64 && grad_rows != 32) || lanes < 1 || lanes > 65535 ||
      (int64_t)lanes * (m > c ? m : c) > INT32_MAX)
    return -1;
  cudaStream_t st = (cudaStream_t)stream;
  const int nt = (c + T - 1) / T;
  const int n_tiles = nt * (nt + 1) / 2;
  gram_partials_kernel<<<dim3(n_tiles, n_chunks, lanes), THREADS, 0, st>>>(
      x, partials, m, c, nt, chunk);
  int err = (int)cudaGetLastError();
  if (err) return err;
  int ways = 1;
  while (ways < 32 && ways * 64 <= n_chunks) ways *= 2;
  gram_diff_kernel<<<dim3(n_tiles * T * T * ways / RED_THREADS, lanes),
                     RED_THREADS, 0, st>>>(partials, gram_style, gdiff, c,
                                           nt, n_tiles, n_chunks, ways,
                                           inv_size);
  err = (int)cudaGetLastError();
  if (err) return err;
  const dim3 grid((m + grad_rows - 1) / grad_rows, nt, lanes);
  if (grad_rows == 64)
    style_grad_kernel<8><<<grid, THREADS, 0, st>>>(x, gdiff, sgrad, m, c,
                                                   grad_scale);
  else
    style_grad_kernel<4><<<grid, THREADS, 0, st>>>(x, gdiff, sgrad, m, c,
                                                   grad_scale);
  return (int)cudaGetLastError();
}
