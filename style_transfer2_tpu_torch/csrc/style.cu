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
//   (a) split-M Gram: block (i, j, s) computes the 64 x 64 tile (i, j) of
//       X_s^T X_s over its M-chunk s and writes it to a partials buffer;
//   (b) a fixed-order reduction over the chunks, whose epilogue applies
//       * inv_size - G_style and writes G_diff. Partials rather than atomics
//       keep the result identical from run to run;
//   (c) s_grad = X G_diff with * 2/(C^2 size) in the epilogue.
// The ragged M edge (and any C that is not a multiple of 64) is masked, so
// M is never padded.
//
// What bounds it on this card: at the 512px style layers the two products
// are ~1 GMAC each and X is read twice (M*C*4 bytes, 12..50 MB), so the
// branch is FP32-FMA bound with launch (b) a small memory pass. Each block
// computes a 64 x 64 output tile, 16 x 16 threads with 4 x 4 accumulators
// each, from 16-deep operand slices staged in shared memory. Plain FP32
// FMA, never TF32.

#include <cuda_runtime.h>
#include <cstddef>

namespace {

constexpr int T = 64;        // output tile edge
constexpr int KD = 16;       // reduction depth staged per pass
constexpr int THREADS = 256; // 16 x 16, 4 x 4 outputs each

__device__ __forceinline__ void tile_fma(float (&acc)[4][4],
                                         const float* a_row,
                                         const float* b_row) {
  const float4 a = *reinterpret_cast<const float4*>(a_row);
  const float4 bv = *reinterpret_cast<const float4*>(b_row);
  const float av[4] = {a.x, a.y, a.z, a.w};
  const float bw[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bw[j], acc[i][j]);
}

// (a) partials[s, i, j] = sum over rows m of chunk s of X[m, i] X[m, j].
// Grid: (ceil(C/T), ceil(C/T), n_chunks).
__global__ void __launch_bounds__(THREADS)
gram_partials_kernel(const float* __restrict__ x,
                     float* __restrict__ partials, int m, int c,
                     int chunk) {
  __shared__ __align__(16) float s_a[KD][T];
  __shared__ __align__(16) float s_b[KD][T];
  const int i0 = blockIdx.x * T;
  const int j0 = blockIdx.y * T;
  const int m_begin = blockIdx.z * chunk;
  const int m_end = min(m_begin + chunk, m);
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  float acc[4][4] = {};

  for (int r0 = m_begin; r0 < m_end; r0 += KD) {
    for (int e = threadIdx.x; e < KD * T; e += THREADS) {
      const int kk = e / T;
      const int col = e % T;
      const int row = r0 + kk;
      const bool in_row = row < m_end;
      const size_t base = (size_t)row * c;
      s_a[kk][col] = (in_row && i0 + col < c) ? x[base + i0 + col] : 0.f;
      s_b[kk][col] = (in_row && j0 + col < c) ? x[base + j0 + col] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < KD; ++kk)
      tile_fma(acc, &s_a[kk][ty * 4], &s_b[kk][tx * 4]);
    __syncthreads();
  }

  float* dst = partials + (size_t)blockIdx.z * c * c;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gi = i0 + ty * 4 + i;
    if (gi >= c) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gj = j0 + tx * 4 + j;
      if (gj < c) dst[(size_t)gi * c + gj] = acc[i][j];
    }
  }
}

// (b) gdiff = (sum_s partials[s]) * inv_size - gram_style, summed in chunk
// order.
__global__ void gram_diff_kernel(const float* __restrict__ partials,
                                 const float* __restrict__ gram_style,
                                 float* __restrict__ gdiff, int cc,
                                 int n_chunks, float inv_size) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= cc) return;
  float sum = 0.f;
  for (int s = 0; s < n_chunks; ++s) sum += partials[(size_t)s * cc + e];
  gdiff[e] = sum * inv_size - gram_style[e];
}

// (c) sgrad[m, j] = scale * sum_k X[m, k] gdiff[k, j].
// Grid: (ceil(M/T), ceil(C/T)).
__global__ void __launch_bounds__(THREADS)
style_grad_kernel(const float* __restrict__ x,
                  const float* __restrict__ gdiff, float* __restrict__ sgrad,
                  int m, int c, float scale) {
  // s_a[k][row] holds X transposed; the +4 pad spreads the transposing
  // stores over the banks and keeps rows 16-byte aligned.
  __shared__ __align__(16) float s_a[KD][T + 4];
  __shared__ __align__(16) float s_b[KD][T];
  const int r0 = blockIdx.x * T;
  const int j0 = blockIdx.y * T;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  float acc[4][4] = {};

  for (int k0 = 0; k0 < c; k0 += KD) {
    for (int e = threadIdx.x; e < KD * T; e += THREADS) {
      const int kk = e % KD;     // consecutive threads: consecutive k
      const int row = e / KD;
      const int gr = r0 + row;
      const int gk = k0 + kk;
      s_a[kk][row] = (gr < m && gk < c) ? x[(size_t)gr * c + gk] : 0.f;
    }
    for (int e = threadIdx.x; e < KD * T; e += THREADS) {
      const int kk = e / T;
      const int col = e % T;
      const int gk = k0 + kk;
      s_b[kk][col] =
          (gk < c && j0 + col < c) ? gdiff[(size_t)gk * c + j0 + col] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < KD; ++kk)
      tile_fma(acc, &s_a[kk][ty * 4], &s_b[kk][tx * 4]);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gr = r0 + ty * 4 + i;
    if (gr >= m) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gj = j0 + tx * 4 + j;
      if (gj < c) sgrad[(size_t)gr * c + gj] = acc[i][j] * scale;
    }
  }
}

}  // namespace

// x: (m, c) float32; gram_style, gdiff: (c, c); partials: (n_chunks, c, c)
// scratch; sgrad: (m, c). chunk * n_chunks >= m, chunk a multiple of 16.
// Returns the first nonzero cudaGetLastError() of the three launches.
extern "C" int st2_style_branch(const float* x, const float* gram_style,
                                float* partials, float* gdiff, float* sgrad,
                                int m, int c, int chunk, int n_chunks,
                                float inv_size, float grad_scale,
                                void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int tiles = (c + T - 1) / T;
  gram_partials_kernel<<<dim3(tiles, tiles, n_chunks), THREADS, 0, st>>>(
      x, partials, m, c, chunk);
  int err = (int)cudaGetLastError();
  if (err) return err;
  const int cc = c * c;
  gram_diff_kernel<<<(cc + 255) / 256, 256, 0, st>>>(
      partials, gram_style, gdiff, cc, n_chunks, inv_size);
  err = (int)cudaGetLastError();
  if (err) return err;
  style_grad_kernel<<<dim3((m + T - 1) / T, tiles), THREADS, 0, st>>>(
      x, gdiff, sgrad, m, c, grad_scale);
  return (int)cudaGetLastError();
}
