// Sum of squares with float32 products and sums, for Hopper (sm_90a).
//
// Replaces no TPU kernel: it is the JAX package's f32_sumsq
// (style_transfer2_tpu/engine/objective.py, the bf16 loss feed's reduction
// primitive), an einsum of a bf16 tensor with itself that XLA fuses into
// one pass with float32 accumulation. No single PyTorch call reads a bf16
// tensor with float32 products without first writing a float32 copy of it,
// and that copy is the pass the feed exists to remove.
//
// For x (lanes, n), bfloat16 or float32: out[z] = sum_i float(x[z, i])^2.
// Two launches on one stream, no atomics, so the order of every sum is
// fixed by (n, blocks) alone and a graph replay gives the eager call's
// bits:
//   (a) block b of lane z sums the squares of its range of `chunk`
//       elements (8 a thread a step, one 16-byte load where the lane's
//       rows are 16-byte aligned), then the block's sums by a fixed tree,
//       into partials[z, b];
//   (b) one block a lane sums its partials by the same fixed tree.
// What bounds it: bytes. It reads x once (2 bytes a value in bf16) and
// does two float32 operations a value; at 708M values (the conv1_1 tap of
// a 2880x3840 iterate) that is 0.42 ms at 3.35 TB/s. The design keeps
// enough 16-byte loads in flight (about 8 blocks of 256 threads an SM, the
// plan of ops/reduce.py) and nothing else.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int VEC = 8;   // values a thread reads a step (16 bytes of bf16)

__device__ __forceinline__ float sq(float v) { return v * v; }
__device__ __forceinline__ float sq(__nv_bfloat16 v) {
  const float f = __bfloat162float(v);
  return f * f;
}

// The squares of 8 values at p (16-byte aligned), summed in order.
__device__ __forceinline__ float sq8(const __nv_bfloat16* p) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    s += f.x * f.x;
    s += f.y * f.y;
  }
  return s;
}

__device__ __forceinline__ float sq8(const float* p) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  float s = 0.f;
  s += a.x * a.x; s += a.y * a.y; s += a.z * a.z; s += a.w * a.w;
  s += b.x * b.x; s += b.y * b.y; s += b.z * b.z; s += b.w * b.w;
  return s;
}

// The block's THREADS values summed by a fixed tree: a warp's by
// shuffles, then the 8 warps' in order by thread 0. Returns the sum in
// thread 0.
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float s_warp[THREADS / 32];
#pragma unroll
  for (int off = 16; off > 0; off /= 2)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  if (threadIdx.x % 32 == 0) s_warp[threadIdx.x / 32] = v;
  __syncthreads();
  float total = 0.f;
  if (threadIdx.x == 0)
    for (int i = 0; i < THREADS / 32; ++i) total += s_warp[i];
  return total;
}

// (a) Grid: (blocks, lanes). chunk is a multiple of VEC.
template <typename T>
__global__ void __launch_bounds__(THREADS)
sumsq_partials_kernel(const T* __restrict__ x, float* __restrict__ partials,
                      long long n, long long chunk) {
  const T* row = x + (size_t)blockIdx.y * n;
  const long long begin = (long long)blockIdx.x * chunk;
  const long long end = begin + chunk < n ? begin + chunk : n;
  float acc = 0.f;
  if (((uintptr_t)row % 16) == 0) {
    const long long full = begin + (end - begin) / VEC * VEC;
    for (long long i = begin + (long long)threadIdx.x * VEC; i < full;
         i += (long long)THREADS * VEC)
      acc += sq8(row + i);
    for (long long i = full + threadIdx.x; i < end; i += THREADS)
      acc += sq(row[i]);
  } else {
    for (long long i = begin + threadIdx.x; i < end; i += THREADS)
      acc += sq(row[i]);
  }
  const float total = block_sum(acc);
  if (threadIdx.x == 0)
    partials[(size_t)blockIdx.y * gridDim.x + blockIdx.x] = total;
}

// (b) Grid: (lanes).
__global__ void __launch_bounds__(THREADS)
sumsq_final_kernel(const float* __restrict__ partials,
                   float* __restrict__ out, int blocks) {
  const float* p = partials + (size_t)blockIdx.x * blocks;
  float acc = 0.f;
  for (int i = threadIdx.x; i < blocks; i += THREADS) acc += p[i];
  const float total = block_sum(acc);
  if (threadIdx.x == 0) out[blockIdx.x] = total;
}

}  // namespace

// x: (lanes, n) contiguous, bfloat16 where is_bf16 is nonzero, else
// float32; partials: (lanes, blocks) float32 scratch; out: (lanes,)
// float32. chunk * blocks >= n, chunk a multiple of 8. Returns the first
// nonzero cudaGetLastError() of the two launches, or -1 for arguments the
// kernels do not take.
extern "C" int st2_sumsq(const void* x, float* partials, float* out,
                         long long n, long long chunk, int blocks, int lanes,
                         int is_bf16, void* stream) {
  if (n < 1 || chunk < 1 || chunk % VEC != 0 || blocks < 1 ||
      blocks > 65535 || lanes < 1 || lanes > 65535 ||
      chunk * blocks < n)
    return -1;
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid(blocks, lanes);
  if (is_bf16)
    sumsq_partials_kernel<__nv_bfloat16><<<grid, THREADS, 0, st>>>(
        (const __nv_bfloat16*)x, partials, n, chunk);
  else
    sumsq_partials_kernel<float><<<grid, THREADS, 0, st>>>(
        (const float*)x, partials, n, chunk);
  const int err = (int)cudaGetLastError();
  if (err) return err;
  sumsq_final_kernel<<<lanes, THREADS, 0, st>>>(partials, out, blocks);
  return (int)cudaGetLastError();
}
