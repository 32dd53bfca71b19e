// The float32 loss feed's per-tap epilogue, for Hopper (sm_90a).
//
// Replaces no TPU kernel: in the JAX package XLA fuses a tapped layer's
// terms into the surrounding program. The plain version
// (ops/epilogue.py tap_epilogue_plain, the objective's float32 terms as
// PyTorch expressions) makes about a dozen full-size passes a tap after the
// style kernel: zeros, the scaled terms, their sum, the squares and means
// of the loss and the trace. Here one pass builds the layer's cotangent and
// the sums behind its loss and trace scalars.
//
// For a float32 tap f of n elements, its content target ct and the style
// kernel's s_grad sg, the weights w = (cw, sw, dw) and the 0-d norms and
// scale cn, ss = sw / sn, dn on the device, and kc = float(2 / n),
// kd = float(-2 / n), element by element (flags: 1 content, 2 style, 4
// deepdream):
//
//   tc = (cw * ((f - ct) * kc)) / cn
//   ts = ss * sg
//   td = (dw * (f * kd)) / dn
//   diff = ((0 + tc) + ts) + td        (the terms the flags name, in order)
//
// each an IEEE single operation rounded to nearest (the __f*_rn intrinsics,
// which the compiler never contracts into a fused multiply-add), in the
// plain version's order: diff is the plain version's bit for bit. The sums
// (out[k]: sum (f - ct)^2, sum tc^2, sum ts^2, sum f^2, sum td^2) feed only
// the loss and trace scalars, never the iterate. Each square and sum is
// taken in float64 and rounded to float32 once at the end, so the sums lie
// within an ulp or two of the exact ones (the plain version's float32
// reductions stray further), in a fixed order with no atomics, so that a
// graph replay gives the eager call's bits:
//   (a) block b takes elements [b * chunk, (b + 1) * chunk) (ops/reduce.py
//       sumsq_plan), 4 a thread a step with 16-byte accesses (every
//       pointer 16-byte aligned, a chunk's start too), then its tail one at
//       a time, writes diff, and sums each of the 5
//       by a fixed tree into partials[k, b];
//   (b) block k sums partials[k, :] by the same tree into out[k].
// What bounds it: bytes. A style tap reads s_grad and writes diff, 8 bytes
// an element; the content tap reads f and ct and writes diff, 12. The
// float64 work, at most 5 fused multiply-adds an element, stays far below
// the card's float64 rate at that traffic.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int SUMS = 5;
constexpr int HAS_C = 1, HAS_S = 2, HAS_D = 4;

struct Scalars {
  float cw, cn, ss, dw, dn, kc, kd;
};

__device__ __forceinline__ void add_sq(double& acc, float v) {
  acc = fma((double)v, (double)v, acc);
}

// One element: returns diff and adds to the 5 sums.
__device__ __forceinline__ float terms(int flags, const Scalars& s, float f,
                                       float ct, float sg, double (&acc)[5]) {
  float d = 0.f;
  if (flags & HAS_C) {
    const float cd = __fsub_rn(f, ct);
    const float t = __fdiv_rn(__fmul_rn(s.cw, __fmul_rn(cd, s.kc)), s.cn);
    d = __fadd_rn(d, t);
    add_sq(acc[0], cd);
    add_sq(acc[1], t);
  }
  if (flags & HAS_S) {
    const float t = __fmul_rn(s.ss, sg);
    d = __fadd_rn(d, t);
    add_sq(acc[2], t);
  }
  if (flags & HAS_D) {
    const float t = __fdiv_rn(__fmul_rn(s.dw, __fmul_rn(f, s.kd)), s.dn);
    d = __fadd_rn(d, t);
    add_sq(acc[3], f);
    add_sq(acc[4], t);
  }
  return d;
}

// The block's THREADS values of each of K sums by a fixed tree: a warp's
// by shuffles, then the 8 warps' in order by thread 0, which returns them
// in v.
template <int K>
__device__ __forceinline__ void block_sums(double (&v)[K]) {
  __shared__ double s_warp[K][THREADS / 32];
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int off = 16; off > 0; off /= 2)
      v[k] += __shfl_xor_sync(0xffffffffu, v[k], off);
    if (threadIdx.x % 32 == 0) s_warp[k][threadIdx.x / 32] = v[k];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      double total = 0.0;
      for (int i = 0; i < THREADS / 32; ++i) total += s_warp[k][i];
      v[k] = total;
    }
  }
}

// (a) Grid: (blocks). chunk is a multiple of 8.
__global__ void __launch_bounds__(THREADS)
tap_epilogue_kernel(const float* __restrict__ feat,
                    const float* __restrict__ content,
                    const float* __restrict__ sgrad,
                    const float* __restrict__ w, const float* __restrict__ cn,
                    const float* __restrict__ ss,
                    const float* __restrict__ dn, float* __restrict__ diff,
                    double* __restrict__ partials, long long n,
                    long long chunk, int flags, float kc, float kd) {
  Scalars s{0.f, 1.f, 0.f, 0.f, 1.f, kc, kd};
  if (flags & HAS_C) { s.cw = w[0]; s.cn = *cn; }
  if (flags & HAS_S) s.ss = *ss;
  if (flags & HAS_D) { s.dw = w[2]; s.dn = *dn; }
  const bool reads_f = flags & (HAS_C | HAS_D);
  const long long begin = (long long)blockIdx.x * chunk;
  const long long end = begin + chunk < n ? begin + chunk : n;
  double acc[SUMS] = {0.0, 0.0, 0.0, 0.0, 0.0};
  const long long full = begin + (end - begin) / 4 * 4;
  for (long long e = begin + 4LL * threadIdx.x; e < full;
       e += 4LL * THREADS) {
    float4 f = make_float4(0.f, 0.f, 0.f, 0.f), ct = f, sg = f;
    if (reads_f) f = *reinterpret_cast<const float4*>(feat + e);
    if (flags & HAS_C) ct = *reinterpret_cast<const float4*>(content + e);
    if (flags & HAS_S) sg = *reinterpret_cast<const float4*>(sgrad + e);
    float4 d;
    d.x = terms(flags, s, f.x, ct.x, sg.x, acc);
    d.y = terms(flags, s, f.y, ct.y, sg.y, acc);
    d.z = terms(flags, s, f.z, ct.z, sg.z, acc);
    d.w = terms(flags, s, f.w, ct.w, sg.w, acc);
    *reinterpret_cast<float4*>(diff + e) = d;
  }
  for (long long i = full + threadIdx.x; i < end; i += THREADS)
    diff[i] = terms(flags, s, reads_f ? feat[i] : 0.f,
                    flags & HAS_C ? content[i] : 0.f,
                    flags & HAS_S ? sgrad[i] : 0.f, acc);
  block_sums(acc);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < SUMS; ++k)
      partials[(size_t)k * gridDim.x + blockIdx.x] = acc[k];
  }
}

// (b) Grid: (5), a block a sum.
__global__ void __launch_bounds__(THREADS)
tap_sums_kernel(const double* __restrict__ partials,
                float* __restrict__ out, int blocks) {
  const double* p = partials + (size_t)blockIdx.x * blocks;
  double acc[1] = {0.0};
  for (int i = threadIdx.x; i < blocks; i += THREADS) acc[0] += p[i];
  block_sums(acc);
  if (threadIdx.x == 0) out[blockIdx.x] = (float)acc[0];
}

}  // namespace

// feat, content, sgrad, diff: n float32 values each (content only with
// flag 1, sgrad only with flag 2; feat with flag 1 or 4); w: the layer's
// (3,) float32 weights; cn, ss, dn: float32 scalars on the device (each
// only with its flag); partials: (5, blocks) float64 scratch; out: (5,)
// float32. chunk * blocks >= n, chunk a multiple of 8; the n-element
// arrays 16-byte aligned. Returns the first nonzero cudaGetLastError() of
// the two launches, or -1 for arguments the kernels do not take.
extern "C" int st2_tap_epilogue(const float* feat, const float* content,
                                const float* sgrad, const float* w,
                                const float* cn, const float* ss,
                                const float* dn, float* diff,
                                double* partials, float* out, long long n,
                                long long chunk, int blocks, int flags,
                                float kc, float kd, void* stream) {
  if (n < 1 || chunk < 1 || chunk % 8 != 0 || blocks < 1 ||
      blocks > 65535 || chunk * blocks < n || flags < 1 || flags > 7 ||
      ((flags & (HAS_C | HAS_D)) && (feat == nullptr || w == nullptr)) ||
      ((flags & HAS_C) && (content == nullptr || cn == nullptr)) ||
      ((flags & HAS_S) && (sgrad == nullptr || ss == nullptr)) ||
      ((flags & HAS_D) && dn == nullptr))
    return -1;
  cudaStream_t st = (cudaStream_t)stream;
  tap_epilogue_kernel<<<blocks, THREADS, 0, st>>>(
      feat, content, sgrad, w, cn, ss, dn, diff, partials, n, chunk, flags,
      kc, kd);
  const int err = (int)cudaGetLastError();
  if (err) return err;
  tap_sums_kernel<<<SUMS, THREADS, 0, st>>>(partials, out, blocks);
  return (int)cudaGetLastError();
}
