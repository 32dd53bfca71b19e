// Image boundaries for Hopper (sm_90a): preprocess and deprocess.
//
// Replaces style_transfer2_tpu/ops/pallas/preprocess.py: _preprocess_kernel
// (through _elementwise_call and preprocess_pallas) and _deprocess_kernel
// (through deprocess_pallas). For an H x W x 3 RGB image stored flat,
// n = H*W*3 elements, element i of channel c = i % 3:
//
//   preprocess: out[i] = float(in[i]) - mean[c]     in: uint8 or float32
//   deprocess:  out[i] = in[i] + mean[c]            in: float32
//
// Each output is one IEEE float32 subtract or add, the same operation as
// the plain version's (ops/image.py), so the two agree bit for bit.
//
// What bounds it on this card: memory. Per element 1 (uint8) or 4 bytes
// are read and 4 written, with no reuse, so the kernel is one pass at HBM
// rate. The TPU kernel took float32 rows (Mosaic could not lower the uint8
// cast, so the wrapper cast first) and padded H to 256-row tiles for its
// block rules. Here the uint8 -> float32 cast is folded into the load, so
// an 8-bit image crosses to the card and through HBM at 1 byte/element,
// and a flat grid-stride loop covers any n with no padding: 16-byte vector
// loads and stores over the bulk, a scalar loop over the last n % V
// elements. Rows play no part: W*3 is odd at odd ladder rungs (543, 1629,
// 2172 elements), and flat addressing does not care. The mean is three
// kernel arguments, passed from the same float32 table the plain version
// uses.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_BLOCKS = 132 * 8;  // 8 resident blocks on each of 132 SMs

__device__ __forceinline__ float mean_of(int c, float m0, float m1,
                                         float m2) {
  return c == 0 ? m0 : (c == 1 ? m1 : m2);
}

__device__ __forceinline__ int next_channel(int c) { return c == 2 ? 0 : c + 1; }

template <bool kSub>
__device__ __forceinline__ float shift(float v, float m) {
  return kSub ? __fsub_rn(v, m) : __fadd_rn(v, m);
}

// out = in -/+ mean for float32 in. vec: both pointers 16-byte aligned, so
// the first n / 4 * 4 elements go as float4. A float4 at element 4k starts
// at channel 4k % 3 = k % 3.
template <bool kSub>
__global__ void __launch_bounds__(THREADS)
mean_shift_f32_kernel(const float* __restrict__ in, float* __restrict__ out,
                      long long n, float m0, float m1, float m2, bool vec) {
  const long long stride = (long long)gridDim.x * THREADS;
  const long long tid = (long long)blockIdx.x * THREADS + threadIdx.x;
  long long done = 0;
  if (vec) {
    const long long nv = n / 4;
    const float4* in4 = reinterpret_cast<const float4*>(in);
    float4* out4 = reinterpret_cast<float4*>(out);
    for (long long k = tid; k < nv; k += stride) {
      float4 v = in4[k];
      int c = (int)(k % 3);
      v.x = shift<kSub>(v.x, mean_of(c, m0, m1, m2));
      c = next_channel(c);
      v.y = shift<kSub>(v.y, mean_of(c, m0, m1, m2));
      c = next_channel(c);
      v.z = shift<kSub>(v.z, mean_of(c, m0, m1, m2));
      c = next_channel(c);
      v.w = shift<kSub>(v.w, mean_of(c, m0, m1, m2));
      out4[k] = v;
    }
    done = nv * 4;
  }
  for (long long i = done + tid; i < n; i += stride)
    out[i] = shift<kSub>(in[i], mean_of((int)(i % 3), m0, m1, m2));
}

// out = float(in) - mean for uint8 in. vec: both pointers 16-byte aligned,
// so the first n / 16 * 16 elements go as one 16-byte load and four float4
// stores. A vector at element 16k starts at channel 16k % 3 = k % 3.
__global__ void __launch_bounds__(THREADS)
preprocess_u8_kernel(const uint8_t* __restrict__ in, float* __restrict__ out,
                     long long n, float m0, float m1, float m2, bool vec) {
  const long long stride = (long long)gridDim.x * THREADS;
  const long long tid = (long long)blockIdx.x * THREADS + threadIdx.x;
  long long done = 0;
  if (vec) {
    const long long nv = n / 16;
    const uint4* in16 = reinterpret_cast<const uint4*>(in);
    float4* out4 = reinterpret_cast<float4*>(out);
    for (long long k = tid; k < nv; k += stride) {
      const uint4 raw = in16[k];
      const unsigned words[4] = {raw.x, raw.y, raw.z, raw.w};
      int c = (int)(k % 3);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float r[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {  // little-endian: byte j of word q
          const float v = (float)((words[q] >> (8 * j)) & 0xffu);
          r[j] = shift<true>(v, mean_of(c, m0, m1, m2));
          c = next_channel(c);
        }
        out4[4 * k + q] = make_float4(r[0], r[1], r[2], r[3]);
      }
    }
    done = nv * 16;
  }
  for (long long i = done + tid; i < n; i += stride)
    out[i] = shift<true>((float)in[i], mean_of((int)(i % 3), m0, m1, m2));
}

int blocks_for(long long work) {
  const long long b = (work + THREADS - 1) / THREADS;
  return (int)(b < 1 ? 1 : (b > MAX_BLOCKS ? MAX_BLOCKS : b));
}

bool aligned16(const void* a, const void* b) {
  return ((uintptr_t)a % 16 == 0) && ((uintptr_t)b % 16 == 0);
}

}  // namespace

// in: n elements, uint8 (in_dtype 1) or float32 (in_dtype 0); out: n
// float32. Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for an unknown in_dtype.
extern "C" int st2_preprocess(int in_dtype, const void* in, float* out,
                              long long n, float m0, float m1, float m2,
                              void* stream) {
  if (n <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const bool vec = aligned16(in, out);
  if (in_dtype == 1) {
    preprocess_u8_kernel<<<blocks_for(vec ? n / 16 + n % 16 : n), THREADS,
                           0, st>>>((const uint8_t*)in, out, n, m0, m1, m2,
                                    vec);
  } else if (in_dtype == 0) {
    mean_shift_f32_kernel<true><<<blocks_for(vec ? n / 4 + n % 4 : n),
                                  THREADS, 0, st>>>(
        (const float*)in, out, n, m0, m1, m2, vec);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// in, out: n float32 each, out = in + mean. Returns cudaGetLastError().
extern "C" int st2_deprocess(const float* in, float* out, long long n,
                             float m0, float m1, float m2, void* stream) {
  if (n <= 0) return 0;
  const bool vec = aligned16(in, out);
  mean_shift_f32_kernel<false><<<blocks_for(vec ? n / 4 + n % 4 : n),
                                 THREADS, 0, (cudaStream_t)stream>>>(
      in, out, n, m0, m1, m2, vec);
  return (int)cudaGetLastError();
}
