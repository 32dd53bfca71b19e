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
// are read and 4 written, with no reuse, so the work is one pass at HBM
// rate: 15 or 24 bytes a pixel, 3.5 and 5.6 us at 768x1024. At every
// ladder rung that is a few microseconds, less than a launch, so the
// design keeps both the device work and the host's launch short:
//
// - Whole pixels per thread. A thread computes groups of 4 pixels: 12
//   elements, three float4 vectors, read as float32 or as three 32-bit
//   words of uint8 (the cast folded into the load, so an 8-bit image
//   crosses HBM at 1 byte an element). Each group starts at channel 0, so
//   every lane's mean is a compile-time constant. A block stages its
//   groups in shared memory, so that global loads and stores stay
//   contiguous across a warp. 32-bit indices (the wrapper checks
//   n < 2^31).
// - The launch plan comes from the wrapper (ops/image.py:image_plan, a
//   pure function the CPU tests check): blocks for one wave of the groups,
//   at most what 132 SMs hold at once, the group count (0 where a pointer
//   is not 16-byte aligned) and where the scalar tail starts. The tail
//   covers the last n % 12 elements, or all of them on the unaligned path.
// - Few arguments. ctypes converts every argument of every call on the
//   host, so the plan crosses as one pointer to a Plan the wrapper builds
//   once per size and keeps, and the means are float literals here
//   (tests/test_torch_image.py checks each literal's float32 value against
//   MEAN_RGB bit for bit). An entry point takes four pointers.

#include <cuda_runtime.h>
#include <cstdint>

// A launch's plan, as ops/image.py:_plan_arg lays it out: five ints.
struct Plan {
  int in_dtype;  // preprocess's input: 0 float32, 1 uint8
  int n;         // elements, H*W*3 < 2^31
  int blocks;    // ops/image.py:image_plan
  int groups;
  int tail;
};

namespace {

constexpr int THREADS = 256;
constexpr int GROUP = 12;  // elements a thread owns per step: 4 RGB pixels

// MEAN_RGB of ops/image.py (reference worker.py:34).
constexpr float MEAN_R = 123.68f;
constexpr float MEAN_G = 116.779f;
constexpr float MEAN_B = 103.939f;

__device__ __forceinline__ float mean_of(unsigned c) {
  return c == 0 ? MEAN_R : (c == 1 ? MEAN_G : MEAN_B);
}

template <bool kSub>
__device__ __forceinline__ float shift(float v, float m) {
  return kSub ? __fsub_rn(v, m) : __fadd_rn(v, m);
}

// Float4 slot j of a chunk's input: four float32 elements, or the four
// bytes of one 32-bit word (byte b of the word is element b of the slot,
// little-endian).
__device__ __forceinline__ float4 load_slot(const float* in, unsigned j) {
  return reinterpret_cast<const float4*>(in)[j];
}

__device__ __forceinline__ float4 load_slot(const uint8_t* in, unsigned j) {
  const uint32_t w = reinterpret_cast<const uint32_t*>(in)[j];
  return make_float4((float)(w & 0xffu), (float)((w >> 8) & 0xffu),
                     (float)((w >> 16) & 0xffu), (float)(w >> 24));
}

// v -/+ the means of its four lanes, the first lane of channel c.
template <bool kSub, int c>
__device__ __forceinline__ float4 shift4(float4 v) {
  return make_float4(shift<kSub>(v.x, mean_of(c)),
                     shift<kSub>(v.y, mean_of((c + 1) % 3)),
                     shift<kSub>(v.z, mean_of((c + 2) % 3)),
                     shift<kSub>(v.w, mean_of(c)));
}

// out = in -/+ mean over n elements: groups 0..groups-1 as vectors, then
// elements tail..n-1 one at a time. Unsigned 32-bit indices: n < 2^31 and
// the stride is under 2^19, so i + stride never wraps.
//
// A block takes THREADS groups (3 * THREADS float4 slots) at a time. The
// chunk crosses global memory in slot order, thread t taking slots t,
// t + THREADS, t + 2 * THREADS, so that a warp's loads and stores cover
// contiguous bytes; shared memory turns it around, so that thread t
// computes its own group, slots 3t, 3t + 1, 3t + 2: four whole pixels,
// whose 12 lanes start at channels 0, 1 and 2 (4 % 3 == 1), fixed at
// compile time. (Reading and writing its own 48 bytes straight from global
// memory would spread each warp access over three times the bytes it
// moves.)
template <typename In, bool kSub>
__global__ void __launch_bounds__(THREADS, 8)
mean_shift_kernel(const In* __restrict__ in, float* __restrict__ out,
                  unsigned groups, unsigned tail, unsigned n) {
  __shared__ float4 stage[3 * THREADS];
  const unsigned t = threadIdx.x;
  for (unsigned base = blockIdx.x * THREADS; base < groups;
       base += gridDim.x * THREADS) {
    const unsigned slots = 3 * min((unsigned)THREADS, groups - base);
    for (unsigned j = t; j < slots; j += THREADS)
      stage[j] = load_slot(in, 3 * base + j);
    __syncthreads();
    if (3 * t < slots) {
      stage[3 * t] = shift4<kSub, 0>(stage[3 * t]);
      stage[3 * t + 1] = shift4<kSub, 1>(stage[3 * t + 1]);
      stage[3 * t + 2] = shift4<kSub, 2>(stage[3 * t + 2]);
    }
    __syncthreads();
    float4* out4 = reinterpret_cast<float4*>(out) + 3 * base;
    for (unsigned j = t; j < slots; j += THREADS) out4[j] = stage[j];
    __syncthreads();  // the next chunk refills the stage
  }
  const unsigned stride = gridDim.x * THREADS;
  for (unsigned i = tail + blockIdx.x * THREADS + t; i < n; i += stride)
    out[i] = shift<kSub>((float)in[i], mean_of(i % 3));
}

// The plan's checks: at least one block, the groups inside n and before
// the tail, and 16-byte pointers wherever vectors are used (a misaligned
// vector access would fault the context).
bool plan_ok(const void* in, const void* out, const Plan& p) {
  if (p.blocks < 1 || p.groups < 0 || p.tail < 0 || p.tail > p.n ||
      (long long)p.groups * GROUP > p.tail)
    return false;
  return p.groups == 0 || ((uintptr_t)in | (uintptr_t)out) % 16 == 0;
}

template <typename In, bool kSub>
int launch(const void* in, float* out, const Plan& p, void* stream) {
  if (p.n <= 0) return 0;
  if (!plan_ok(in, out, p)) return (int)cudaErrorInvalidValue;
  mean_shift_kernel<In, kSub><<<p.blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const In*)in, out, p.groups, p.tail, p.n);
  return (int)cudaGetLastError();
}

}  // namespace

// in: plan->n elements, uint8 (plan->in_dtype 1) or float32 (0); out:
// plan->n float32, out = in - mean. Returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for an unknown in_dtype or a plan that
// does not fit n and the pointers.
extern "C" int st2_preprocess(const void* in, float* out, const Plan* plan,
                              void* stream) {
  if (plan->in_dtype == 1)
    return launch<uint8_t, true>(in, out, *plan, stream);
  if (plan->in_dtype == 0)
    return launch<float, true>(in, out, *plan, stream);
  return (int)cudaErrorInvalidValue;
}

// in, out: plan->n float32 each, out = in + mean (plan->in_dtype unread).
extern "C" int st2_deprocess(const float* in, float* out, const Plan* plan,
                             void* stream) {
  return launch<float, false>(in, out, *plan, stream);
}
