// The trunk's 2x2 stride-2 max pool with Caffe's ceil-mode output size, for
// Hopper (sm_90a): forward, and the backward that splits the gradient
// evenly among ties.
//
// Replaces no TPU kernel: the JAX package writes the pool as jnp.max over a
// -inf-padded 2x2 reshape, which XLA fuses. The plain version
// (ops/pool.py max_pool_ceil_plain) is F.pad and torch.amax, whose backward
// (scale_grad_by_count) compares the input with the broadcast maximum,
// counts the ties in int64, casts, divides and multiplies: 8-10 PyTorch
// kernels a pool an evaluation, most of them broadcast passes over the
// full-size input. Here the pool is one pass each way.
//
// For x (N, H, W, C) NHWC, float32 or bfloat16, H2 = ceil(H/2), W2 =
// ceil(W/2), and window position k = 2 * a + b holding x[n, 2i+a, 2j+b, c]
// (-inf where 2i+a = H or 2j+b = W, as the plain version's pad):
//
//   forward:  y[n,i,j,c] = the window's maximum, a NaN propagating as in
//             torch.amax; mask[n,i,j,c] bit k set where position k equals
//             y (pad positions included, so a window whose maximum is -inf
//             counts its pad as ties, as the plain version does).
//   backward: dx[n,2i+a,2j+b,c] = (g / count) * bit_k, g = dy[n,i,j,c] and
//             count = the mask's bits, in the tensor's dtype: in bfloat16
//             the float quotient is rounded to bf16 before the multiply,
//             as torch's bf16 division and multiply round. So a non-finite
//             g spreads as it does in the plain version (inf * 0 is NaN),
//             and a window with no maximum (a NaN) divides by 0.
//
// The maximum is one of the inputs and the backward is one IEEE division
// and one multiply by 0 or 1, so both directions give the plain version's
// values bit for bit (ties of +0 and -0 aside, which compare equal; a NaN
// may come back with other payload bits).
//
// What bounds it: bytes. Per output element the forward reads 4 inputs and
// writes the output and a 1-byte mask; the backward reads the cotangent
// and the mask and writes 4 gradients. A thread takes V channels of one
// output position (16 bytes of each input row: 4 float32 or 8 bf16), so
// every load and store is 16 bytes where C is a multiple of V (every VGG
// pool); otherwise V = 1. The grid: blockIdx.y walks output rows (n, i),
// x the (j, channel group) items of a row, both grid-stride.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T neg_inf();
template <>
__device__ __forceinline__ float neg_inf<float>() {
  return __int_as_float(0xff800000);
}
template <>
__device__ __forceinline__ __nv_bfloat16 neg_inf<__nv_bfloat16>() {
  return __ushort_as_bfloat16((unsigned short)0xff80);
}

// g / count rounded to T, times 0 or 1, rounded to T (exact).
__device__ __forceinline__ float split(float g, float count, float bit,
                                       float) {
  return __fmul_rn(__fdiv_rn(g, count), bit);
}
__device__ __forceinline__ __nv_bfloat16 split(float g, float count,
                                               float bit, __nv_bfloat16) {
  const float q = __bfloat162float(__float2bfloat16_rn(__fdiv_rn(g, count)));
  return __float2bfloat16_rn(__fmul_rn(q, bit));
}

// V values of T, one 16-byte access where V * sizeof(T) == 16.
template <typename T, int V>
struct alignas(V * sizeof(T)) Pack {
  T v[V];
};

template <int V>
struct alignas(V) Bits {
  uint8_t b[V];
};

template <typename T, int V>
__global__ void __launch_bounds__(THREADS)
pool_fwd_kernel(const T* __restrict__ x, T* __restrict__ y,
                uint8_t* __restrict__ mask, int n, int h, int w, int c) {
  const int h2 = (h + 1) / 2, w2 = (w + 1) / 2, groups = c / V;
  const int items = w2 * groups, rows = n * h2;
  for (int row = blockIdx.y; row < rows; row += gridDim.y) {
    const int img = row / h2, i = row - img * h2;
    const bool has_a1 = 2 * i + 1 < h;
    const T* x0 = x + ((size_t)img * h + 2 * i) * w * c;
    const T* x1 = x0 + (size_t)w * c;
    const size_t out_row = (size_t)row * w2 * c;
    for (int t = blockIdx.x * THREADS + threadIdx.x; t < items;
         t += gridDim.x * THREADS) {
      const int j = t / groups, ch = (t - j * groups) * V;
      const bool has_b1 = 2 * j + 1 < w;
      Pack<T, V> in[4];
      const size_t col = (size_t)2 * j * c + ch;
      in[0] = *reinterpret_cast<const Pack<T, V>*>(x0 + col);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        in[1].v[v] = neg_inf<T>();
        in[2].v[v] = neg_inf<T>();
        in[3].v[v] = neg_inf<T>();
      }
      if (has_b1) in[1] = *reinterpret_cast<const Pack<T, V>*>(x0 + col + c);
      if (has_a1) {
        in[2] = *reinterpret_cast<const Pack<T, V>*>(x1 + col);
        if (has_b1)
          in[3] = *reinterpret_cast<const Pack<T, V>*>(x1 + col + c);
      }
      Pack<T, V> out;
      Bits<V> bits;
#pragma unroll
      for (int v = 0; v < V; ++v) {
        // torch.amax's combine: keep the running value where it is a NaN
        // or greater, else take the next.
        float m = to_float(in[0].v[v]);
        T mr = in[0].v[v];
#pragma unroll
        for (int k = 1; k < 4; ++k) {
          const float f = to_float(in[k].v[v]);
          if (!(m != m || m > f)) {
            m = f;
            mr = in[k].v[v];
          }
        }
        out.v[v] = mr;
        uint8_t b = 0;
#pragma unroll
        for (int k = 0; k < 4; ++k)
          b |= (uint8_t)(to_float(in[k].v[v]) == m) << k;
        bits.b[v] = b;
      }
      const size_t o = out_row + (size_t)j * c + ch;
      *reinterpret_cast<Pack<T, V>*>(y + o) = out;
      if (mask) *reinterpret_cast<Bits<V>*>(mask + o) = bits;
    }
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(THREADS)
pool_bwd_kernel(const T* __restrict__ g, const uint8_t* __restrict__ mask,
                T* __restrict__ dx, int n, int h, int w, int c) {
  const int h2 = (h + 1) / 2, w2 = (w + 1) / 2, groups = c / V;
  const int items = w2 * groups, rows = n * h2;
  for (int row = blockIdx.y; row < rows; row += gridDim.y) {
    const int img = row / h2, i = row - img * h2;
    const bool has_a1 = 2 * i + 1 < h;
    T* d0 = dx + ((size_t)img * h + 2 * i) * w * c;
    T* d1 = d0 + (size_t)w * c;
    const size_t in_row = (size_t)row * w2 * c;
    for (int t = blockIdx.x * THREADS + threadIdx.x; t < items;
         t += gridDim.x * THREADS) {
      const int j = t / groups, ch = (t - j * groups) * V;
      const bool has_b1 = 2 * j + 1 < w;
      const size_t o = in_row + (size_t)j * c + ch;
      const Pack<T, V> gv = *reinterpret_cast<const Pack<T, V>*>(g + o);
      const Bits<V> bits = *reinterpret_cast<const Bits<V>*>(mask + o);
      Pack<T, V> out[4];
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const unsigned b = bits.b[v];
        const float gf = to_float(gv.v[v]);
        const float count = (float)__popc(b);
#pragma unroll
        for (int k = 0; k < 4; ++k)
          out[k].v[v] = split(gf, count, (b >> k) & 1u ? 1.f : 0.f, T());
      }
      const size_t col = (size_t)2 * j * c + ch;
      *reinterpret_cast<Pack<T, V>*>(d0 + col) = out[0];
      if (has_b1) *reinterpret_cast<Pack<T, V>*>(d0 + col + c) = out[1];
      if (has_a1) {
        *reinterpret_cast<Pack<T, V>*>(d1 + col) = out[2];
        if (has_b1) *reinterpret_cast<Pack<T, V>*>(d1 + col + c) = out[3];
      }
    }
  }
}

// One block row of the grid per output row (at most 65535, grid-stride
// beyond), enough blocks across to cover a row's items (at most 1024).
dim3 grid_of(int n, int h, int w, int c, int v) {
  const int items = (w + 1) / 2 * (c / v);
  const int rows = n * ((h + 1) / 2);
  int gx = (items + THREADS - 1) / THREADS;
  gx = gx < 1 ? 1 : gx > 1024 ? 1024 : gx;
  return dim3(gx, rows < 65535 ? rows : 65535);
}

bool bad_shape(int n, int h, int w, int c, int is_bf16, int vec) {
  const int v = vec ? (is_bf16 ? 8 : 4) : 1;
  return n < 1 || h < 1 || w < 1 || c < 1 || c % v != 0;
}

template <typename T, int V>
int launch_fwd(const void* x, void* y, uint8_t* mask, int n, int h, int w,
               int c, cudaStream_t st) {
  pool_fwd_kernel<T, V><<<grid_of(n, h, w, c, V), THREADS, 0, st>>>(
      (const T*)x, (T*)y, mask, n, h, w, c);
  return (int)cudaGetLastError();
}

template <typename T, int V>
int launch_bwd(const void* g, const uint8_t* mask, void* dx, int n, int h,
               int w, int c, cudaStream_t st) {
  pool_bwd_kernel<T, V><<<grid_of(n, h, w, c, V), THREADS, 0, st>>>(
      (const T*)g, mask, (T*)dx, n, h, w, c);
  return (int)cudaGetLastError();
}

}  // namespace

// x: (n, h, w, c) contiguous; y: (n, ceil(h/2), ceil(w/2), c) in x's dtype
// (bfloat16 where is_bf16 is nonzero, else float32); mask: uint8 of y's
// shape, or null (no backward follows). vec nonzero: c a multiple of 16
// bytes' worth of values and every pointer 16-byte aligned (the wrapper
// checks). Returns cudaGetLastError() of the launch, or -1 for arguments
// the kernel does not take.
extern "C" int st2_pool_fwd(const void* x, void* y, uint8_t* mask, int n,
                            int h, int w, int c, int is_bf16, int vec,
                            void* stream) {
  if (bad_shape(n, h, w, c, is_bf16, vec)) return -1;
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16)
    return vec ? launch_fwd<__nv_bfloat16, 8>(x, y, mask, n, h, w, c, st)
               : launch_fwd<__nv_bfloat16, 1>(x, y, mask, n, h, w, c, st);
  return vec ? launch_fwd<float, 4>(x, y, mask, n, h, w, c, st)
             : launch_fwd<float, 1>(x, y, mask, n, h, w, c, st);
}

// g: the cotangent of y, mask: the forward's; dx: (n, h, w, c), every
// element written. Arguments otherwise as st2_pool_fwd's.
extern "C" int st2_pool_bwd(const void* g, const uint8_t* mask, void* dx,
                            int n, int h, int w, int c, int is_bf16, int vec,
                            void* stream) {
  if (bad_shape(n, h, w, c, is_bf16, vec) || mask == nullptr) return -1;
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16)
    return vec ? launch_bwd<__nv_bfloat16, 8>(g, mask, dx, n, h, w, c, st)
               : launch_bwd<__nv_bfloat16, 1>(g, mask, dx, n, h, w, c, st);
  return vec ? launch_bwd<float, 4>(g, mask, dx, n, h, w, c, st)
             : launch_bwd<float, 1>(g, mask, dx, n, h, w, c, st);
}
