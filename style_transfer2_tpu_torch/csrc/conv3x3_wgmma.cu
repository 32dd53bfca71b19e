// The bfloat16 3x3 SAME conv + bias + ReLU forward and its ReLU-masked
// input-gradient backward on Hopper's warpgroup tensor cores (wgmma),
// sm_90a. The entry points in conv3x3.cu call conv3x3_bf16_wgmma for the
// bfloat16 paths `wgmma` and `wgmma_split` (ops/conv.py: fwd_plan,
// bwd_plan).
//
// Replaces style_transfer2_tpu/ops/pallas/conv.py: _fwd_kernel (through
// _fwd_call) and _bwd_kernel (through _bwd_call / _cvr_bwd) in bfloat16:
// bf16 operands, float32 accumulation over the 9 taps and every input
// channel, the bias added in float32, the ReLU, one rounding to bf16.
//
//   forward:  y  = ReLU(conv3x3_SAME(x, w) + b)     w: (3, 3, Cin, Cout)
//   backward: dx = conv3x3_SAME(g * [y > 0], wt)    wt: (3, 3, K, Cout)
//
// What bounds it on this card: the tensor cores (989 TFLOP/s bf16 dense)
// at the deep layers, where a 3x3 conv does hundreds of multiply-adds per
// byte it moves; what kept the mma.sync kernel (conv3x3.cu) at 17-23% of
// that bound was its unpipelined staging (a barrier on each side of every
// channel slice, so no copy overlapped an MMA), Ampere's mma.sync, and B
// fragments re-read by every warp. This design is an implicit GEMM (M =
// output pixels, N = output channels, K = 9 taps x input channels; im2col
// never exists):
//
//   * A block is two warpgroups (256 threads) on 16 x 16 output pixels by
//     BN = 128 output channels (64 where Cout is not a multiple of 128).
//     Each warpgroup owns two m64 tiles of 8 x 8 pixels and accumulates
//     them by BN channels in float32 registers (128 a thread at BN = 128).
//   * Tensor cores through wgmma.mma_async m64nBNk16 with both operands in
//     shared memory, read through descriptors in the no-swizzle layout
//     (core matrices of 8 rows x 16 contiguous bytes). A tap is a shifted
//     window of the staged halo tile: the tile is staged as planes of 8
//     channels, 16 bytes a pixel, so 8 pixels of a row are one core matrix
//     of A, the next row's 8 pixels lie one halo row (SBO) further on, and
//     a tap's shift moves only the descriptor's start address, by 16 bytes
//     a column and one halo row a row; im2col never exists. An m64 tile of
//     8 x 8 pixels never crosses a halo column, so rows of few pixels (W =
//     32, 64, 91, 181) waste only their ragged edge. B (the weights,
//     channels-major rows) is N-major, 8 x 8 core matrices of 128
//     contiguous bytes, read once per warpgroup and m64 tile. Chosen over A
//     in registers on an H100: with ldmatrix fragments the compiler kept
//     all nine taps' A registers live until the slice's wait (spills at
//     BN = 128), and that kernel ran slower than the mma.sync one.
//   * A ring of 4 shared-memory stages, each 16 input channels of the
//     (16 + 2) x (16 + 2) halo tile and of the 9 weight taps (47-58 KB at
//     BN = 128). The weights go in one bulk copy by the TMA engine
//     (cp.async.bulk, completing on the stage's mbarrier): the wrapper
//     keeps them blocked (ops/conv.py:wgmma_weights) so that one slice of
//     one block's weights is one contiguous run of bytes in the stage's
//     order. The halo tile goes by cp.async, 16 bytes a thread with zero
//     fill: the halo, the SAME padding, odd H and W and the channels past a
//     split's range are copies of no bytes. The copies run two slices
//     ahead of the MMAs, one slice's MMAs stay in flight while the next
//     slice's are issued, one barrier a slice, and neighbouring blocks
//     start their channel loop at different slices.
//     On an H100, with the weights also copied by cp.async (2,304 16-byte
//     copies a slice), the kernel took as long without its MMAs as with
//     them: the weight staging bound it, and the bulk copy lifted the deep
//     layers to 390-526 TFLOP/s (PERF.md). A tensor-map TMA load
//     (cuTensorMapEncodeTiled, a driver-API object encoded on the host for
//     each new pointer, while the bf16 step is bound by the host already)
//     would also cut the halo tile's copies; the bulk copy needs no
//     descriptor, no driver entry point and no producer warp (so no
//     setmaxnreg).
//   * The backward lands g and y raw in the ring (cp.async writes the bytes
//     as loaded) and each thread masks the 16-byte chunks it copied once
//     per staged slice, g where y > 0, before the barrier that hands the
//     slice to the MMAs; never once per tap.
//   * Split (wgmma_split): where the grid would leave most of the card idle
//     (the 512px conv4 layers: 48 blocks on 132 SMs), the input channels
//     are split across blocks into float32 partial sums, which a second
//     pass adds in split order before it adds the bias, applies the ReLU
//     and rounds once. No atomics: two calls give the same bits.
//
// Operands must be 16-byte aligned with Cin and Cout multiples of 8 (the
// copies are 16 bytes); the mma.sync kernel in conv3x3.cu takes every
// other shape (conv1_1's Cin = 3) and unaligned views.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <algorithm>
#include <cstddef>
#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int WG_THREADS = 256;            // two warpgroups
constexpr int WTH = 16;                    // output rows per block
constexpr int WTW = 16;                    // output columns per block
constexpr int MT = 2;                      // m64 tiles (8 x 8 pixels) a
                                           // warpgroup
static_assert(2 * MT * 64 == WTH * WTW, "the warpgroups tile the pixels");
constexpr int WK = 16;                     // input channels a stage
constexpr int WPITCH = WTW + 2;            // staged pixels a halo row
constexpr int WHALO = (WTH + 2) * WPITCH;
constexpr int WIN_PLANE = WHALO * 16;      // bytes: 8 channels of each pixel
constexpr int WIN_BYTES = 2 * WIN_PLANE;   // the slice's 16 channels
constexpr int WIN_CHUNKS = WHALO * WK / 8;  // 16-byte copies of a halo slice
constexpr int WIN_COPIES = (WIN_CHUNKS + WG_THREADS - 1) / WG_THREADS;

template <int BN, bool BWD>
struct Ring {
  static constexpr int W_BYTES = 9 * WK * BN * 2;   // weights of a slice
  // A stage: the weights, the halo tile (x or g) and, backward, y's.
  static constexpr int STAGE = W_BYTES + WIN_BYTES * (BWD ? 2 : 1);
  // Backward at BN = 128: 4 x 57,600 bytes, within 232,448.
  static constexpr int STAGES = 4;
  // The stages, then one mbarrier each for its weights' bulk copy.
  static constexpr int SMEM = STAGE * STAGES + 8 * STAGES;
  static_assert(STAGE % 16 == 0, "16-byte aligned stages");
  static_assert(SMEM <= 232448, "fits one block's shared memory");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool pred) {
  const int n = pred ? 16 : 0;   // 0: no read, 16 zero bytes written
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

// One thread: `bytes` from global src to shared dst by the bulk-copy
// (TMA) engine, completing on the mbarrier bar, which expects them.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          int bytes, uint32_t bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// Waits until the mbarrier bar has completed the phase of this parity.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  asm volatile(
      "{\n.reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n}\n"
      :: "r"(bar), "r"(parity) : "memory");
}

// Makes this thread's shared-memory writes (cp.async's included, once
// waited for) visible to the async proxy, which wgmma reads B through.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous MMAs that update it.
__device__ __forceinline__ void fence_operand(float& r) {
  asm volatile("" : "+f"(r) :: "memory");
}

// A shared-memory matrix descriptor in the no-swizzle layout: the start
// address, the leading byte offset (between core matrices adjacent in K)
// and the stride byte offset (adjacent in M or N), each in 16-byte units.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32);
}

// d (m64 x BN, float32, the wgmma accumulator layout) += A (m64 x k16
// bf16, K-major in shared memory, desc_a) * B (k16 x BN bf16, N-major in
// shared memory, desc_b).
template <int BN>
__device__ __forceinline__ void wgmma_ss(float (&d)[BN / 2], uint64_t desc_a,
                                         uint64_t desc_b);

template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t desc_a,
                                              uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_ss<128>(float (&d)[64],
                                              uint64_t desc_a,
                                              uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(1));
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

// x: (N, H, W, Cin), the forward's input or the backward's cotangent g; y:
// (N, H, W, Cin) the forward output whose ReLU masks g (BWD only); wb: the
// weights (3, 3, Cin, Cout) blocked as ops/conv.py:wgmma_weights lays them
// out, (ceil(Cout/BN), ceil(Cin/16), 9, 2, BN/8, 8, 8), so that one slice
// of one block's weights is W_BYTES contiguous bytes in the order of its
// stage; b: (Cout,) (forward only); out: (N, H, W, Cout) bf16, or
// with raw (S, N, H, W, Cout) float32 partial sums, split s summing the
// input channels [s * kspan, min(Cin, (s + 1) * kspan)) (kspan a multiple
// of WK). Grid: (ceil(H/WTH) * ceil(W/WTW), ceil(Cout/BN), N * S);
// dynamic shared memory Ring<BN, BWD>::SMEM.
template <int BN, bool BWD>
__global__ void __launch_bounds__(WG_THREADS, 1)
conv3x3_wgmma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ y,
                     const bf16* __restrict__ wb, const bf16* __restrict__ b,
                     void* __restrict__ out, int N, int H, int W, int Cin,
                     int Cout, int kspan, bool raw) {
  using R = Ring<BN, BWD>;
  extern __shared__ __align__(128) unsigned char ring[];

  const int tiles_w = (W + WTW - 1) / WTW;
  const int h0 = (blockIdx.x / tiles_w) * WTH;
  const int w0 = (blockIdx.x % tiles_w) * WTW;
  const int co0 = blockIdx.y * BN;
  const int n = blockIdx.z % N;
  const int split = blockIdx.z / N;
  const int kbeg = split * kspan;
  const int kend = min(Cin, kbeg + kspan);
  const size_t img = (size_t)n * H * W;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int wg = tid / 128;            // warpgroup
  const int wq = (tid / 32) % 4;       // warp within it: MMA rows 16 wq ..
  const uint32_t ring0 = smem_u32(ring);
  const uint32_t bars = ring0 + R::STAGES * R::STAGE;   // 8 bytes a stage
  const int kslices = (Cin + WK - 1) / WK;
  if (tid == 0) {
    for (int s = 0; s < R::STAGES; ++s) mbar_init(bars + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Stage `st` <- input channels [k0, k0 + WK): the weights as [tap][k / 8]
  // [n / 8] core matrices of 8 k-rows x 8 channels (128 contiguous bytes),
  // one bulk copy by the TMA engine that completes on the stage's
  // mbarrier; then the halo tile as [k / 8][pixel] planes of 16 bytes a
  // pixel, so that 8 pixels of a row are one core matrix of A, and (BWD)
  // y's halo tile alike, by cp.async.
  auto stage = [&](int st, int k0) {
    const uint32_t s_w = ring0 + st * R::STAGE;
    const uint32_t s_x = s_w + R::W_BYTES;
    if (tid == 0)
      bulk_copy(s_w, wb + ((size_t)blockIdx.y * kslices + k0 / WK)
                          * (R::W_BYTES / 2), R::W_BYTES, bars + 8 * st);
#pragma unroll
    for (int it = 0; it < WIN_COPIES; ++it) {
      const int i = tid + it * WG_THREADS;
      if (i >= WIN_CHUNKS) break;
      const int pix = i / 2;
      const int gh = h0 + pix / WPITCH - 1;
      const int gw = w0 + pix % WPITCH - 1;
      const int gk = k0 + (i % 2) * 8;
      const bool ok = gh >= 0 && gh < H && gw >= 0 && gw < W && gk < kend;
      const size_t idx = ok ? (img + (size_t)gh * W + gw) * Cin + gk : 0;
      const uint32_t dst = s_x + (i % 2) * WIN_PLANE + pix * 16;
      cp_async16(dst, x + idx, ok);
      if (BWD) cp_async16(dst + WIN_BYTES, y + idx, ok);
    }
  };

  // g *= [y > 0] on the chunks this thread copied into stage `st`, once its
  // copies have landed.
  auto mask = [&](int st) {
    unsigned char* s_x = ring + st * R::STAGE + R::W_BYTES;
#pragma unroll
    for (int it = 0; it < WIN_COPIES; ++it) {
      const int i = tid + it * WG_THREADS;
      if (i >= WIN_CHUNKS) break;
      uint4* gp = reinterpret_cast<uint4*>(s_x + (i % 2) * WIN_PLANE
                                           + (i / 2) * 16);
      const uint4 yv = *reinterpret_cast<const uint4*>(
          reinterpret_cast<unsigned char*>(gp) + WIN_BYTES);
      *gp = relu_mask8(*gp, yv);
    }
  };

  float acc[MT][BN / 2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < BN / 2; ++j) acc[mt][j] = 0.f;

  // m64 tile mt of this warpgroup: output rows r0 .. r0 + 7, columns c0 ..
  // c0 + 7; MMA row m is pixel (r0 + m / 8, c0 + m % 8).
  const int r0 = wg * 8;
  auto col0 = [](int mt) { return mt * 8; };

  // The copies run STAGES - 2 slices ahead of the MMAs, and one slice's
  // MMAs stay in flight while the next slice's are issued: the stage a
  // copy overwrites was read by MMAs two slices back, which every thread
  // has waited for before the barrier that precedes the copy.
  constexpr int AHEAD = R::STAGES - 2;
  const int passes = (kend - kbeg + WK - 1) / WK;
  // Neighbouring blocks start at different slices, so that a wave of
  // blocks does not read the same weights from the same L2 lines at once.
  const int rot = (int)(blockIdx.x % passes);
  auto slice_k = [&](int s) { return kbeg + ((s + rot) % passes) * WK; };
#pragma unroll
  for (int s = 0; s < AHEAD; ++s) {
    if (s < passes) stage(s, slice_k(s));
    cp_async_commit();
  }
  for (int it = 0; it < passes; ++it) {
    const int st = it % R::STAGES;
    // Slice it has landed for this thread (and is masked); after the
    // barrier, for every thread.
    cp_async_wait<AHEAD - 1>();
    if (BWD) mask(st);
    fence_proxy_async();
    mbar_wait(bars + 8 * st, (it / R::STAGES) & 1);
    __syncthreads();

    const uint32_t s_w = ring0 + st * R::STAGE;
    const uint32_t s_x = s_w + R::W_BYTES;
    wgmma_fence();
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3;
      const int dx = tap % 3;
      // B: this tap's 16 k-rows; core matrices 128 bytes apart along N,
      // BN * 16 bytes apart along K.
      const uint64_t desc_b = smem_desc(s_w + tap * (2 * BN * 16), BN * 16,
                                        128);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        // A: the halo pixels (r0 + dy + row, col0 + dx + col), a shifted
        // window of the staged tile: core matrices (8 pixels of a row) one
        // halo row apart along M, one channel plane apart along K.
        const uint64_t desc_a = smem_desc(
            s_x + ((r0 + dy) * WPITCH + col0(mt) + dx) * 16, WIN_PLANE,
            WPITCH * 16);
        wgmma_ss<BN>(acc[mt], desc_a, desc_b);
      }
    }
    wgmma_commit();
    // The copies of slice it + AHEAD, into the stage slice it - 2 left.
    const int next = it + AHEAD;
    if (next < passes) stage(next % R::STAGES, slice_k(next));
    cp_async_commit();
    wgmma_wait<1>();
  }
  wgmma_wait<0>();
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < BN / 2; ++j) fence_operand(acc[mt][j]);

  // Accumulator j of m64 tile mt, in warp wq: MMA row 16 wq + g (j % 4 <
  // 2) or 16 wq + g + 8, that is output row r0 + 2 wq (+1), column
  // col0(mt) + g; channels 8 * (j / 4) + 2t (+1 for odd j).
  const int g = lane / 4;
  const int t = lane % 4;
  const size_t plane = (size_t)N * H * W * Cout;
  const int gw = w0 + g;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int gwm = gw + col0(mt);
    if (gwm >= W) continue;
#pragma unroll
    for (int nb = 0; nb < BN / 8; ++nb) {
      const int co = co0 + nb * 8 + 2 * t;
      if (co >= Cout) continue;
      float b0 = 0.f, b1 = 0.f;
      if (!BWD && !raw) {
        b0 = __bfloat162float(b[co]);
        b1 = __bfloat162float(b[co + 1]);
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int gh = h0 + r0 + 2 * wq + half;
        if (gh >= H) continue;
        const size_t o = (img + (size_t)gh * W + gwm) * Cout + co;
        float v0 = acc[mt][4 * nb + 2 * half];
        float v1 = acc[mt][4 * nb + 2 * half + 1];
        if (raw) {
          *reinterpret_cast<float2*>(static_cast<float*>(out)
                                     + split * plane + o) =
              make_float2(v0, v1);
          continue;
        }
        v0 += b0;
        v1 += b1;
        if (!BWD) {
          v0 = fmaxf(v0, 0.f);
          v1 = fmaxf(v1, 0.f);
        }
        *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(out) + o) =
            __floats2bfloat162_rn(v0, v1);
      }
    }
  }
}

// out = the sum over s of parts[s] in split order, then (b given) + b and
// the ReLU, rounded once to bf16. parts: (S, n4) float4s of consecutive
// channels; b: (Cout,) bf16 or null; out: n4 groups of 4 bf16.
__global__ void sum_splits_bf16_kernel(const float4* __restrict__ parts,
                                       const bf16* __restrict__ b,
                                       uint2* __restrict__ out, long long n4,
                                       int cout4, int splits) {
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
    if (b != nullptr) {
      const bf16* bb = b + 4 * (e % cout4);
      v.x = fmaxf(v.x + __bfloat162float(bb[0]), 0.f);
      v.y = fmaxf(v.y + __bfloat162float(bb[1]), 0.f);
      v.z = fmaxf(v.z + __bfloat162float(bb[2]), 0.f);
      v.w = fmaxf(v.w + __bfloat162float(bb[3]), 0.f);
    }
    const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
    out[e] = make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                        *reinterpret_cast<const uint32_t*>(&hi));
  }
}

template <int BN, bool BWD>
int launch_wgmma(cudaStream_t st, const void* x, const void* y,
                 const void* wb, const void* b, void* out, int n, int h,
                 int wd, int cin, int cout, int splits, int kspan,
                 bool raw) {
  using R = Ring<BN, BWD>;
  // Above 48 KB, dynamic shared memory must be allowed explicitly, once
  // per kernel.
  static const cudaError_t attr = cudaFuncSetAttribute(
      conv3x3_wgmma_kernel<BN, BWD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, R::SMEM);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid(((h + WTH - 1) / WTH) * ((wd + WTW - 1) / WTW),
                  (cout + BN - 1) / BN, n * splits);
  conv3x3_wgmma_kernel<BN, BWD><<<grid, WG_THREADS, R::SMEM, st>>>(
      (const bf16*)x, (const bf16*)y, (const bf16*)wb, (const bf16*)b, out,
      n, h, wd, cin, cout, kspan, raw);
  return (int)cudaGetLastError();
}

template <bool BWD>
int launch_wgmma_any(cudaStream_t st, const void* x, const void* y,
                     const void* wb, const void* b, void* out, int n, int h,
                     int wd, int cin, int cout, int splits, int kspan,
                     bool raw) {
  if (cout % 128 == 0)
    return launch_wgmma<128, BWD>(st, x, y, wb, b, out, n, h, wd, cin, cout,
                                  splits, kspan, raw);
  return launch_wgmma<64, BWD>(st, x, y, wb, b, out, n, h, wd, cin, cout,
                               splits, kspan, raw);
}

}  // namespace

// The bfloat16 wgmma paths of st2_conv3x3_fwd (bwd false: x, w, b) and
// st2_conv3x3_bwd (bwd true: g as x, y, wt as w), w blocked by
// ops/conv.py:wgmma_weights (BN 128 where cout is a multiple of 128, else
// 64). splits 1: the kernel
// writes out; splits > 1: it writes float32 partial sums of kspan input
// channels each into parts (splits, n, h, wd, cout), and a second pass
// sums them in split order into out (forward: + b, ReLU). Returns the
// first nonzero cudaGetLastError(), or -1 for what the kernel does not
// take: cin or cout not a multiple of 8, an operand not 16-byte aligned,
// a split that does not cover cin once.
int conv3x3_bf16_wgmma(bool bwd, const void* x, const void* y,
                       const void* wb, const void* b, void* out, void* parts,
                       int n, int h, int wd, int cin, int cout, int splits,
                       int kspan, cudaStream_t st) {
  const uintptr_t addr = (uintptr_t)x | (uintptr_t)wb | (uintptr_t)out |
                         (uintptr_t)(bwd ? y : x) |
                         (uintptr_t)(splits > 1 ? parts : out);
  if (cin % 8 != 0 || cout % 8 != 0 || addr % 16 != 0) return -1;
  if (splits == 1) {
    kspan = cin;
  } else if (splits < 2 || kspan % WK != 0 ||
             (long long)(splits - 1) * kspan >= cin ||
             (long long)splits * kspan < cin) {
    return -1;
  }
  const bool raw = splits > 1;
  void* dst = raw ? parts : out;
  const int err =
      bwd ? launch_wgmma_any<true>(st, x, y, wb, nullptr, dst, n, h, wd,
                                   cin, cout, splits, kspan, raw)
          : launch_wgmma_any<false>(st, x, nullptr, wb, b, dst, n, h, wd,
                                    cin, cout, splits, kspan, raw);
  if (err || !raw) return err;
  const long long n4 = (long long)n * h * wd * cout / 4;
  const int blocks = (int)std::min<long long>((n4 + 255) / 256, 4096);
  sum_splits_bf16_kernel<<<blocks, 256, 0, st>>>(
      (const float4*)parts, bwd ? nullptr : (const bf16*)b, (uint2*)out, n4,
      cout / 4, splits);
  return (int)cudaGetLastError();
}
