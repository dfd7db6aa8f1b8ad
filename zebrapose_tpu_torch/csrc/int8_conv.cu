// int8 serving convolution: a per-tensor activation quantizer and an
// implicit-GEMM convolution on the int8 tensor cores with a fused
// dequantizing epilogue.
//
// Replaces no Pallas kernel: the JAX package's int8 layer
// (zebrapose_tpu/models/layers.py::_Int8Conv) quantizes with jnp ops and
// hands the int8 operands to XLA's convolution (lax.conv_general_dilated,
// int32 accumulation). PyTorch has no CUDA int8 convolution, so both
// halves are written here.
//
// zp_quantize_act: sx = max(amax|x|, 1e-8) / 127 and
//   xq = clamp(rint(x / sx), -127, 127), x NHWC bf16 or f32.
//   Bound: bytes. The scale needs every element before the first xq, so
//   the activation is read twice: 5 bytes an element for bf16 against the
//   3 of the bound (a read and an int8 write). Two launches, no atomics
//   and nothing to zero: the max pass writes one maximum a block into a
//   scratch array; every block of the quantizing pass reduces those
//   maxima itself (max is exact in any order) and derives sx, block 0 also
//   writes it out. sx stays on the card: no host sync. Every thread moves
//   16 bytes a load (8 bf16 or 4 f32) and stores 8 or 4 int8 at once, in a
//   grid-stride loop over a grid of as many blocks as the SMs hold at
//   once. (Walking the quantizing pass from the tensor's end, so that
//   what the max pass read last is still in L2, measured no faster at
//   upsample_2's input, b32 and b256, so it walks forward.) IEEE division
//   (__fdiv_rn) and rintf (half to even) give the plain version's bits.
//
// zp_int8_conv2d: y[m, c] = float(acc[m, c]) * (sx * sw[c]) (+ b[c]) with
//   acc = sum_k A[m, k] B[k, c] in int32, M = N*Ho*Wo output pixels,
//   K = kh*kw*Cin (tap-major), A the im2col of xq never materialised,
//   B = wq laid out [Cout][kh][kw][Cin]. The epilogue rounds like the
//   plain version: __int2float_rn, then __fmul_rn by __fmul_rn(sx, sw[c]),
//   then __fadd_rn of the bias, each spelled out so that nvcc cannot
//   contract them into an FMA, then f32 or bf16 (__float2bfloat16_rn)
//   NHWC stores. Bound: operations at the network's shapes (upsample_2's
//   3x3 256->256 conv at 128^2 does 2*M*K*Cout = 19.3 GOP a crop against
//   8.4 MB moved). Two routes, chosen by shape in ops/int8_conv.py::
//   conv_route:
//
//   "wgmma" (Cin % 16 == 0, stride <= 2: every conv of the networks). A
//   block's tile is 128 output pixels, a TN x TH x TW box of (image, row,
//   column), by 256 output channels, so that one tap's slice of A for 128
//   channels is one TMA box over xq seen as the 4-D tensor [C, W, H, N]:
//   it starts at (c0, wo0*s - p + j*d, ho0*s - p + i*d, n0) with element
//   strides s on W and H, and TMA writes zeros where it leaves the tensor,
//   which is XLA's zero padding of xq and of channels past Cin; no address
//   arithmetic is left in the kernel. The matching slice of B is one box
//   over wq seen as [Cin, taps, Cout]. A stage (one tap, 128 channels) is
//   16 KB of A and 32 KB of B with 128-byte swizzle, four stages in a ring
//   of mbarriers. One producer warp issues the TMA loads; two consumer
//   warpgroups run wgmma.m64n256k32.s32.s8.s8 on them, both operands read
//   from shared memory, one 64-row half of the tile each, with one stage's
//   products in flight while the next stage is waited for. The grid is
//   persistent (one block an SM walks the tiles), so the producer loads the
//   next tile's first stages while the consumers run the epilogue, which
//   stores from the accumulator registers (two neighbouring channels a
//   store). A tile's row past the output (a pixel of the box outside the
//   image) is computed and not stored; a channel past Cout reads zeros.
//   On an H100 SXM at 700 W it reaches ~50% of the int8 peak at
//   upsample_2's shape; sharing each B box between a cluster of two
//   blocks by TMA multicast (half the L2 reads) measured no faster.
//
//   "gather" (Cin % 16 != 0 or stride > 2: v3's 1025-channel fuse, the
//   Cin 40 edge set). A tensor map needs 16-byte strides and a box of at
//   most 256 elements a dimension, so this route gathers A and B byte by
//   byte into shared memory (a tap outside the image, a row past M or a
//   column past K gives zeros), 128 x 128 tiles of 8 warps, each 64 x 32 in
//   mma.sync m16n8k32 s8 tiles, 64 K bytes a stage. Simple and slow; no
//   conv of the networks' main path takes it.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -shared -Xcompiler -fPIC   (no --use_fast_math). Tensor maps are
//        encoded through the runtime's driver entry point, so no -lcuda.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ int8_t quantize(float v, float sx) {
  float q = rintf(__fdiv_rn(v, sx));
  q = fminf(fmaxf(q, -127.0f), 127.0f);
  return static_cast<int8_t>(static_cast<int>(q));
}

// The largest of every thread's m in the block, in all threads.
template <int kThreads>
__device__ __forceinline__ float block_max(float m) {
  __shared__ float warp_max[kThreads / 32];
  __shared__ float result;
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_max[warp] = m;
  __syncthreads();
  if (warp == 0) {
    m = lane < kThreads / 32 ? warp_max[lane] : 0.0f;
    for (int off = 16; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    if (lane == 0) result = m;
  }
  __syncthreads();
  return result;
}

// --------------------------------------------------------- quantizer

constexpr int kQThreads = 256;

// Elements of x in 16 bytes (8 bf16 or 4 f32), and element e of such a
// vector as a float (exact: a bf16 is the high half of its float).
template <typename T>
constexpr int kVecN = 16 / sizeof(T);

template <typename T>
__device__ __forceinline__ float element(const uint4& r, int e);
template <>
__device__ __forceinline__ float element<float>(const uint4& r, int e) {
  return __uint_as_float((&r.x)[e]);
}
template <>
__device__ __forceinline__ float element<__nv_bfloat16>(const uint4& r,
                                                        int e) {
  const unsigned w = (&r.x)[e >> 1];
  return __uint_as_float((e & 1) ? (w & 0xffff0000u) : (w << 16));
}

template <typename T>
__global__ void __launch_bounds__(kQThreads)
absmax_kernel(const T* __restrict__ x, long long n, long long nvec,
              float* __restrict__ block_maxima) {
  constexpr int kN = kVecN<T>;
  const long long step = static_cast<long long>(gridDim.x) * kQThreads;
  const long long t0 = static_cast<long long>(blockIdx.x) * kQThreads +
                       threadIdx.x;
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  float m = 0.0f;
  for (long long i = t0; i < nvec; i += step) {
    const uint4 v = __ldg(xv + i);
#pragma unroll
    for (int e = 0; e < kN; ++e) m = fmaxf(m, fabsf(element<T>(v, e)));
  }
  for (long long i = nvec * kN + t0; i < n; i += step)
    m = fmaxf(m, fabsf(to_float(x[i])));
  m = block_max<kQThreads>(m);
  if (threadIdx.x == 0) block_maxima[blockIdx.x] = m;
}

template <typename T>
__global__ void __launch_bounds__(kQThreads)
quantize_kernel(const T* __restrict__ x, long long n, long long nvec,
                const float* __restrict__ block_maxima, int n_maxima,
                float* __restrict__ sx_out, int8_t* __restrict__ xq) {
  constexpr int kN = kVecN<T>;
  float m = 0.0f;
  for (int i = threadIdx.x; i < n_maxima; i += kQThreads)
    m = fmaxf(m, block_maxima[i]);
  const float sx = __fdiv_rn(fmaxf(block_max<kQThreads>(m), 1e-8f),
                             127.0f);
  if (blockIdx.x == 0 && threadIdx.x == 0) *sx_out = sx;
  const long long step = static_cast<long long>(gridDim.x) * kQThreads;
  const long long t0 = static_cast<long long>(blockIdx.x) * kQThreads +
                       threadIdx.x;
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  for (long long i = t0; i < nvec; i += step) {
    const uint4 v = __ldg(xv + i);
    unsigned w[2] = {0u, 0u};                // kN int8, packed
#pragma unroll
    for (int e = 0; e < kN; ++e)
      w[e >> 2] |= static_cast<unsigned>(static_cast<uint8_t>(
                       quantize(element<T>(v, e), sx)))
                   << (8 * (e & 3));
    if constexpr (kN == 8)
      reinterpret_cast<uint2*>(xq)[i] = make_uint2(w[0], w[1]);
    else
      reinterpret_cast<unsigned*>(xq)[i] = w[0];
  }
  for (long long i = nvec * kN + t0; i < n; i += step)
    xq[i] = quantize(to_float(x[i]), sx);
}

// Blocks of `kernel` the card holds at once (its SMs times the blocks an
// SM holds), at most `cap`.
template <typename K>
int resident_blocks(K kernel, int threads, int smem, int cap) {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                    smem) != cudaSuccess)
    return 0;
  const long long all = static_cast<long long>(sms) * per_sm;
  return static_cast<int>(all < cap ? all : cap);
}

template <typename T>
cudaError_t launch_quantize(const void* x, long long n, float* scratch,
                            int scratch_len, float* sx, int8_t* xq,
                            cudaStream_t st) {
  constexpr int kN = kVecN<T>;
  const T* xt = static_cast<const T*>(x);
  const bool vec = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(xq) % kN == 0;
  const long long nvec = vec ? n / kN : 0;
  static int most = 0;               // resident blocks, found once
  if (most == 0) {
    const int a = resident_blocks(absmax_kernel<T>, kQThreads, 0, 1 << 20);
    const int b = resident_blocks(quantize_kernel<T>, kQThreads, 0, 1 << 20);
    most = a < b ? a : b;
    if (most <= 0) return cudaErrorUnknown;
  }
  const long long work = (nvec + n - nvec * kN + kQThreads - 1) / kQThreads;
  long long blocks = work < most ? work : most;
  if (blocks > scratch_len) blocks = scratch_len;
  if (blocks < 1) blocks = 1;
  const int g = static_cast<int>(blocks);
  absmax_kernel<T><<<g, kQThreads, 0, st>>>(xt, n, nvec, scratch);
  cudaError_t rc = cudaGetLastError();
  if (rc != cudaSuccess) return rc;
  quantize_kernel<T><<<g, kQThreads, 0, st>>>(xt, n, nvec, scratch, g, sx,
                                              xq);
  return cudaGetLastError();
}

// ------------------------------------------- convolution, wgmma route

constexpr int kTileM = 128;        // output pixels a tile
constexpr int kTileN = 256;        // output channels a tile
constexpr int kChunk = 128;        // K bytes a stage: 128 channels of a tap
constexpr int kStages = 4;
constexpr int kThreadsW = 288;     // 2 consumer warpgroups + 1 producer warp
constexpr int kBytesA = kTileM * kChunk;           // 16 KB
constexpr int kBytesB = kTileN * kChunk;           // 32 KB
constexpr int kSmemW = kStages * (kBytesA + kBytesB) + 2 * kStages * 8 +
                       1024;                       // + alignment slack

struct ConvTiles {
  int Ho, Wo, Cout, N;
  int kw, chunks, k_iters;          // k_iters = kh * kw * chunks
  int stride, pad, dil;
  int TW, TH, TN;                   // TW * TH * TN = kTileM
  int tiles_w, tiles_h, tiles_c, n_tiles;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar,
                                              uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Waits for the phase of `parity` to complete. A wait of more than ~2^34
// cycles (seconds) means a barrier that will never complete: trap, so the
// launch fails with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t b = smem_u32(bar);
  if (mbar_try_wait(b, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(b, parity))
    if (clock64() - t0 > (1ll << 34)) __trap();
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(smem_u32(bar))
      : "memory");
}

// wgmma's shared-memory operand: rows of 128 K bytes, 8-row atoms of
// 1024 bytes, 128-byte swizzle (the layout TMA writes with
// CU_TENSOR_MAP_SWIZZLE_128B); K-major, the only major 8-bit types have.
__device__ __forceinline__ uint64_t smem_desc(const void* p) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         (1ull << 16) |                     // leading offset: unused
         (static_cast<uint64_t>(1024 >> 4) << 32) |   // 8-row atom stride
         (1ull << 62);                      // 128-byte swizzle
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending)
               : "memory");
}

// D (64 x 256 int32 a warpgroup, 128 a thread) += A (64 x 32, shared
// memory) * B (32 x 256, shared memory), s8; scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_m64n256k32(int* d, uint64_t da,
                                                 uint64_t db,
                                                 int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]),
        "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]),
        "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]),
        "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]),
        "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]),
        "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]),
        "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]),
        "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]),
        "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(da), "l"(db), "r"(scale_d));
}

// Keeps the compiler from moving reads or writes of the accumulators
// across the asynchronous wgmma instructions that own them.
__device__ __forceinline__ void fence_acc(int* d) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

template <typename OutT>
__device__ __forceinline__ void store_pair(OutT* p, float a, float b,
                                           bool both, bool paired) {
  if constexpr (sizeof(OutT) == 4) {
    if (paired)
      *reinterpret_cast<float2*>(p) = make_float2(a, b);
    else {
      p[0] = a;
      if (both) p[1] = b;
    }
  } else {
    const __nv_bfloat16 qa = __float2bfloat16_rn(a);
    const __nv_bfloat16 qb = __float2bfloat16_rn(b);
    if (paired) {
      __nv_bfloat162 v;
      v.x = qa;
      v.y = qb;
      *reinterpret_cast<__nv_bfloat162*>(p) = v;
    } else {
      p[0] = qa;
      if (both) p[1] = qb;
    }
  }
}

template <typename OutT>
__global__ void __launch_bounds__(kThreadsW, 1)
wgmma_conv_kernel(const __grid_constant__ CUtensorMap xmap,
                  const __grid_constant__ CUtensorMap wmap,
                  const ConvTiles p, const float* __restrict__ sx_ptr,
                  const float* __restrict__ sw,
                  const float* __restrict__ bias, OutT* __restrict__ out) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  int8_t* sa = reinterpret_cast<int8_t*>(smem);               // [stage]
  int8_t* sb = sa + kStages * kBytesA;                         // [stage]
  uint64_t* full = reinterpret_cast<uint64_t*>(sb + kStages * kBytesB);
  uint64_t* empty = full + kStages;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);        // one arrival a consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 8) {
    // producer: one lane issues every load
    if (lane != 0) return;
    int it = 0;
    for (int tile = blockIdx.x; tile < p.n_tiles; tile += gridDim.x) {
      int r = tile;
      const int ct = r % p.tiles_c;
      r /= p.tiles_c;
      const int tw = r % p.tiles_w;
      r /= p.tiles_w;
      const int th = r % p.tiles_h;
      const int tn = r / p.tiles_h;
      const int w0 = tw * p.TW * p.stride - p.pad;
      const int h0 = th * p.TH * p.stride - p.pad;
      for (int k = 0; k < p.k_iters; ++k, ++it) {
        const int s = it % kStages;
        mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
        // the whole boxes' bytes, zero-filled parts included
        mbar_expect_tx(&full[s], kBytesA + kBytesB);
        const int tap = k / p.chunks, cc = k - tap * p.chunks;
        const int i = tap / p.kw, j = tap - i * p.kw;
        tma_load_4d(sa + s * kBytesA, &xmap, &full[s], cc * kChunk,
                    w0 + j * p.dil, h0 + i * p.dil, tn * p.TN);
        tma_load_3d(sb + s * kBytesB, &wmap, &full[s], cc * kChunk, tap,
                    ct * kTileN);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows [64 wg, 64 wg + 64) of the tile
  const int wg = warp >> 2, t = threadIdx.x & 127;
  const float sx = *sx_ptr;
  const bool paired = (p.Cout & 1) == 0;
  int acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0;
  int it = 0;
  for (int tile = blockIdx.x; tile < p.n_tiles; tile += gridDim.x) {
    for (int k = 0; k < p.k_iters; ++k, ++it) {
      const int s = it % kStages;
      mbar_wait(&full[s], (it / kStages) & 1);
      const uint64_t da = smem_desc(sa + s * kBytesA + wg * 64 * kChunk);
      const uint64_t db = smem_desc(sb + s * kBytesB);
      fence_acc(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kChunk / 32; ++kk)   // 32 bytes a step
        wgmma_m64n256k32(acc, da + 2 * kk, db + 2 * kk, k > 0 || kk > 0);
      wgmma_commit();
      fence_acc(acc);
      wgmma_wait<1>();                // the previous stage's products done
      if (k > 0 && t == 0) mbar_arrive(&empty[(it - 1) % kStages]);
    }
    wgmma_wait<0>();
    fence_acc(acc);
    if (t == 0) mbar_arrive(&empty[(it - 1) % kStages]);

    // epilogue: thread t holds rows r0 and r0 + 8 of its warpgroup's half,
    // channels 8 j + 2 (t % 4) and the next, j < 32
    int r = tile;
    const int ct = r % p.tiles_c;
    r /= p.tiles_c;
    const int tw = r % p.tiles_w;
    r /= p.tiles_w;
    const int th = r % p.tiles_h;
    const int tn = r / p.tiles_h;
    long long base[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = wg * 64 + (t >> 5) * 16 + ((t & 31) >> 2) + h * 8;
      const int n = tn * p.TN + row / (p.TH * p.TW);
      const int rem = row % (p.TH * p.TW);
      const int ho = th * p.TH + rem / p.TW;
      const int wo = tw * p.TW + rem % p.TW;
      base[h] = (n < p.N && ho < p.Ho && wo < p.Wo)
                    ? ((static_cast<long long>(n) * p.Ho + ho) * p.Wo + wo) *
                          p.Cout
                    : -1;
    }
    const int c_base = ct * kTileN + (t & 3) * 2;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int col = c_base + j * 8;
      if (col >= p.Cout) continue;
      const bool both = col + 1 < p.Cout;
      const float s0 = __fmul_rn(sx, sw[col]);
      const float s1 = both ? __fmul_rn(sx, sw[col + 1]) : 0.0f;
      const float b0 = bias != nullptr ? bias[col] : 0.0f;
      const float b1 = (bias != nullptr && both) ? bias[col + 1] : 0.0f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (base[h] < 0) continue;
        float y0 = __fmul_rn(__int2float_rn(acc[j * 4 + h * 2]), s0);
        float y1 = __fmul_rn(__int2float_rn(acc[j * 4 + h * 2 + 1]), s1);
        if (bias != nullptr) {
          y0 = __fadd_rn(y0, b0);
          y1 = __fadd_rn(y1, b1);
        }
        store_pair(out + base[h] + col, y0, y1, both, paired && both);
      }
    }
  }
}

// A tensor map over an int8 tensor: dims innermost first, byte strides of
// dims 1.., the box, element strides; 128-byte swizzle, zeros outside.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f,
                                         12000, cudaEnableDefault,
                                         &q) == cudaSuccess &&
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f,
                                cudaEnableDefault, &q) == cudaSuccess &&
#endif
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(f);
  }
  return fn;
}

// Error codes of the wgmma route beyond CUDA's: no driver entry point,
// an operand not 16-byte aligned, and 20000 + the CUresult of a refused
// tensor map.
constexpr int kErrNoEncode = 10001;
constexpr int kErrAlign = 10002;
constexpr int kErrMap = 20000;

int encode(CUtensorMap* map, const void* base, int rank,
           const cuuint64_t* dims, const cuuint64_t* strides,
           const cuuint32_t* box, const cuuint32_t* elem) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return kErrNoEncode;
  const CUresult rc = fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, rank,
                         const_cast<void*>(base), dims, strides, box, elem,
                         CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? 0 : kErrMap + static_cast<int>(rc);
}

template <typename OutT>
int launch_wgmma(const int8_t* xq, const int8_t* wq, const float* sx,
                 const float* sw, const float* bias, void* out, int N, int H,
                 int W, int C, int Cout, int kh, int kw, int stride, int pad,
                 int dil, int Ho, int Wo, int TW, int TH, int TN,
                 cudaStream_t st) {
  if (reinterpret_cast<uintptr_t>(xq) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(wq) % 16 != 0)
    return kErrAlign;
  CUtensorMap xmap, wmap;
  const cuuint64_t xdims[4] = {static_cast<cuuint64_t>(C),
                               static_cast<cuuint64_t>(W),
                               static_cast<cuuint64_t>(H),
                               static_cast<cuuint64_t>(N)};
  const cuuint64_t xstrides[3] = {static_cast<cuuint64_t>(C),
                                  static_cast<cuuint64_t>(C) * W,
                                  static_cast<cuuint64_t>(C) * W * H};
  const cuuint32_t xbox[4] = {kChunk, static_cast<cuuint32_t>(TW * stride),
                              static_cast<cuuint32_t>(TH * stride),
                              static_cast<cuuint32_t>(TN)};
  const cuuint32_t xelem[4] = {1, static_cast<cuuint32_t>(stride),
                               static_cast<cuuint32_t>(stride), 1};
  int rc = encode(&xmap, xq, 4, xdims, xstrides, xbox, xelem);
  if (rc != 0) return rc;
  const int taps = kh * kw;
  const cuuint64_t wdims[3] = {static_cast<cuuint64_t>(C),
                               static_cast<cuuint64_t>(taps),
                               static_cast<cuuint64_t>(Cout)};
  const cuuint64_t wstrides[2] = {static_cast<cuuint64_t>(C),
                                  static_cast<cuuint64_t>(C) * taps};
  const cuuint32_t wbox[3] = {kChunk, 1, kTileN};
  const cuuint32_t welem[3] = {1, 1, 1};
  rc = encode(&wmap, wq, 3, wdims, wstrides, wbox, welem);
  if (rc != 0) return rc;

  ConvTiles p;
  p.Ho = Ho;
  p.Wo = Wo;
  p.Cout = Cout;
  p.N = N;
  p.kw = kw;
  p.chunks = (C + kChunk - 1) / kChunk;
  p.k_iters = taps * p.chunks;
  p.stride = stride;
  p.pad = pad;
  p.dil = dil;
  p.TW = TW;
  p.TH = TH;
  p.TN = TN;
  p.tiles_w = (Wo + TW - 1) / TW;
  p.tiles_h = (Ho + TH - 1) / TH;
  p.tiles_c = (Cout + kTileN - 1) / kTileN;
  const long long tiles = static_cast<long long>(p.tiles_c) * p.tiles_w *
                          p.tiles_h * ((N + TN - 1) / TN);
  if (tiles > (1ll << 31) - 1) return static_cast<int>(cudaErrorInvalidValue);
  p.n_tiles = static_cast<int>(tiles);

  auto kernel = wgmma_conv_kernel<OutT>;
  static int resident = 0;            // blocks the card holds, found once
  if (resident == 0) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemW);
    if (e != cudaSuccess) return static_cast<int>(e);
    resident = resident_blocks(kernel, kThreadsW, kSmemW, 1 << 20);
    if (resident <= 0) return static_cast<int>(cudaErrorUnknown);
  }
  const int grid = p.n_tiles < resident ? p.n_tiles : resident;
  kernel<<<grid, kThreadsW, kSmemW, st>>>(xmap, wmap, p, sx, sw, bias,
                                          static_cast<OutT*>(out));
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------ convolution, gather route

constexpr int BM = 128;            // output pixels a block
constexpr int BN = 128;            // output channels a block
constexpr int BK = 64;             // K bytes a stage
constexpr int LDS = BK + 16;       // shared row stride (bytes)
constexpr int kThreadsG = 256;     // 8 warps: 2 (M) x 4 (N)
constexpr int WM = 64, WN = 32;    // a warp's tile
constexpr int MT = WM / 16, NT = WN / 8;

struct Shape {
  int N, H, W, C, Cout, kh, kw, stride, pad, dil, Ho, Wo, M, K;
};

__device__ __forceinline__ void mma_s8(int* c, const unsigned* a,
                                       const unsigned* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The input position of one output pixel (row of A): the image's offset
// and the top-left tap, or h0 = INT_MIN/2 for a row past M.
struct Row {
  long long base;
  int h0, w0;
};

__device__ __forceinline__ Row row_of(const Shape& s, int m) {
  Row r;
  if (m >= s.M) {
    r.base = 0;
    r.h0 = -(1 << 29);
    r.w0 = 0;
    return r;
  }
  const int hw = s.Ho * s.Wo;
  const int n = m / hw, rem = m - n * hw;
  const int ho = rem / s.Wo, wo = rem - ho * s.Wo;
  r.base = static_cast<long long>(n) * s.H * s.W * s.C;
  r.h0 = ho * s.stride - s.pad;
  r.w0 = wo * s.stride - s.pad;
  return r;
}

// Offset of A[row, k] in xq, or -1 where it is a zero (padding, k >= K).
__device__ __forceinline__ long long a_offset(const Shape& s, const Row& r,
                                              int k) {
  if (k >= s.K) return -1;
  const int tap = k / s.C, ci = k - tap * s.C;
  const int i = tap / s.kw, j = tap - i * s.kw;
  const int h = r.h0 + i * s.dil, w = r.w0 + j * s.dil;
  if (h < 0 || h >= s.H || w < 0 || w >= s.W) return -1;
  return r.base + (static_cast<long long>(h) * s.W + w) * s.C + ci;
}

// One stage: A [BM][LDS] and B [BN][LDS] bytes. Thread t fills bytes
// 16 (t & 3) .. +16 of rows t / 4 and t / 4 + 64 of both.
__device__ __forceinline__ void gather_stage(const Shape& s,
                                             const int8_t* __restrict__ xq,
                                             const int8_t* __restrict__ wq,
                                             int8_t* As, int8_t* Bs,
                                             const Row* rows, int n0,
                                             int k0) {
  const int t = threadIdx.x;
  const int kc = k0 + (t & 3) * 16;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = (t >> 2) + r * 64;
    int8_t* a_dst = As + row * LDS + (t & 3) * 16;
    int8_t* b_dst = Bs + row * LDS + (t & 3) * 16;
    const int col = n0 + row;
#pragma unroll 4
    for (int e = 0; e < 16; ++e) {
      const long long off = a_offset(s, rows[r], kc + e);
      a_dst[e] = off >= 0 ? xq[off] : static_cast<int8_t>(0);
      b_dst[e] = (col < s.Cout && kc + e < s.K)
                     ? wq[static_cast<long long>(col) * s.K + kc + e]
                     : static_cast<int8_t>(0);
    }
  }
}

__device__ __forceinline__ unsigned lds32(const int8_t* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

template <typename OutT>
__global__ void __launch_bounds__(kThreadsG)
gather_conv_kernel(Shape s, const int8_t* __restrict__ xq,
                   const int8_t* __restrict__ wq,
                   const float* __restrict__ sx_ptr,
                   const float* __restrict__ sw,
                   const float* __restrict__ bias, OutT* __restrict__ out) {
  __shared__ __align__(16) int8_t smem[(BM + BN) * LDS];
  int8_t* As = smem;
  int8_t* Bs = smem + BM * LDS;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int wm = (warp >> 2) * WM, wn = (warp & 3) * WN;

  Row rows[2];
  rows[0] = row_of(s, m0 + (t >> 2));
  rows[1] = row_of(s, m0 + (t >> 2) + 64);

  int acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  for (int k0 = 0; k0 < s.K; k0 += BK) {
    gather_stage(s, xq, wq, As, Bs, rows, n0, k0);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      unsigned a[MT][4], b[NT][2];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int8_t* p = As + (wm + i * 16 + g) * LDS + kk + q * 4;
        a[i][0] = lds32(p);
        a[i][1] = lds32(p + 8 * LDS);
        a[i][2] = lds32(p + 16);
        a[i][3] = lds32(p + 8 * LDS + 16);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int8_t* p = Bs + (wn + j * 8 + g) * LDS + kk + q * 4;
        b[j][0] = lds32(p);
        b[j][1] = lds32(p + 16);
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_s8(acc[i][j], a[i], b[j]);
    }
    __syncthreads();
  }

  const float sx = *sx_ptr;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = n0 + wn + j * 8 + q * 2 + e;
      if (col >= s.Cout) continue;
      const float scale = __fmul_rn(sx, sw[col]);
      const float b = bias != nullptr ? bias[col] : 0.0f;
#pragma unroll
      for (int i = 0; i < MT; ++i) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = m0 + wm + i * 16 + g + h * 8;
          if (m >= s.M) continue;
          float y = __fmul_rn(__int2float_rn(acc[i][j][h * 2 + e]), scale);
          if (bias != nullptr) y = __fadd_rn(y, b);
          if constexpr (sizeof(OutT) == 4)
            out[static_cast<long long>(m) * s.Cout + col] = y;
          else
            out[static_cast<long long>(m) * s.Cout + col] =
                __float2bfloat16_rn(y);
        }
      }
    }
  }
}

template <typename OutT>
int launch_gather(const int8_t* xq, const int8_t* wq, const float* sx,
                  const float* sw, const float* bias, void* out, int N,
                  int H, int W, int C, int Cout, int kh, int kw, int stride,
                  int pad, int dil, int Ho, int Wo, cudaStream_t st) {
  const Shape s{N, H, W, C, Cout, kh, kw, stride, pad, dil, Ho, Wo,
                N * Ho * Wo, kh * kw * C};
  const dim3 grid((s.M + BM - 1) / BM, (Cout + BN - 1) / BN);
  gather_conv_kernel<OutT><<<grid, kThreadsG, 0, st>>>(
      s, xq, wq, sx, sw, bias, static_cast<OutT*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: n elements (NHWC), f32 (x_bf16 = 0) or bf16 (1). scratch: at least
// one float of device memory, scratch_len of them (the max pass's blocks
// are at most that many). Writes sx [1] f32 and xq [n] int8. Returns the
// CUDA error of the launches (0 = none).
extern "C" int zp_quantize_act(const void* x, int x_bf16, long long n,
                               float* scratch, int scratch_len, float* sx,
                               int8_t* xq, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t rc =
      x_bf16 ? launch_quantize<__nv_bfloat16>(x, n, scratch, scratch_len,
                                              sx, xq, st)
             : launch_quantize<float>(x, n, scratch, scratch_len, sx, xq,
                                      st);
  return static_cast<int>(rc);
}

// xq [N, H, W, C] int8, wq [Cout, kh, kw, C] int8, sx [1], sw [Cout],
// bias [Cout] or null, all f32; out [N, Ho, Wo, Cout], f32 (out_bf16 = 0)
// or bf16 (1). Square stride, padding and dilation. route 0 is "wgmma"
// with a tile of TW x TH x TN output pixels (TW * TH * TN = 128; needs
// C % 16 == 0, stride <= 2 and 16-byte aligned operands), route 1 is
// "gather" (TW, TH, TN unread). Returns 0, a CUDA error, or one of the
// wgmma route's codes above.
extern "C" int zp_int8_conv2d(const int8_t* xq, const int8_t* wq,
                              const float* sx, const float* sw,
                              const float* bias, void* out, int out_bf16,
                              int N, int H, int W, int C, int Cout, int kh,
                              int kw, int stride, int pad, int dil, int Ho,
                              int Wo, int route, int TW, int TH, int TN,
                              void* stream) {
  if (N * Ho * Wo <= 0 || Cout <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (route == 0)
    return out_bf16
               ? launch_wgmma<__nv_bfloat16>(xq, wq, sx, sw, bias, out, N, H,
                                             W, C, Cout, kh, kw, stride, pad,
                                             dil, Ho, Wo, TW, TH, TN, st)
               : launch_wgmma<float>(xq, wq, sx, sw, bias, out, N, H, W, C,
                                     Cout, kh, kw, stride, pad, dil, Ho, Wo,
                                     TW, TH, TN, st);
  return out_bf16
             ? launch_gather<__nv_bfloat16>(xq, wq, sx, sw, bias, out, N, H,
                                            W, C, Cout, kh, kw, stride, pad,
                                            dil, Ho, Wo, st)
             : launch_gather<float>(xq, wq, sx, sw, bias, out, N, H, W, C,
                                    Cout, kh, kw, stride, pad, dil, Ho, Wo,
                                    st);
}

// out: resident blocks per SM, threads a block, static shared memory a
// block (bytes), registers a thread, local memory a thread (bytes),
// dynamic shared memory a block (bytes), of the wgmma route's bf16-output
// kernel (route 0) or the gather route's (route 1).
extern "C" int zp_int8_conv2d_occupancy(int route, int* out) {
  cudaFuncAttributes attr;
  const void* kernel =
      route == 0
          ? reinterpret_cast<const void*>(wgmma_conv_kernel<__nv_bfloat16>)
          : reinterpret_cast<const void*>(gather_conv_kernel<__nv_bfloat16>);
  const int threads = route == 0 ? kThreadsW : kThreadsG;
  const int dyn = route == 0 ? kSmemW : 0;
  cudaError_t rc;
  if (route == 0) {
    rc = cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              dyn);
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  rc = cudaFuncGetAttributes(&attr, kernel);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  int blocks = 0;
  rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                     threads, dyn);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  out[0] = blocks;
  out[1] = threads;
  out[2] = static_cast<int>(attr.sharedSizeBytes);
  out[3] = attr.numRegs;
  out[4] = static_cast<int>(attr.localSizeBytes);
  out[5] = dyn;
  return 0;
}
