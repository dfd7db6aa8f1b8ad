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
//   xq = clamp(rint(x / sx), -127, 127), x NHWC bf16 or f32. Two passes:
//   a grid reduction of |x| (block maxima, then atomicMax on the float's
//   bits, which orders like the floats because every value is >= 0) into
//   a scratch word, then the quantizing pass, whose every thread derives
//   sx from that word itself (block 0 also writes it out). sx stays on the
//   card: no host sync. IEEE division (__fdiv_rn) and rintf (half to even)
//   give the plain version's bits.
//   Bound: bytes (one read for the max, one read and an int8 write).
//
// zp_int8_conv2d: y[m, c] = float(acc[m, c]) * (sx * sw[c]) (+ b[c]) with
//   acc = sum_k A[m, k] B[k, c] in int32, M = N*Ho*Wo output pixels,
//   K = kh*kw*Cin taps (k = (i*kw + j)*Cin + ci), A the im2col of xq never
//   materialised, B = wq laid out [Cout][kh][kw][Cin], so both operands
//   are contiguous in K. A block computes a 128 x 128 tile of y: 8 warps
//   as 2 (M) x 4 (N), a warp 64 x 32 as 4 x 4 mma.sync m16n8k32 s8 tiles
//   with int32 accumulators in registers. K advances 64 bytes a stage
//   through two shared-memory stages (rows padded to 80 bytes, so the
//   fragment loads of a warp hit 32 banks): each thread gathers two
//   16-byte chunks of A (one tap's channels: the output pixel's input
//   position from stride, padding and dilation; a tap outside the image,
//   a row past M or a column past K gives zeros, XLA's zero padding of
//   xq) and two of B with cp.async while the warps multiply the other
//   stage. That needs Cin % 16 == 0 and 16-byte aligned operands; any
//   other Cin (v3's 1025-channel fuse) gathers byte by byte.
//   The epilogue rounds like the plain version: __int2float_rn, then
//   __fmul_rn by __fmul_rn(sx, sw[c]), then __fadd_rn of the bias, each
//   spelled out so that nvcc cannot contract them into an FMA, then
//   f32 or bf16 (__float2bfloat16_rn) NHWC stores.
//   Bound: operations at the network's shapes (upsample_2's 3x3 256->256
//   conv at 128^2 does 2*M*K*Cout = 19.3 GOP a crop against 8.4 MB
//   moved). This design is the simple one: mma.sync rather than wgmma,
//   cp.async rather than TMA, the quantizer a pass of its own.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -shared -Xcompiler -fPIC   (no --use_fast_math).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// --------------------------------------------------------- quantizer

constexpr int kQThreads = 256;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ float scale_of(const unsigned* amax_bits) {
  return __fdiv_rn(fmaxf(__uint_as_float(*amax_bits), 1e-8f), 127.0f);
}

__device__ __forceinline__ int8_t quantize(float v, float sx) {
  float q = rintf(__fdiv_rn(v, sx));
  q = fminf(fmaxf(q, -127.0f), 127.0f);
  return static_cast<int8_t>(static_cast<int>(q));
}

template <typename T>
__global__ void __launch_bounds__(kQThreads)
absmax_kernel(const T* __restrict__ x, long long n,
              unsigned* __restrict__ amax_bits) {
  float m = 0.0f;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += step)
    m = fmaxf(m, fabsf(to_float(x[i])));
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  __shared__ float warp_max[kQThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_max[warp] = m;
  __syncthreads();
  if (warp == 0) {
    m = lane < kQThreads / 32 ? warp_max[lane] : 0.0f;
    for (int off = 4; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    if (lane == 0) atomicMax(amax_bits, __float_as_uint(m));
  }
}

template <typename T>
__global__ void __launch_bounds__(kQThreads)
quantize_kernel(const T* __restrict__ x, long long n,
                const unsigned* __restrict__ amax_bits,
                float* __restrict__ sx_out, int8_t* __restrict__ xq) {
  const float sx = scale_of(amax_bits);
  if (blockIdx.x == 0 && threadIdx.x == 0) *sx_out = sx;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += step)
    xq[i] = quantize(to_float(x[i]), sx);
}

// ------------------------------------------------------- convolution

constexpr int BM = 128;            // output pixels a block
constexpr int BN = 128;            // output channels a block
constexpr int BK = 64;             // K bytes a stage
constexpr int LDS = BK + 16;       // shared row stride (bytes)
constexpr int kThreads = 256;      // 8 warps: 2 (M) x 4 (N)
constexpr int WM = 64, WN = 32;    // a warp's tile
constexpr int MT = WM / 16, NT = WN / 8;

struct Shape {
  int N, H, W, C, Cout, kh, kw, stride, pad, dil, Ho, Wo, M, K;
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

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

// One stage: A [BM][LDS] and B [BN][LDS] bytes. Thread t fills chunk
// (t & 3) of rows t / 4 and t / 4 + 64 of both.
template <bool kVec>
__device__ __forceinline__ void load_stage(const Shape& s,
                                           const int8_t* __restrict__ xq,
                                           const int8_t* __restrict__ wq,
                                           int8_t* As, int8_t* Bs,
                                           const Row* rows, int n0, int k0) {
  const int t = threadIdx.x;
  const int kc = k0 + (t & 3) * 16;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = (t >> 2) + r * 64;
    int8_t* a_dst = As + row * LDS + (t & 3) * 16;
    int8_t* b_dst = Bs + row * LDS + (t & 3) * 16;
    const int col = n0 + row;
    if (kVec) {
      const long long off = a_offset(s, rows[r], kc);
      cp_async16(a_dst, off >= 0 ? xq + off : xq, off >= 0 ? 16 : 0);
      const bool bval = col < s.Cout && kc < s.K;
      cp_async16(b_dst,
                 bval ? wq + static_cast<long long>(col) * s.K + kc : wq,
                 bval ? 16 : 0);
    } else {
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
}

__device__ __forceinline__ unsigned lds32(const int8_t* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

template <bool kVec, typename OutT>
__global__ void __launch_bounds__(kThreads)
int8_conv_kernel(Shape s, const int8_t* __restrict__ xq,
                 const int8_t* __restrict__ wq,
                 const float* __restrict__ sx_ptr,
                 const float* __restrict__ sw,
                 const float* __restrict__ bias, OutT* __restrict__ out) {
  __shared__ __align__(16) int8_t smem[2][(BM + BN) * LDS];
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

  const int stages = (s.K + BK - 1) / BK;
  load_stage<kVec>(s, xq, wq, smem[0], smem[0] + BM * LDS, rows, n0, 0);
  cp_async_commit();
  for (int kt = 0; kt < stages; ++kt) {
    if (kt + 1 < stages) {
      int8_t* nxt = smem[(kt + 1) & 1];
      load_stage<kVec>(s, xq, wq, nxt, nxt + BM * LDS, rows, n0,
                       (kt + 1) * BK);
    }
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();
    const int8_t* As = smem[kt & 1];
    const int8_t* Bs = As + BM * LDS;
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

template <bool kVec, typename OutT>
cudaError_t launch_conv(const Shape& s, const int8_t* xq, const int8_t* wq,
                        const float* sx, const float* sw, const float* bias,
                        void* out, cudaStream_t stream) {
  const dim3 grid((s.M + BM - 1) / BM, (s.Cout + BN - 1) / BN);
  int8_conv_kernel<kVec, OutT><<<grid, kThreads, 0, stream>>>(
      s, xq, wq, sx, sw, bias, static_cast<OutT*>(out));
  return cudaGetLastError();
}

}  // namespace

// x: n elements (NHWC), f32 (x_bf16 = 0) or bf16 (1). scratch: one
// 32-bit word of device memory (zeroed here). Writes sx [1] f32 and
// xq [n] int8. Returns the CUDA error of the launches (0 = none).
extern "C" int zp_quantize_act(const void* x, int x_bf16, long long n,
                               unsigned* scratch, float* sx, int8_t* xq,
                               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t rc = cudaMemsetAsync(scratch, 0, sizeof(unsigned), st);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const long long want = (n + kQThreads * 8 - 1) / (kQThreads * 8);
  const int blocks = static_cast<int>(want < 1 ? 1
                                      : want > 132 * 16 ? 132 * 16
                                                        : want);
  if (x_bf16) {
    const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
    absmax_kernel<<<blocks, kQThreads, 0, st>>>(xb, n, scratch);
    rc = cudaGetLastError();
    if (rc != cudaSuccess) return static_cast<int>(rc);
    quantize_kernel<<<blocks, kQThreads, 0, st>>>(xb, n, scratch, sx, xq);
  } else {
    const float* xf = static_cast<const float*>(x);
    absmax_kernel<<<blocks, kQThreads, 0, st>>>(xf, n, scratch);
    rc = cudaGetLastError();
    if (rc != cudaSuccess) return static_cast<int>(rc);
    quantize_kernel<<<blocks, kQThreads, 0, st>>>(xf, n, scratch, sx, xq);
  }
  return static_cast<int>(cudaGetLastError());
}

// xq [N, H, W, C] int8, wq [Cout, kh, kw, C] int8, sx [1], sw [Cout],
// bias [Cout] or null, all f32; out [N, Ho, Wo, Cout], f32 (out_bf16 = 0)
// or bf16 (1). Square stride, padding and dilation.
extern "C" int zp_int8_conv2d(const int8_t* xq, const int8_t* wq,
                              const float* sx, const float* sw,
                              const float* bias, void* out, int out_bf16,
                              int N, int H, int W, int C, int Cout, int kh,
                              int kw, int stride, int pad, int dil, int Ho,
                              int Wo, void* stream) {
  Shape s{N, H, W, C, Cout, kh, kw, stride, pad, dil, Ho, Wo, N * Ho * Wo,
          kh * kw * C};
  if (s.M <= 0 || Cout <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = C % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(xq) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(wq) % 16 == 0;
  cudaError_t rc;
  if (vec)
    rc = out_bf16 ? launch_conv<true, __nv_bfloat16>(s, xq, wq, sx, sw,
                                                     bias, out, st)
                  : launch_conv<true, float>(s, xq, wq, sx, sw, bias, out,
                                             st);
  else
    rc = out_bf16 ? launch_conv<false, __nv_bfloat16>(s, xq, wq, sx, sw,
                                                      bias, out, st)
                  : launch_conv<false, float>(s, xq, wq, sx, sw, bias, out,
                                              st);
  return static_cast<int>(rc);
}

// out: resident blocks per SM, threads a block, static shared memory a
// block (bytes), registers a thread, local memory a thread (bytes), of
// the vectorised bf16-output convolution.
extern "C" int zp_int8_conv2d_occupancy(int* out) {
  cudaFuncAttributes attr;
  auto kernel = int8_conv_kernel<true, __nv_bfloat16>;
  cudaError_t rc = cudaFuncGetAttributes(&attr, kernel);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  int blocks = 0;
  rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                     kThreads, 0);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  out[0] = blocks;
  out[1] = kThreads;
  out[2] = static_cast<int>(attr.sharedSizeBytes);
  out[3] = attr.numRegs;
  out[4] = static_cast<int>(attr.localSizeBytes);
  return 0;
}
