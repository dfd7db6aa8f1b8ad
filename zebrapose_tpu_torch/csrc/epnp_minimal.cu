// Minimal-set EPnP for the RANSAC hypothesis stage: four threads per
// solve, the solve's state in shared memory.
//
// Replaces the Pallas TPU kernel zebrapose_tpu/ops/pnp_kernel.py::
// minimal_epnp_hypotheses (body _epnp_soa). Every step follows _epnp_soa
// in order, with the same floors (Cholesky 1e-12*max|diag|, +1e-6 on the
// trace-normalised MtM diagonal, 1e-9*trace in the least-squares solves,
// 1e-6*vmax + 1e-9 on the control-point variances, the 1e-20 / 1e-30 /
// 1e-8 / 1e-12 guards), the same iteration counts (4 subspace iterations,
// gn_iters Gauss-Newton steps, 12 polar steps), the same sorting network
// and the same candidate choice (NaN error -> +inf, strict <, so the
// earlier case wins ties).
//
// What bounds it: operations. A solve reads 39 floats and writes 12 but
// runs ~2.4e4 float operations, a dependent chain of 12x12 and smaller
// algebra; solves share nothing. Tensor cores and TMA have nothing to do
// here. What counts is how long a chain each thread runs, how many chains
// an SM keeps in flight, and that no lane of a warp idles.
//
// * A block holds 32 solves and 4 warps. Lane l of every warp works on
//   solve l; the warps split each solve along its own parallel axes: the
//   10 blocks of MtM's upper triangle; the 4 columns of the subspace
//   iteration (its four triangular solves are independent); the 6 rows of
//   L6x10; the 3 beta cases (start, Gauss-Newton, pose, polar,
//   reprojection error), one a warp. The short serial parts run on warp 0
//   alone: the 12x12 Cholesky (right-looking, every index known at compile
//   time, so its shared-memory loads and stores pipeline) and the
//   Gram-Schmidt of the four columns. Warps meet at __syncthreads; every
//   branch is uniform across a warp. A thread's chain is about a third of
//   the one-thread-per-solve chain.
//   (Four lanes of one warp per solve was tried first: lanes idle inside
//   their warp while others work (lane 3 through the beta cases) and the
//   four load the same shared values, so it lost to one thread per solve
//   at N >= 32768.)
// * Shared memory holds the inputs, MtM, its factor, V, the subspace
//   columns, L6x10 and rho: 247 floats (988 B) a solve, an odd count so the
//   32 lanes of a warp hit 32 banks; 31,616 B a block. The block stages
//   its points and intrinsics with coalesced loads (neighbouring threads on
//   neighbouring addresses) and writes R, t the same way.
// * Registers bound the occupancy: ptxas gives a thread 128 registers and
//   no spill under __launch_bounds__(128, 4), so 4 blocks (128 solves,
//   16 warps) fit an SM and N = 32768 takes two waves on 132 SMs. Capped
//   at 96, 80 or 64 registers (5, 6 or 8 blocks) it spills 0.2-1 KB a
//   thread and runs slower at every N measured.
// * The kernel reads fx, fy, cx, cy from Ks [N,3,3] itself: one launch is
//   the wrapper's only device work.
//
// Numerics against the plain version, each within a few ulps: every
// triangular solve multiplies by 1/L[i][i], computed once per factor, where
// the plain version divides by L[i][i]; that reciprocal of the pivot's
// square root is rsqrtf; the polar step takes gamma = rcbrtf(|det|) where
// the plain version takes powf(|det|, -1/3), and 1/gamma = gamma^2 |det|.
// The right-looking Cholesky subtracts the same products in the same order
// as the plain version's dot-product form.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -shared -Xcompiler -fPIC   (no --use_fast_math).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int S = 6;
constexpr int kSolves = 32;             // solves per block: a warp's lanes
constexpr int kWarps = 4;               // threads per solve, one a warp:
                                        // one per subspace column
constexpr int kThreads = kWarps * kSolves;   // 128
constexpr int kMinBlocks = 4;           // resident blocks per SM

// One solve's shared memory, in floats.
constexpr int oX = 0;          // [6][3] model points
constexpr int oU = 18;         // [6][2] pixels
constexpr int oCam = 30;       // fx, fy, cx, cy
constexpr int oC0 = 34;        // centroid [3]
constexpr int oScale = 37;     // control-point scales [3]
constexpr int oInvScale = 40;  // their reciprocals [3]
constexpr int oA = 43;         // 78: MtM, lower triangle by rows;
                               // then L6x10 [6][10] and rho [6] at +60;
                               // then the chosen R [9] and t [3]
constexpr int oW = 121;        // 78: Cholesky factor, lower triangle by
                               // rows, 1/L[i][i] on its diagonal;
                               // then V [12][4]
constexpr int oY = 199;        // 48: the subspace columns, Y[k][i] at
                               // 12 k + i; then the Rayleigh quotients
                               // and the case errors
constexpr int kStride = 247;   // odd: the 32 lanes of a warp, one solve
                               // each, hit 32 different banks

// Lower triangle packed by rows, i >= j.
__device__ __forceinline__ constexpr int tri(int i, int j) {
  return i * (i + 1) / 2 + j;
}

// jnp.maximum / jnp.minimum semantics: NaN propagates.
__device__ __forceinline__ float jmax(float a, float b) {
  return (isnan(a) || isnan(b)) ? a + b : fmaxf(a, b);
}
__device__ __forceinline__ float jmin(float a, float b) {
  return (isnan(a) || isnan(b)) ? a + b : fminf(a, b);
}
// jnp.sign semantics: -1, 0, 1, NaN for NaN.
__device__ __forceinline__ float jsign(float x) {
  return x > 0.f ? 1.f : (x < 0.f ? -1.f : x);
}

// Barycentric coordinates of point j (pnp._control_points, fast path).
__device__ __forceinline__ void alphas_of(const float* s, int j,
                                          const float (&c0)[3],
                                          const float (&inv_scale)[3],
                                          float (&a)[4]) {
  const float a1 = (s[oX + 3 * j + 0] - c0[0]) * inv_scale[0];
  const float a2 = (s[oX + 3 * j + 1] - c0[1]) * inv_scale[1];
  const float a3 = (s[oX + 3 * j + 2] - c0[2]) * inv_scale[2];
  a[0] = 1.0f - a1 - a2 - a3;
  a[1] = a1;
  a[2] = a2;
  a[3] = a3;
}

// In-place Cholesky (lower) of a small register matrix,
// fast_linalg.cholesky_small semantics; inv_diag[j] = 1 / L[j][j].
template <int K>
__device__ __forceinline__ void chol_small(float (&A)[K][K],
                                           float (&inv_diag)[K]) {
  float amax = fabsf(A[0][0]);
#pragma unroll
  for (int j = 1; j < K; ++j) amax = jmax(amax, fabsf(A[j][j]));
  const float floor_ = 1e-12f * jmax(amax, 1e-30f);
#pragma unroll
  for (int j = 0; j < K; ++j) {
    float s = A[j][j];
#pragma unroll
    for (int k = 0; k < j; ++k) s = s - A[j][k] * A[j][k];
    const float inv_d = rsqrtf(jmax(s, floor_));
    inv_diag[j] = inv_d;
#pragma unroll
    for (int i = j + 1; i < K; ++i) {
      float r = A[i][j];
#pragma unroll
      for (int k = 0; k < j; ++k) r = r - A[i][k] * A[j][k];
      A[i][j] = r * inv_d;
    }
  }
}

// (L L^T) x = b in place (x holds b on entry).
template <int K>
__device__ __forceinline__ void chol_solve_small(const float (&L)[K][K],
                                                 const float (&inv_diag)[K],
                                                 float (&x)[K]) {
#pragma unroll
  for (int i = 0; i < K; ++i) {
    float acc = x[i];
#pragma unroll
    for (int k = 0; k < i; ++k) acc = acc - L[i][k] * x[k];
    x[i] = acc * inv_diag[i];
  }
#pragma unroll
  for (int i = K - 1; i >= 0; --i) {
    float acc = x[i];
#pragma unroll
    for (int k = i + 1; k < K; ++k) acc = acc - L[k][i] * x[k];
    x[i] = acc * inv_diag[i];
  }
}

// Least squares Lm[:, cols] x = rho by 1e-9*trace-regularised normal
// equations (pnp._solve_ls).
template <int K>
__device__ __forceinline__ void solve_ls(const float* s, const int (&cols)[K],
                                         float (&x)[K]) {
  const float* Lm = s + oA;
  const float* rho = s + oA + 60;
  float ata[K][K];
#pragma unroll
  for (int i = 0; i < K; ++i) {
#pragma unroll
    for (int j = i; j < K; ++j) {
      float acc = Lm[cols[i]] * Lm[cols[j]];
#pragma unroll
      for (int r = 1; r < S; ++r)
        acc = acc + Lm[10 * r + cols[i]] * Lm[10 * r + cols[j]];
      ata[i][j] = acc;
      ata[j][i] = acc;
    }
  }
  float tr = ata[0][0];
#pragma unroll
  for (int i = 1; i < K; ++i) tr = tr + ata[i][i];
#pragma unroll
  for (int i = 0; i < K; ++i) ata[i][i] = ata[i][i] + 1e-9f * tr;
#pragma unroll
  for (int i = 0; i < K; ++i) {
    float acc = Lm[cols[i]] * rho[0];
#pragma unroll
    for (int r = 1; r < S; ++r) acc = acc + Lm[10 * r + cols[i]] * rho[r];
    x[i] = acc;
  }
  float inv_diag[K];
  chol_small<K>(ata, inv_diag);
  chol_solve_small<K>(ata, inv_diag, x);
}

// pnp._betas_case{1,2,3}: the closed-form start of one case.
__device__ __forceinline__ void beta_start(const float* s, int cs,
                                           float (&bs)[4]) {
  if (cs == 0) {
    const int cols[4] = {0, 1, 3, 6};
    float x[4];
    solve_ls<4>(s, cols, x);
    const float b1 = sqrtf(fabsf(x[0]));
    const float sg = jsign(x[0]) + (x[0] == 0.f ? 1.f : 0.f);
    const float inv_b1 = 1.0f / jmax(b1, 1e-12f);
    bs[0] = b1;
    bs[1] = sg * x[1] * inv_b1;
    bs[2] = sg * x[2] * inv_b1;
    bs[3] = sg * x[3] * inv_b1;
  } else if (cs == 1) {
    const int cols[3] = {0, 1, 2};
    float x[3];
    solve_ls<3>(s, cols, x);
    bs[0] = sqrtf(fabsf(x[0]));
    bs[1] = sqrtf(fabsf(x[2])) * jsign(x[1]) * jsign(x[0]);
    bs[2] = 0.f;
    bs[3] = 0.f;
  } else {
    const int cols[5] = {0, 1, 2, 3, 4};
    float x[5];
    solve_ls<5>(s, cols, x);
    const float b1 = sqrtf(fabsf(x[0]));
    bs[0] = b1;
    bs[1] = sqrtf(fabsf(x[2])) * jsign(x[1]) * jsign(x[0]);
    bs[2] = x[3] / jmax(b1, 1e-12f) * jsign(x[0]);
    bs[3] = 0.f;
  }
}

// pnp._gauss_newton_betas: the 6x4 Jacobian's normal equations are
// accumulated row by row, in the plain version's order.
__device__ __forceinline__ void gn_refine(const float* s, int gn_iters,
                                          float (&bs)[4]) {
  const float* rho = s + oA + 60;
  for (int it = 0; it < gn_iters; ++it) {
    const float b1 = bs[0], b2 = bs[1], b3 = bs[2], b4 = bs[3];
    const float prods[10] = {b1 * b1, b1 * b2, b2 * b2, b1 * b3, b2 * b3,
                             b3 * b3, b1 * b4, b2 * b4, b3 * b4, b4 * b4};
    float ata[4][4], atb[4];
#pragma unroll
    for (int r = 0; r < S; ++r) {
      const float* L = s + oA + 10 * r;
      const float J[4] = {
          2.f * b1 * L[0] + b2 * L[1] + b3 * L[3] + b4 * L[6],
          b1 * L[1] + 2.f * b2 * L[2] + b3 * L[4] + b4 * L[7],
          b1 * L[3] + b2 * L[4] + 2.f * b3 * L[5] + b4 * L[8],
          b1 * L[6] + b2 * L[7] + b3 * L[8] + 2.f * b4 * L[9]};
      float acc = L[0] * prods[0];
#pragma unroll
      for (int c = 1; c < 10; ++c) acc = acc + L[c] * prods[c];
      const float res = rho[r] - acc;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = i; j < 4; ++j)
          ata[i][j] = r == 0 ? J[i] * J[j] : ata[i][j] + J[i] * J[j];
        atb[i] = r == 0 ? J[i] * res : atb[i] + J[i] * res;
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < i; ++j) ata[i][j] = ata[j][i];
    const float tr = ata[0][0] + ata[1][1] + ata[2][2] + ata[3][3];
#pragma unroll
    for (int i = 0; i < 4; ++i) ata[i][i] = ata[i][i] + 1e-9f * tr;
    float inv_diag[4];
    chol_small<4>(ata, inv_diag);
    chol_solve_small<4>(ata, inv_diag, atb);
#pragma unroll
    for (int i = 0; i < 4; ++i) bs[i] = bs[i] + atb[i];
  }
}

__device__ __forceinline__ float det3(const float (&M)[3][3]) {
  return M[0][0] * (M[1][1] * M[2][2] - M[1][2] * M[2][1]) -
         M[0][1] * (M[1][0] * M[2][2] - M[1][2] * M[2][0]) +
         M[0][2] * (M[1][0] * M[2][1] - M[1][1] * M[2][0]);
}

// Cofactor matrix: C[i][j] = cofactor of M[i][j] (inv(M)^T = C / det).
__device__ __forceinline__ void cofactor3(const float (&M)[3][3],
                                          float (&C)[3][3]) {
  C[0][0] = M[1][1] * M[2][2] - M[1][2] * M[2][1];
  C[0][1] = M[1][2] * M[2][0] - M[1][0] * M[2][2];
  C[0][2] = M[1][0] * M[2][1] - M[1][1] * M[2][0];
  C[1][0] = M[0][2] * M[2][1] - M[0][1] * M[2][2];
  C[1][1] = M[0][0] * M[2][2] - M[0][2] * M[2][0];
  C[1][2] = M[0][1] * M[2][0] - M[0][0] * M[2][1];
  C[2][0] = M[0][1] * M[1][2] - M[0][2] * M[1][1];
  C[2][1] = M[0][2] * M[1][0] - M[0][0] * M[1][2];
  C[2][2] = M[0][0] * M[1][1] - M[0][1] * M[1][0];
}

// fast_linalg.polar_rotation: scaled Newton polar iteration, 12 steps.
__device__ __forceinline__ void polar_rotation(const float (&H)[3][3],
                                               float (&X)[3][3]) {
  const float flip = det3(H) < 0.f ? -1.f : 1.f;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    X[0][c] = H[0][c];
    X[1][c] = H[1][c];
    X[2][c] = flip * H[2][c];
  }
  float nsq = X[0][0] * X[0][0];
#pragma unroll
  for (int i = 1; i < 9; ++i) nsq = nsq + X[i / 3][i % 3] * X[i / 3][i % 3];
  const float inv_norm = 1.0f / jmax(sqrtf(nsq), 1e-20f);
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int c = 0; c < 3; ++c) X[r][c] = X[r][c] * inv_norm;
#pragma unroll 1
  for (int it = 0; it < 12; ++it) {
    const float d = det3(X);
    const float inv_d = 1.0f / (d == 0.f ? 1e-30f : d);
    float C[3][3];
    cofactor3(X, C);
    const float ad = jmax(fabsf(d), 1e-20f);
    const float gamma = rcbrtf(ad);
    const float inv_g = gamma * gamma * ad;     // ad^(1/3)
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
      for (int c = 0; c < 3; ++c)
        X[r][c] = 0.5f * (gamma * X[r][c] + C[r][c] * inv_d * inv_g);
  }
}

// pnp._pose_from_betas + fast Procrustes with unit weights.
__device__ __forceinline__ void pose_from_betas(const float* s,
                                                const float (&bs)[4],
                                                float (&R)[3][3],
                                                float (&t)[3]) {
  const float inv_s = 1.0f / S;
  const float* V = s + oW;
  const float c0[3] = {s[oC0], s[oC0 + 1], s[oC0 + 2]};
  const float inv_scale[3] = {s[oInvScale], s[oInvScale + 1],
                              s[oInvScale + 2]};
  float x[12];
#pragma unroll
  for (int i = 0; i < 12; ++i) {
    float acc = V[4 * i] * bs[0];
#pragma unroll
    for (int b = 1; b < 4; ++b) acc = acc + V[4 * i + b] * bs[b];
    x[i] = acc;
  }
  float pc[S][3];
#pragma unroll
  for (int j = 0; j < S; ++j) {
    float a[4];
    alphas_of(s, j, c0, inv_scale, a);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      float acc = a[0] * x[c];
#pragma unroll
      for (int k = 1; k < 4; ++k) acc = acc + a[k] * x[3 * k + c];
      pc[j][c] = acc;
    }
  }
  float zsum = pc[0][2];
#pragma unroll
  for (int j = 1; j < S; ++j) zsum = zsum + pc[j][2];
  const float flip = (zsum * inv_s) < 0.f ? -1.f : 1.f;
#pragma unroll
  for (int j = 0; j < S; ++j)
#pragma unroll
    for (int c = 0; c < 3; ++c) pc[j][c] = pc[j][c] * flip;
  float cc2[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float acc = pc[0][c];
#pragma unroll
    for (int j = 1; j < S; ++j) acc = acc + pc[j][c];
    cc2[c] = acc * inv_s;
  }
  float H[3][3];
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      float acc = (pc[0][r] - cc2[r]) * (s[oX + c] - c0[c]);
#pragma unroll
      for (int j = 1; j < S; ++j)
        acc = acc + (pc[j][r] - cc2[r]) * (s[oX + 3 * j + c] - c0[c]);
      H[r][c] = acc;
    }
  polar_rotation(H, R);
#pragma unroll
  for (int c = 0; c < 3; ++c)
    t[c] = cc2[c] - (R[c][0] * c0[0] + R[c][1] * c0[1] + R[c][2] * c0[2]);
}

__device__ __forceinline__ float reproj_err(const float* s,
                                            const float (&R)[3][3],
                                            const float (&t)[3]) {
  const float fx = s[oCam], fy = s[oCam + 1], cx = s[oCam + 2],
              cy = s[oCam + 3];
  float acc = 0.f;
#pragma unroll
  for (int j = 0; j < S; ++j) {
    const float* Xj = s + oX + 3 * j;
    const float pz = (R[2][0] * Xj[0] + R[2][1] * Xj[1] + R[2][2] * Xj[2]) + t[2];
    const float z = jmax(fabsf(pz), 1e-8f) * jsign(pz == 0.f ? 1.f : pz);
    const float inv_z = 1.0f / z;
    const float px = (R[0][0] * Xj[0] + R[0][1] * Xj[1] + R[0][2] * Xj[2]) + t[0];
    const float py = (R[1][0] * Xj[0] + R[1][1] * Xj[1] + R[1][2] * Xj[2]) + t[1];
    const float eu = fx * px * inv_z + cx - s[oU + 2 * j];
    const float ev = fy * py * inv_z + cy - s[oU + 2 * j + 1];
    acc = acc + eu * eu + ev * ev;
  }
  return acc * (1.0f / S);
}

template <int I1, int I2>
__device__ __forceinline__ void mtm_block(float* s, const float (&c0)[3],
                                          const float (&inv_scale)[3]) {
  const float fx = s[oCam], fy = s[oCam + 1], cx = s[oCam + 2],
              cy = s[oCam + 3];
  float m[3][3] = {};
#pragma unroll
  for (int j = 0; j < S; ++j) {
    const float du = cx - s[oU + 2 * j];
    const float dv = cy - s[oU + 2 * j + 1];
    // B^T B; its structural zeros at (0,1) and (1,0) are skipped
    const float btb[3][3] = {{fx * fx, 0.f, fx * du},
                             {0.f, fy * fy, fy * dv},
                             {fx * du, fy * dv, du * du + dv * dv}};
    float a[4];
    alphas_of(s, j, c0, inv_scale, a);
    const float aa = a[I1] * a[I2];
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        if ((r == 0 && c == 1) || (r == 1 && c == 0)) continue;
        m[r][c] = m[r][c] + aa * btb[r][c];
      }
  }
  // upper entry (3 I1 + r, 3 I2 + c) is lower entry (3 I2 + c, 3 I1 + r)
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int c = 0; c < 3; ++c)
      if (I1 < I2 || r <= c) s[oA + tri(3 * I2 + c, 3 * I1 + r)] = m[r][c];
}

// Row r = pair (P, Q) of L [6][10] and rho [6] (pnp._l6x10_and_rho).
template <int P, int Q>
__device__ __forceinline__ void l6x10_row(float* s, int r) {
  const float* V = s + oW;
  float dv[3][4];
#pragma unroll
  for (int x = 0; x < 3; ++x)
#pragma unroll
    for (int b = 0; b < 4; ++b)
      dv[x][b] = V[4 * (3 * P + x) + b] - V[4 * (3 * Q + x) + b];
  float dots[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = a; b < 4; ++b)
      dots[a][b] = dv[0][a] * dv[0][b] + dv[1][a] * dv[1][b] + dv[2][a] * dv[2][b];
  float* L = s + oA + 10 * r;
  L[0] = dots[0][0];
  L[1] = 2.f * dots[0][1];
  L[2] = dots[1][1];
  L[3] = 2.f * dots[0][2];
  L[4] = 2.f * dots[1][2];
  L[5] = dots[2][2];
  L[6] = 2.f * dots[0][3];
  L[7] = 2.f * dots[1][3];
  L[8] = 2.f * dots[2][3];
  L[9] = dots[3][3];
  // world control points: ctrl[0] = c0, ctrl[i] = c0 + scale_i e_i
  const float sq = s[oScale + Q - 1];
  if (P == 0) {
    s[oA + 60 + r] = sq * sq;
  } else {
    const float sp = s[oScale + P - 1];
    s[oA + 60 + r] = sp * sp + sq * sq;
  }
}

// One beta case end to end: start, Gauss-Newton, pose; its error.
template <int CS>
__device__ __forceinline__ float run_case(const float* s, int gn_iters,
                                          float (&R)[3][3], float (&t)[3]) {
  float bs[4];
  beta_start(s, CS, bs);
  gn_refine(s, gn_iters, bs);
  pose_from_betas(s, bs, R, t);
  const float e = reproj_err(s, R, t);
  return isnan(e) ? INFINITY : e;
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
epnp_minimal_kernel(const float* __restrict__ p3, const float* __restrict__ p2,
                    const float* __restrict__ Ks, float* __restrict__ Rout,
                    float* __restrict__ tout, int n, int gn_iters) {
  __shared__ float sm[kSolves * kStride];
  const int tid = threadIdx.x;
  const int w = tid / kSolves;            // the warp: which part of a solve
  float* s = sm + (tid % kSolves) * kStride;   // the lane: which solve
  float* Y = s + oY;
  const long long first = static_cast<long long>(blockIdx.x) * kSolves;
  const int nb = n - first < kSolves ? static_cast<int>(n - first) : kSolves;

  // ---- stage the block's inputs: neighbouring threads, neighbouring
  // addresses; solves past n get zeros and are never written out --------
  for (int i = tid; i < kSolves * 3 * S; i += kThreads)
    sm[(i / (3 * S)) * kStride + oX + i % (3 * S)] =
        i < nb * 3 * S ? p3[first * 3 * S + i] : 0.f;
  for (int i = tid; i < kSolves * 2 * S; i += kThreads)
    sm[(i / (2 * S)) * kStride + oU + i % (2 * S)] =
        i < nb * 2 * S ? p2[first * 2 * S + i] : 0.f;
  for (int i = tid; i < kSolves * 9; i += kThreads) {
    // K[0][0], K[1][1], K[0][2], K[1][2] -> fx, fy, cx, cy
    const int e = i % 9;
    const int c = e == 0 ? 0 : e == 4 ? 1 : e == 2 ? 2 : e == 5 ? 3 : -1;
    if (c >= 0)
      sm[(i / 9) * kStride + oCam + c] = i < nb * 9 ? Ks[first * 9 + i] : 0.f;
  }
  __syncthreads();

  // ---- control points (pnp._control_points): every warp ---------------
  float c0[3], inv_scale[3];
  {
    const float inv_s = 1.0f / S;
    float var[3], scale[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      float acc = s[oX + c];
#pragma unroll
      for (int j = 1; j < S; ++j) acc = acc + s[oX + 3 * j + c];
      c0[c] = acc * inv_s;
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      float d = s[oX + c] - c0[c];
      float acc = d * d;
#pragma unroll
      for (int j = 1; j < S; ++j) {
        d = s[oX + 3 * j + c] - c0[c];
        acc = acc + d * d;
      }
      var[c] = acc * inv_s;
    }
    const float vmax = jmax(jmax(var[0], var[1]), var[2]);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      scale[c] = sqrtf(jmax(var[c], 1e-6f * vmax + 1e-9f));
      inv_scale[c] = 1.0f / scale[c];
    }
    if (w == 0) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        s[oC0 + c] = c0[c];
        s[oScale + c] = scale[c];
        s[oInvScale + c] = inv_scale[c];
      }
    }
  }

  // ---- MtM (pnp._build_mtm): its 10 upper 3x3 blocks, a warp each ----
#pragma unroll
  for (int p = w; p < 10; p += kWarps) {
    switch (p) {
      case 0: mtm_block<0, 0>(s, c0, inv_scale); break;
      case 1: mtm_block<0, 1>(s, c0, inv_scale); break;
      case 2: mtm_block<0, 2>(s, c0, inv_scale); break;
      case 3: mtm_block<0, 3>(s, c0, inv_scale); break;
      case 4: mtm_block<1, 1>(s, c0, inv_scale); break;
      case 5: mtm_block<1, 2>(s, c0, inv_scale); break;
      case 6: mtm_block<1, 3>(s, c0, inv_scale); break;
      case 7: mtm_block<2, 2>(s, c0, inv_scale); break;
      case 8: mtm_block<2, 3>(s, c0, inv_scale); break;
      default: mtm_block<3, 3>(s, c0, inv_scale); break;
    }
  }
  __syncthreads();

  // ---- bottom-4 eigen-subspace (fast_linalg.smallest_subspace) --------
  // Warp 0 factors B = MtM / s0 + 1e-6 I in place, right-looking: each
  // pivot scales its column and updates the trailing triangle, every
  // index known at compile time, so loads and stores pipeline and few
  // values stay live. It subtracts the same products in the same order
  // as the plain version's dot-product form. 1/L[i][i] goes on the
  // diagonal.
  float* W = s + oW;
  if (w == 0) {
    float tr = s[oA + tri(0, 0)];
#pragma unroll
    for (int i = 1; i < 12; ++i) tr = tr + s[oA + tri(i, i)];
    const float inv_s0 = 1.0f / jmax(tr * (1.0f / 12.0f), 1e-30f);
    float amax = 0.f;
#pragma unroll
    for (int i = 0; i < 12; ++i) {
#pragma unroll
      for (int j = 0; j <= i; ++j) {
        // the two roundings of the plain version
        float b = __fmul_rn(s[oA + tri(i, j)], inv_s0);
        if (j == i) {
          b = __fadd_rn(b, 1e-6f);
          amax = i == 0 ? fabsf(b) : jmax(amax, fabsf(b));
        }
        W[tri(i, j)] = b;
      }
    }
    const float floor_ = 1e-12f * jmax(amax, 1e-30f);
#pragma unroll
    for (int k = 0; k < 12; ++k) {
      const float inv_d = rsqrtf(jmax(W[tri(k, k)], floor_));
      float l[12];
#pragma unroll
      for (int i = k + 1; i < 12; ++i) {
        l[i] = W[tri(i, k)] * inv_d;
        W[tri(i, k)] = l[i];
      }
#pragma unroll
      for (int i = k + 1; i < 12; ++i)
#pragma unroll
        for (int j = k + 1; j <= i; ++j)
          W[tri(i, j)] = W[tri(i, j)] - l[i] * l[j];
      W[tri(k, k)] = inv_d;
    }
  }
  __syncthreads();
  // Warp k iterates column k of Y = eye(12, 4) + 0.01.
  float y[12];
#pragma unroll
  for (int i = 0; i < 12; ++i) y[i] = i == w ? 1.01f : 0.01f;
#pragma unroll 1
  for (int it = 0; it < 4; ++it) {
#pragma unroll
    for (int i = 0; i < 12; ++i) {
      float acc = y[i];
#pragma unroll
      for (int k = 0; k < i; ++k) acc = acc - W[tri(i, k)] * y[k];
      y[i] = acc * W[tri(i, i)];
    }
#pragma unroll
    for (int i = 11; i >= 0; --i) {
      float acc = y[i];
#pragma unroll
      for (int k = i + 1; k < 12; ++k) acc = acc - W[tri(k, i)] * y[k];
      y[i] = acc * W[tri(i, i)];
    }
    // Gram-Schmidt in column order (fast_linalg._gram_schmidt): the warps
    // leave their solved columns in Y, warp 0 orthonormalises the four in
    // place, and every warp takes its own back.
#pragma unroll
    for (int i = 0; i < 12; ++i) Y[12 * w + i] = y[i];
    __syncthreads();
    if (w == 0) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        float v[12];
#pragma unroll
        for (int i = 0; i < 12; ++i) v[i] = Y[12 * k + i];
#pragma unroll
        for (int u = 0; u < k; ++u) {
          float dot = v[0] * Y[12 * u];
#pragma unroll
          for (int i = 1; i < 12; ++i) dot = dot + v[i] * Y[12 * u + i];
#pragma unroll
          for (int i = 0; i < 12; ++i) v[i] = v[i] - dot * Y[12 * u + i];
        }
        float nsq = v[0] * v[0];
#pragma unroll
        for (int i = 1; i < 12; ++i) nsq = nsq + v[i] * v[i];
        const float inv_n = 1.0f / jmax(sqrtf(nsq), 1e-20f);
#pragma unroll
        for (int i = 0; i < 12; ++i) Y[12 * k + i] = v[i] * inv_n;
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 12; ++i) y[i] = Y[12 * w + i];
  }
  // Rayleigh quotient of the ORIGINAL MtM, a column a warp; every warp
  // sorts the four (ascending) and stores its column at its rank: V.
  {
    float rq = 0.f;
#pragma unroll
    for (int i = 0; i < 12; ++i) {
      float Ay = s[oA + tri(i, 0)] * y[0];
#pragma unroll
      for (int j = 1; j < 12; ++j)
        Ay = Ay + s[oA + (i >= j ? tri(i, j) : tri(j, i))] * y[j];
      rq = rq + y[i] * Ay;
    }
    __syncthreads();            // every warp has its column back from Y
    Y[w] = rq;
    __syncthreads();
    float r4[4] = {Y[0], Y[1], Y[2], Y[3]};
    int perm[4] = {0, 1, 2, 3};
    const int net[5][2] = {{0, 1}, {2, 3}, {0, 2}, {1, 3}, {1, 2}};
#pragma unroll
    for (int e = 0; e < 5; ++e) {
      const int a = net[e][0], b = net[e][1];
      if (r4[b] < r4[a]) {
        const float tq = r4[a];
        r4[a] = r4[b];
        r4[b] = tq;
        const int tp = perm[a];
        perm[a] = perm[b];
        perm[b] = tp;
      }
    }
    const int rank = perm[0] == w ? 0 : perm[1] == w ? 1 : perm[2] == w ? 2 : 3;
#pragma unroll
    for (int i = 0; i < 12; ++i) W[4 * i + rank] = y[i];
    __syncthreads();
  }

  // ---- L [6][10] and rho [6], a row a warp -----------------------------
#pragma unroll
  for (int r = w; r < 6; r += kWarps) {
    switch (r) {
      case 0: l6x10_row<0, 1>(s, 0); break;
      case 1: l6x10_row<0, 2>(s, 1); break;
      case 2: l6x10_row<0, 3>(s, 2); break;
      case 3: l6x10_row<1, 2>(s, 3); break;
      case 4: l6x10_row<1, 3>(s, 4); break;
      default: l6x10_row<2, 3>(s, 5); break;
    }
  }
  __syncthreads();

  // ---- the three beta cases on warps 0-2; lowest error wins ----------
  float R[3][3], t[3];
  if (w < 3) {
    float e;
    switch (w) {
      case 0: e = run_case<0>(s, gn_iters, R, t); break;
      case 1: e = run_case<1>(s, gn_iters, R, t); break;
      default: e = run_case<2>(s, gn_iters, R, t); break;
    }
    Y[4 + w] = e;
  }
  __syncthreads();
  {
    const float e0 = Y[4], e1 = Y[5], e2 = Y[6];
    int best = 0;
    if (e1 < e0) best = 1;
    if (e2 < jmin(e1, e0)) best = 2;
    if (w == best) {            // L6x10 and rho are read for the last time
#pragma unroll
      for (int r = 0; r < 3; ++r) {
#pragma unroll
        for (int c = 0; c < 3; ++c) s[oA + 3 * r + c] = R[r][c];
        s[oA + 9 + r] = t[r];
      }
    }
  }
  __syncthreads();

  for (int i = tid; i < nb * 9; i += kThreads)
    Rout[first * 9 + i] = sm[(i / 9) * kStride + oA + i % 9];
  for (int i = tid; i < nb * 3; i += kThreads)
    tout[first * 3 + i] = sm[(i / 3) * kStride + oA + 9 + i % 3];
}

// The largest shared-memory carveout, so the blocks that the registers
// allow also fit the SM's shared memory.
cudaError_t configure() {
  static const cudaError_t rc = cudaFuncSetAttribute(
      epnp_minimal_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
      static_cast<int>(cudaSharedmemCarveoutMaxShared));
  return rc;
}

}  // namespace

extern "C" int zp_epnp_minimal(const float* p3, const float* p2,
                               const float* Ks, float* R, float* t, int n,
                               int gn_iters, void* stream) {
  if (n <= 0) return 0;
  const cudaError_t rc = configure();
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const int blocks = (n + kSolves - 1) / kSolves;
  epnp_minimal_kernel<<<blocks, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      p3, p2, Ks, R, t, n, gn_iters);
  return static_cast<int>(cudaGetLastError());
}

// out: resident blocks per SM, threads a block, static shared memory a
// block (bytes), registers a thread, local memory a thread (bytes).
extern "C" int zp_epnp_minimal_occupancy(int* out) {
  cudaError_t rc = configure();
  if (rc != cudaSuccess) return static_cast<int>(rc);
  cudaFuncAttributes attr;
  rc = cudaFuncGetAttributes(&attr, epnp_minimal_kernel);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  int blocks = 0;
  rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, epnp_minimal_kernel, kThreads, 0);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  out[0] = blocks;
  out[1] = kThreads;
  out[2] = static_cast<int>(attr.sharedSizeBytes);
  out[3] = attr.numRegs;
  out[4] = static_cast<int>(attr.localSizeBytes);
  return 0;
}
