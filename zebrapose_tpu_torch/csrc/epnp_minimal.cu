// Minimal-set EPnP for the RANSAC hypothesis stage, one thread per solve.
//
// Replaces the Pallas TPU kernel zebrapose_tpu/ops/pnp_kernel.py::
// minimal_epnp_hypotheses (body _epnp_soa). Every step follows _epnp_soa
// in order, with the same floors (Cholesky 1e-12*max|diag|, +1e-6 on the
// trace-normalised MtM diagonal, 1e-9*trace in the least-squares solves,
// 1e-6*vmax + 1e-9 on the control-point variances, the 1e-20 / 1e-30 /
// 1e-8 / 1e-12 guards), the same iteration counts (4 subspace iterations,
// gn_iters Gauss-Newton steps, 12 polar steps), the same sorting network
// and the same candidate choice (NaN error -> +inf, strict <, so case 1
// wins ties).
//
// Bound: operations. A solve reads 34 floats and writes 12 but runs
// ~2.5e4 dependent float operations; solves share nothing. The TPU kernel
// kept one (8,128) lane tile per scalar for 1024 solves in lock step; here
// each thread owns one solve and each scalar is a register or, for the
// 12x12 arrays, a local-memory slot (cached in L1). 128 threads a block,
// ceil(n/128) blocks, no padding of n.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -shared -Xcompiler -fPIC   (no --use_fast_math).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int S = 6;
constexpr int kThreads = 128;

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

// Unrolled Cholesky (lower), fast_linalg.cholesky_small semantics.
template <int N>
__device__ __forceinline__ void chol(const float (&A)[N][N], float (&L)[N][N]) {
  float amax = fabsf(A[0][0]);
#pragma unroll
  for (int j = 1; j < N; ++j) amax = jmax(amax, fabsf(A[j][j]));
  const float floor_ = 1e-12f * jmax(amax, 1e-30f);
#pragma unroll
  for (int j = 0; j < N; ++j) {
    float s = A[j][j];
#pragma unroll
    for (int k = 0; k < j; ++k) s = s - L[j][k] * L[j][k];
    const float d = sqrtf(jmax(s, floor_));
    L[j][j] = d;
    const float inv_d = 1.0f / d;
#pragma unroll
    for (int i = j + 1; i < N; ++i) {
      float r = A[i][j];
#pragma unroll
      for (int k = 0; k < j; ++k) r = r - L[i][k] * L[j][k];
      L[i][j] = r * inv_d;
    }
  }
}

// Solve (L L^T) x = b for one column.
template <int N>
__device__ __forceinline__ void chol_solve(const float (&L)[N][N],
                                           const float (&b)[N], float (&x)[N]) {
  float y[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float acc = b[i];
#pragma unroll
    for (int k = 0; k < i; ++k) acc = acc - L[i][k] * y[k];
    y[i] = acc / L[i][i];
  }
#pragma unroll
  for (int i = N - 1; i >= 0; --i) {
    float acc = y[i];
#pragma unroll
    for (int k = i + 1; k < N; ++k) acc = acc - L[k][i] * x[k];
    x[i] = acc / L[i][i];
  }
}

// Least squares A x = b (A is [6][K]) by 1e-9*trace-regularised normal
// equations; cols[c] picks the columns of the [6][10] matrix M.
template <int K>
__device__ __forceinline__ void solve_ls(const float (&M)[S][10],
                                         const int (&cols)[K],
                                         const float (&b)[S], float (&x)[K]) {
  float ata[K][K];
#pragma unroll
  for (int i = 0; i < K; ++i) {
#pragma unroll
    for (int j = i; j < K; ++j) {
      float acc = M[0][cols[i]] * M[0][cols[j]];
#pragma unroll
      for (int r = 1; r < S; ++r) acc = acc + M[r][cols[i]] * M[r][cols[j]];
      ata[i][j] = acc;
      ata[j][i] = acc;
    }
  }
  float tr = ata[0][0];
#pragma unroll
  for (int i = 1; i < K; ++i) tr = tr + ata[i][i];
#pragma unroll
  for (int i = 0; i < K; ++i) ata[i][i] = ata[i][i] + 1e-9f * tr;
  float atb[K];
#pragma unroll
  for (int i = 0; i < K; ++i) {
    float acc = M[0][cols[i]] * b[0];
#pragma unroll
    for (int r = 1; r < S; ++r) acc = acc + M[r][cols[i]] * b[r];
    atb[i] = acc;
  }
  float L[K][K];
  chol<K>(ata, L);
  chol_solve<K>(L, atb, x);
}

// Same, for a dense [6][4] Jacobian.
__device__ __forceinline__ void solve_ls_dense4(const float (&A)[S][4],
                                                const float (&b)[S],
                                                float (&x)[4]) {
  float ata[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = i; j < 4; ++j) {
      float acc = A[0][i] * A[0][j];
#pragma unroll
      for (int r = 1; r < S; ++r) acc = acc + A[r][i] * A[r][j];
      ata[i][j] = acc;
      ata[j][i] = acc;
    }
  }
  float tr = ata[0][0];
#pragma unroll
  for (int i = 1; i < 4; ++i) tr = tr + ata[i][i];
#pragma unroll
  for (int i = 0; i < 4; ++i) ata[i][i] = ata[i][i] + 1e-9f * tr;
  float atb[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float acc = A[0][i] * b[0];
#pragma unroll
    for (int r = 1; r < S; ++r) acc = acc + A[r][i] * b[r];
    atb[i] = acc;
  }
  float L[4][4];
  chol<4>(ata, L);
  chol_solve<4>(L, atb, x);
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
  for (int it = 0; it < 12; ++it) {
    const float d = det3(X);
    const float inv_d = 1.0f / (d == 0.f ? 1e-30f : d);
    float C[3][3];
    cofactor3(X, C);
    const float gamma = powf(jmax(fabsf(d), 1e-20f), -1.0f / 3.0f);
    const float inv_g = 1.0f / gamma;
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
      for (int c = 0; c < 3; ++c)
        X[r][c] = 0.5f * (gamma * X[r][c] + C[r][c] * inv_d * inv_g);
  }
}

struct Solve {
  // inputs
  float X[S][3], U[S][2];
  float fx, fy, cx, cy;
  // control points
  float c0[3], d[S][3], scale[3], alphas[S][4];
  // null-space basis and the beta system
  float V[12][4];
  float Lm[S][10], rho[S];
};

__device__ __forceinline__ void gn_refine(const Solve& s, int gn_iters,
                                          float (&bs)[4]) {
  for (int it = 0; it < gn_iters; ++it) {
    const float b1 = bs[0], b2 = bs[1], b3 = bs[2], b4 = bs[3];
    float J[S][4], res[S];
#pragma unroll
    for (int r = 0; r < S; ++r) {
      const float* L = s.Lm[r];
      J[r][0] = 2.f * b1 * L[0] + b2 * L[1] + b3 * L[3] + b4 * L[6];
      J[r][1] = b1 * L[1] + 2.f * b2 * L[2] + b3 * L[4] + b4 * L[7];
      J[r][2] = b1 * L[3] + b2 * L[4] + 2.f * b3 * L[5] + b4 * L[8];
      J[r][3] = b1 * L[6] + b2 * L[7] + b3 * L[8] + 2.f * b4 * L[9];
    }
    const float prods[10] = {b1 * b1, b1 * b2, b2 * b2, b1 * b3, b2 * b3,
                             b3 * b3, b1 * b4, b2 * b4, b3 * b4, b4 * b4};
#pragma unroll
    for (int r = 0; r < S; ++r) {
      float acc = s.Lm[r][0] * prods[0];
#pragma unroll
      for (int c = 1; c < 10; ++c) acc = acc + s.Lm[r][c] * prods[c];
      res[r] = s.rho[r] - acc;
    }
    float delta[4];
    solve_ls_dense4(J, res, delta);
#pragma unroll
    for (int i = 0; i < 4; ++i) bs[i] = bs[i] + delta[i];
  }
}

// pnp._pose_from_betas + fast Procrustes with unit weights.
__device__ __forceinline__ void pose_from_betas(const Solve& s,
                                                const float (&bs)[4],
                                                float (&R)[3][3],
                                                float (&t)[3]) {
  const float inv_s = 1.0f / S;
  float x[12];
#pragma unroll
  for (int i = 0; i < 12; ++i) {
    float acc = s.V[i][0] * bs[0];
#pragma unroll
    for (int b = 1; b < 4; ++b) acc = acc + s.V[i][b] * bs[b];
    x[i] = acc;
  }
  float pc[S][3];
#pragma unroll
  for (int j = 0; j < S; ++j)
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      float acc = s.alphas[j][0] * x[c];
#pragma unroll
      for (int k = 1; k < 4; ++k) acc = acc + s.alphas[j][k] * x[3 * k + c];
      pc[j][c] = acc;
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
      float acc = (pc[0][r] - cc2[r]) * s.d[0][c];
#pragma unroll
      for (int j = 1; j < S; ++j) acc = acc + (pc[j][r] - cc2[r]) * s.d[j][c];
      H[r][c] = acc;
    }
  polar_rotation(H, R);
#pragma unroll
  for (int c = 0; c < 3; ++c)
    t[c] = cc2[c] - (R[c][0] * s.c0[0] + R[c][1] * s.c0[1] + R[c][2] * s.c0[2]);
}

__device__ __forceinline__ float reproj_err(const Solve& s,
                                            const float (&R)[3][3],
                                            const float (&t)[3]) {
  float acc = 0.f;
#pragma unroll
  for (int j = 0; j < S; ++j) {
    const float* Xj = s.X[j];
    const float pz = (R[2][0] * Xj[0] + R[2][1] * Xj[1] + R[2][2] * Xj[2]) + t[2];
    const float z = jmax(fabsf(pz), 1e-8f) * jsign(pz == 0.f ? 1.f : pz);
    const float inv_z = 1.0f / z;
    const float px = (R[0][0] * Xj[0] + R[0][1] * Xj[1] + R[0][2] * Xj[2]) + t[0];
    const float py = (R[1][0] * Xj[0] + R[1][1] * Xj[1] + R[1][2] * Xj[2]) + t[1];
    const float eu = s.fx * px * inv_z + s.cx - s.U[j][0];
    const float ev = s.fy * py * inv_z + s.cy - s.U[j][1];
    acc = acc + eu * eu + ev * ev;
  }
  return acc * (1.0f / S);
}

__global__ void __launch_bounds__(kThreads)
epnp_minimal_kernel(const float* __restrict__ p3, const float* __restrict__ p2,
                    const float* __restrict__ cam, float* __restrict__ Rout,
                    float* __restrict__ tout, int n, int gn_iters) {
  const int h = blockIdx.x * blockDim.x + threadIdx.x;
  if (h >= n) return;
  Solve s;
#pragma unroll
  for (int j = 0; j < S; ++j) {
#pragma unroll
    for (int c = 0; c < 3; ++c) s.X[j][c] = p3[h * 3 * S + 3 * j + c];
#pragma unroll
    for (int c = 0; c < 2; ++c) s.U[j][c] = p2[h * 2 * S + 2 * j + c];
  }
  s.fx = cam[4 * h + 0];
  s.fy = cam[4 * h + 1];
  s.cx = cam[4 * h + 2];
  s.cy = cam[4 * h + 3];
  const float inv_s = 1.0f / S;

  // ---- control points (pnp._control_points, fast path) ----------------
  float var[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float acc = s.X[0][c];
#pragma unroll
    for (int j = 1; j < S; ++j) acc = acc + s.X[j][c];
    s.c0[c] = acc * inv_s;
  }
#pragma unroll
  for (int j = 0; j < S; ++j)
#pragma unroll
    for (int c = 0; c < 3; ++c) s.d[j][c] = s.X[j][c] - s.c0[c];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float acc = s.d[0][c] * s.d[0][c];
#pragma unroll
    for (int j = 1; j < S; ++j) acc = acc + s.d[j][c] * s.d[j][c];
    var[c] = acc * inv_s;
  }
  const float vmax = jmax(jmax(var[0], var[1]), var[2]);
  float inv_scale[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    s.scale[c] = sqrtf(jmax(var[c], 1e-6f * vmax + 1e-9f));
    inv_scale[c] = 1.0f / s.scale[c];
  }
#pragma unroll
  for (int j = 0; j < S; ++j) {
    const float a1 = s.d[j][0] * inv_scale[0];
    const float a2 = s.d[j][1] * inv_scale[1];
    const float a3 = s.d[j][2] * inv_scale[2];
    s.alphas[j][0] = 1.0f - a1 - a2 - a3;
    s.alphas[j][1] = a1;
    s.alphas[j][2] = a2;
    s.alphas[j][3] = a3;
  }

  // ---- M^T M (pnp._build_mtm), upper triangle then mirrored ------------
  float mtm[12][12];
#pragma unroll
  for (int r = 0; r < 12; ++r)
#pragma unroll
    for (int c = 0; c < 12; ++c) mtm[r][c] = 0.f;
#pragma unroll
  for (int j = 0; j < S; ++j) {
    const float du = s.cx - s.U[j][0];
    const float dv = s.cy - s.U[j][1];
    // B^T B with its structural zeros at (0,1) and (1,0) skipped
    const float btb[3][3] = {{s.fx * s.fx, 0.f, s.fx * du},
                             {0.f, s.fy * s.fy, s.fy * dv},
                             {s.fx * du, s.fy * dv, du * du + dv * dv}};
    const float* a = s.alphas[j];
#pragma unroll
    for (int i1 = 0; i1 < 4; ++i1)
#pragma unroll
      for (int i2 = i1; i2 < 4; ++i2) {
        const float aa = a[i1] * a[i2];
#pragma unroll
        for (int r = 0; r < 3; ++r)
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            if ((r == 0 && c == 1) || (r == 1 && c == 0)) continue;
            mtm[3 * i1 + r][3 * i2 + c] = mtm[3 * i1 + r][3 * i2 + c] + aa * btb[r][c];
          }
      }
  }
#pragma unroll
  for (int r = 0; r < 12; ++r)
#pragma unroll
    for (int c = 0; c < r; ++c) mtm[r][c] = mtm[c][r];

  // ---- bottom-4 eigen-subspace (fast_linalg.smallest_subspace) --------
  {
    float tr = mtm[0][0];
#pragma unroll
    for (int i = 1; i < 12; ++i) tr = tr + mtm[i][i];
    const float inv_s0 = 1.0f / jmax(tr * (1.0f / 12.0f), 1e-30f);
    float Bm[12][12];
#pragma unroll
    for (int i = 0; i < 12; ++i)
#pragma unroll
      for (int j = 0; j < 12; ++j) Bm[i][j] = mtm[i][j] * inv_s0;
#pragma unroll
    for (int i = 0; i < 12; ++i) Bm[i][i] = Bm[i][i] + 1e-6f;
    float Lc[12][12];
    chol<12>(Bm, Lc);
    float Y[4][12];   // column-major: Y[k] is column k
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int i = 0; i < 12; ++i) Y[k][i] = (i == k) ? 1.01f : 0.01f;
    for (int it = 0; it < 4; ++it) {
      float cols[4][12];
#pragma unroll
      for (int k = 0; k < 4; ++k) chol_solve<12>(Lc, Y[k], cols[k]);
      // Gram-Schmidt over the 4 columns (fast_linalg._gram_schmidt)
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        float v[12];
#pragma unroll
        for (int i = 0; i < 12; ++i) v[i] = cols[k][i];
#pragma unroll
        for (int u = 0; u < k; ++u) {
          float dot = v[0] * Y[u][0];
#pragma unroll
          for (int i = 1; i < 12; ++i) dot = dot + v[i] * Y[u][i];
#pragma unroll
          for (int i = 0; i < 12; ++i) v[i] = v[i] - dot * Y[u][i];
        }
        float nsq = v[0] * v[0];
#pragma unroll
        for (int i = 1; i < 12; ++i) nsq = nsq + v[i] * v[i];
        const float inv_n = 1.0f / jmax(sqrtf(nsq), 1e-20f);
#pragma unroll
        for (int i = 0; i < 12; ++i) Y[k][i] = v[i] * inv_n;
      }
    }
    // order columns by Rayleigh quotient of the ORIGINAL mtm (ascending)
    float rq[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < 12; ++i) {
        float Ay = mtm[i][0] * Y[k][0];
#pragma unroll
        for (int j = 1; j < 12; ++j) Ay = Ay + mtm[i][j] * Y[k][j];
        acc = acc + Y[k][i] * Ay;
      }
      rq[k] = acc;
    }
    int perm[4] = {0, 1, 2, 3};
    const int net[5][2] = {{0, 1}, {2, 3}, {0, 2}, {1, 3}, {1, 2}};
#pragma unroll
    for (int e = 0; e < 5; ++e) {
      const int a = net[e][0], b = net[e][1];
      if (rq[b] < rq[a]) {
        const float tq = rq[a];
        rq[a] = rq[b];
        rq[b] = tq;
        const int tp = perm[a];
        perm[a] = perm[b];
        perm[b] = tp;
      }
    }
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int i = 0; i < 12; ++i) {
        // select column perm[k] without dynamic indexing of Y
        const int p = perm[k];
        s.V[i][k] = p == 0 ? Y[0][i] : p == 1 ? Y[1][i] : p == 2 ? Y[2][i] : Y[3][i];
      }
  }

  // ---- L [6][10] and rho [6] (pnp._l6x10_and_rho) ---------------------
  {
    const int P[6] = {0, 0, 0, 1, 1, 2};
    const int Q[6] = {1, 2, 3, 2, 3, 3};
#pragma unroll
    for (int r = 0; r < 6; ++r) {
      const int p = P[r], q = Q[r];
      float dv[3][4];
#pragma unroll
      for (int x = 0; x < 3; ++x)
#pragma unroll
        for (int b = 0; b < 4; ++b) dv[x][b] = s.V[3 * p + x][b] - s.V[3 * q + x][b];
      float dots[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b)
          dots[a][b] = dv[0][a] * dv[0][b] + dv[1][a] * dv[1][b] + dv[2][a] * dv[2][b];
      float* L = s.Lm[r];
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
      if (p == 0) {
        s.rho[r] = s.scale[q - 1] * s.scale[q - 1];
      } else {
        s.rho[r] = s.scale[p - 1] * s.scale[p - 1] + s.scale[q - 1] * s.scale[q - 1];
      }
    }
  }

  // ---- three beta cases, Gauss-Newton, pose, lowest error wins -------
  float best_R[3][3], best_t[3], best_e = 0.f;
#pragma unroll 1
  for (int cs = 0; cs < 3; ++cs) {
    float bs[4];
    if (cs == 0) {
      const int cols[4] = {0, 1, 3, 6};
      float x[4];
      solve_ls<4>(s.Lm, cols, s.rho, x);
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
      solve_ls<3>(s.Lm, cols, s.rho, x);
      bs[0] = sqrtf(fabsf(x[0]));
      bs[1] = sqrtf(fabsf(x[2])) * jsign(x[1]) * jsign(x[0]);
      bs[2] = 0.f;
      bs[3] = 0.f;
    } else {
      const int cols[5] = {0, 1, 2, 3, 4};
      float x[5];
      solve_ls<5>(s.Lm, cols, s.rho, x);
      const float b1 = sqrtf(fabsf(x[0]));
      bs[0] = b1;
      bs[1] = sqrtf(fabsf(x[2])) * jsign(x[1]) * jsign(x[0]);
      bs[2] = x[3] / jmax(b1, 1e-12f) * jsign(x[0]);
      bs[3] = 0.f;
    }
    gn_refine(s, gn_iters, bs);
    float R[3][3], t[3];
    pose_from_betas(s, bs, R, t);
    float e = reproj_err(s, R, t);
    if (isnan(e)) e = INFINITY;
    if (cs == 0 || e < best_e) {
#pragma unroll
      for (int r = 0; r < 3; ++r) {
#pragma unroll
        for (int c = 0; c < 3; ++c) best_R[r][c] = R[r][c];
        best_t[r] = t[r];
      }
    }
    best_e = cs == 0 ? e : jmin(e, best_e);
  }
#pragma unroll
  for (int r = 0; r < 3; ++r) {
#pragma unroll
    for (int c = 0; c < 3; ++c) Rout[h * 9 + 3 * r + c] = best_R[r][c];
    tout[h * 3 + r] = best_t[r];
  }
}

}  // namespace

extern "C" int zp_epnp_minimal(const float* p3, const float* p2,
                               const float* cam, float* R, float* t, int n,
                               int gn_iters, void* stream) {
  if (n <= 0) return 0;
  const int blocks = (n + kThreads - 1) / kThreads;
  epnp_minimal_kernel<<<blocks, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      p3, p2, cam, R, t, n, gn_iters);
  return static_cast<int>(cudaGetLastError());
}
