// zebra_native (the port's copy): the depth / class-id rasterizer, the
// hierarchical balanced surface partitioner, the contour refiner, and an
// outer border follower.
//
// A copy of native/zebra_native.cpp's `zn_render_label`,
// `balanced_split`, `zn_partition_mesh`, `zn_face_classes`,
// `zn_class_centroids`, and the edge refiner (`so3_exp`, `mat3_mul`,
// `solve6`, `zn_edge_refine_impl`, `zn_edge_refine`,
// `zn_edge_refine_debug`), with the same C interface and the same
// expressions, built by zebrapose_tpu_torch/ops/_build.py with the flags
// of native/Makefile (no -ffast-math, no -march=native), so its ids,
// depth, partition, centroids and refined poses are bit-equal to the JAX
// package's library built by the same compiler. The partition draws from
// std::mt19937 through std::shuffle and orders with an unstable
// std::sort: another standard library may give another partition of the
// same mesh. `zn_find_external_contours` is the port's own: the JAX
// package takes the refiner's contours from cv2.findContours, which the
// port does not import. Host code, consumed via ctypes
// (zebrapose_tpu_torch/native).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <numeric>
#include <random>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Rasterizer
// ---------------------------------------------------------------------------

// Render per-pixel face class ids (+ depth) under x_c = R X + t,
// u = K x_c. Background: class 0, depth 0. Pixel centers at (x+.5, y+.5).
int zn_render_label(const float* vertices, int n_vertices,
                    const int* faces, int n_faces,
                    const int* face_class, const double* K,
                    const double* R, const double* t,
                    int width, int height,
                    int* out_class, float* out_depth) {
  std::vector<float> cam(3 * (size_t)n_vertices);   // camera-frame xyz
  std::vector<float> scr(2 * (size_t)n_vertices);   // screen xy
  const double fx = K[0], cx = K[2], fy = K[4], cy = K[5];
  for (int i = 0; i < n_vertices; ++i) {
    const float X = vertices[3 * i], Y = vertices[3 * i + 1],
                Z = vertices[3 * i + 2];
    const double xc = R[0] * X + R[1] * Y + R[2] * Z + t[0];
    const double yc = R[3] * X + R[4] * Y + R[5] * Z + t[1];
    const double zc = R[6] * X + R[7] * Y + R[8] * Z + t[2];
    cam[3 * i] = (float)xc;
    cam[3 * i + 1] = (float)yc;
    cam[3 * i + 2] = (float)zc;
    if (zc > 1e-9) {
      scr[2 * i] = (float)(fx * xc / zc + cx);
      scr[2 * i + 1] = (float)(fy * yc / zc + cy);
    } else {
      scr[2 * i] = scr[2 * i + 1] = -1e9f;
    }
  }

  std::vector<float> zbuf((size_t)width * height,
                          std::numeric_limits<float>::max());
  std::fill(out_class, out_class + (size_t)width * height, 0);
  if (out_depth)
    std::fill(out_depth, out_depth + (size_t)width * height, 0.f);

  for (int f = 0; f < n_faces; ++f) {
    const int a = faces[3 * f], b = faces[3 * f + 1], c = faces[3 * f + 2];
    const float za = cam[3 * a + 2], zb = cam[3 * b + 2],
                zc_ = cam[3 * c + 2];
    if (za <= 1e-9f || zb <= 1e-9f || zc_ <= 1e-9f) continue;  // clip
    const float ax = scr[2 * a], ay = scr[2 * a + 1];
    const float bx = scr[2 * b], by = scr[2 * b + 1];
    const float cx2 = scr[2 * c], cy2 = scr[2 * c + 1];
    const float area = (bx - ax) * (cy2 - ay) - (by - ay) * (cx2 - ax);
    if (std::fabs(area) < 1e-12f) continue;
    int x0 = std::max(0, (int)std::floor(std::min({ax, bx, cx2}) - 0.5f));
    int x1 = std::min(width - 1,
                      (int)std::ceil(std::max({ax, bx, cx2}) + 0.5f));
    int y0 = std::max(0, (int)std::floor(std::min({ay, by, cy2}) - 0.5f));
    int y1 = std::min(height - 1,
                      (int)std::ceil(std::max({ay, by, cy2}) + 0.5f));
    const float inv_area = 1.f / area;
    const float iza = 1.f / za, izb = 1.f / zb, izc = 1.f / zc_;
    for (int y = y0; y <= y1; ++y) {
      const float py = y + 0.5f;
      for (int x = x0; x <= x1; ++x) {
        const float px = x + 0.5f;
        float w0 = ((bx - px) * (cy2 - py) - (by - py) * (cx2 - px)) *
                   inv_area;
        float w1 = ((cx2 - px) * (ay - py) - (cy2 - py) * (ax - px)) *
                   inv_area;
        float w2 = 1.f - w0 - w1;
        if (w0 < 0.f || w1 < 0.f || w2 < 0.f) continue;
        const float inv_z = w0 * iza + w1 * izb + w2 * izc;
        const float z = 1.f / inv_z;
        const size_t idx = (size_t)y * width + x;
        if (z < zbuf[idx]) {
          zbuf[idx] = z;
          out_class[idx] = face_class[f];
          if (out_depth) out_depth[idx] = z;
        }
      }
    }
  }
  return 0;
}

// ---------------------------------------------------------------------------
// Hierarchical balanced partition
// ---------------------------------------------------------------------------

namespace {

// Split `idx` into `d` equal-size clusters (k-means + capacity-greedy
// rebalance). Writes branch index [0, d) per element into `branch`.
void balanced_split(const float* verts, std::vector<int>& idx, int d,
                    std::vector<int>& branch, std::mt19937& rng) {
  const int n = (int)idx.size();
  branch.assign(n, 0);
  if (n == 0 || d <= 1) return;

  // init centroids: d random distinct points
  std::vector<double> cent(3 * (size_t)d);
  std::vector<int> perm(n);
  std::iota(perm.begin(), perm.end(), 0);
  std::shuffle(perm.begin(), perm.end(), rng);
  for (int k = 0; k < d; ++k) {
    const float* v = verts + 3 * (size_t)idx[perm[k % n]];
    cent[3 * k] = v[0];
    cent[3 * k + 1] = v[1];
    cent[3 * k + 2] = v[2];
  }

  std::vector<int> assign(n, 0);
  for (int iter = 0; iter < 12; ++iter) {
    bool changed = false;
    for (int i = 0; i < n; ++i) {
      const float* v = verts + 3 * (size_t)idx[i];
      double best = 1e30;
      int bk = 0;
      for (int k = 0; k < d; ++k) {
        const double dx = v[0] - cent[3 * k], dy = v[1] - cent[3 * k + 1],
                     dz = v[2] - cent[3 * k + 2];
        const double dist = dx * dx + dy * dy + dz * dz;
        if (dist < best) { best = dist; bk = k; }
      }
      if (assign[i] != bk) { assign[i] = bk; changed = true; }
    }
    std::vector<double> sum(3 * (size_t)d, 0.0);
    std::vector<int> cnt(d, 0);
    for (int i = 0; i < n; ++i) {
      const float* v = verts + 3 * (size_t)idx[i];
      sum[3 * assign[i]] += v[0];
      sum[3 * assign[i] + 1] += v[1];
      sum[3 * assign[i] + 2] += v[2];
      cnt[assign[i]]++;
    }
    for (int k = 0; k < d; ++k)
      if (cnt[k] > 0)
        for (int c = 0; c < 3; ++c) cent[3 * k + c] = sum[3 * k + c] / cnt[k];
    if (!changed) break;
  }

  // capacity-greedy rebalance to equal sizes (+/-1): order points by how
  // much they prefer their best cluster, then fill capacities.
  const int cap_lo = n / d;
  int extras = n % d;
  std::vector<int> cap(d, cap_lo);
  for (int k = 0; k < d && extras > 0; ++k, --extras) cap[k]++;

  struct Pref { int i; std::vector<int> order; double margin; };
  std::vector<Pref> prefs(n);
  for (int i = 0; i < n; ++i) {
    const float* v = verts + 3 * (size_t)idx[i];
    std::vector<double> dist(d);
    for (int k = 0; k < d; ++k) {
      const double dx = v[0] - cent[3 * k], dy = v[1] - cent[3 * k + 1],
                   dz = v[2] - cent[3 * k + 2];
      dist[k] = dx * dx + dy * dy + dz * dz;
    }
    prefs[i].i = i;
    prefs[i].order.resize(d);
    std::iota(prefs[i].order.begin(), prefs[i].order.end(), 0);
    std::sort(prefs[i].order.begin(), prefs[i].order.end(),
              [&](int a2, int b2) { return dist[a2] < dist[b2]; });
    prefs[i].margin = d > 1 ? dist[prefs[i].order[1]] -
                              dist[prefs[i].order[0]]
                            : 0.0;
  }
  std::sort(prefs.begin(), prefs.end(),
            [](const Pref& a2, const Pref& b2) {
              return a2.margin > b2.margin;  // most-committed first
            });
  std::vector<int> used(d, 0);
  for (const auto& p : prefs) {
    for (int k : p.order) {
      if (used[k] < cap[k]) { branch[p.i] = k; used[k]++; break; }
    }
  }
}

}  // namespace

// Hierarchical class id per vertex: id = sum branch_l * d^(levels-1-l).
int zn_partition_mesh(const float* vertices, int n_vertices,
                      int divide_number, int n_levels, uint32_t seed,
                      uint32_t* out_class) {
  std::mt19937 rng(seed);
  std::vector<uint32_t> ids(n_vertices, 0);
  std::vector<std::vector<int>> groups(1);
  groups[0].resize(n_vertices);
  std::iota(groups[0].begin(), groups[0].end(), 0);

  for (int level = 0; level < n_levels; ++level) {
    std::vector<std::vector<int>> next;
    next.reserve(groups.size() * divide_number);
    for (auto& g : groups) {
      std::vector<int> branch;
      balanced_split(vertices, g, divide_number, branch, rng);
      std::vector<std::vector<int>> sub((size_t)divide_number);
      for (size_t i = 0; i < g.size(); ++i) {
        ids[g[i]] = ids[g[i]] * divide_number + branch[i];
        sub[branch[i]].push_back(g[i]);
      }
      for (auto& s : sub) next.push_back(std::move(s));
    }
    groups = std::move(next);
  }
  std::memcpy(out_class, ids.data(), sizeof(uint32_t) * n_vertices);
  return 0;
}

// Face class from vertex classes: majority-of-2 vote, else first vertex
// (Generate_Mesh_with_GT_Color.cpp:356-393).
int zn_face_classes(const uint32_t* vertex_class, const int* faces,
                    int n_faces, uint32_t* out_face_class) {
  for (int f = 0; f < n_faces; ++f) {
    const uint32_t a = vertex_class[faces[3 * f]];
    const uint32_t b = vertex_class[faces[3 * f + 1]];
    const uint32_t c = vertex_class[faces[3 * f + 2]];
    uint32_t cls = a;
    if (b == c) cls = b;
    if (a == b || a == c) cls = a;
    out_face_class[f] = cls;
  }
  return 0;
}

// Per-class centroid of member vertices; classes with no member get NaN
// (Generate_Mesh_with_GT_Color.cpp:396-455).
int zn_class_centroids(const float* vertices, int n_vertices,
                       const uint32_t* vertex_class, int n_classes,
                       float* out_xyz) {
  std::vector<double> sum(3 * (size_t)n_classes, 0.0);
  std::vector<int> cnt(n_classes, 0);
  for (int i = 0; i < n_vertices; ++i) {
    const uint32_t c = vertex_class[i];
    if ((int)c >= n_classes) continue;
    sum[3 * c] += vertices[3 * i];
    sum[3 * c + 1] += vertices[3 * i + 1];
    sum[3 * c + 2] += vertices[3 * i + 2];
    cnt[c]++;
  }
  for (int c = 0; c < n_classes; ++c) {
    for (int k = 0; k < 3; ++k)
      out_xyz[3 * c + k] =
          cnt[c] ? (float)(sum[3 * c + k] / cnt[c])
                 : std::numeric_limits<float>::quiet_NaN();
  }
  return 0;
}

// ---------------------------------------------------------------------------
// Edge refiner
// ---------------------------------------------------------------------------

namespace {

void so3_exp(const double w[3], double Rm[9]) {
  const double th = std::sqrt(w[0] * w[0] + w[1] * w[1] + w[2] * w[2]);
  double Wm[9] = {0, -w[2], w[1], w[2], 0, -w[0], -w[1], w[0], 0};
  double W2[9];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      W2[3 * i + j] = 0;
      for (int k = 0; k < 3; ++k)
        W2[3 * i + j] += Wm[3 * i + k] * Wm[3 * k + j];
    }
  const double A = th < 1e-8 ? 1.0 : std::sin(th) / th;
  const double B = th < 1e-8 ? 0.5 : (1 - std::cos(th)) / (th * th);
  for (int i = 0; i < 9; ++i)
    Rm[i] = (i % 4 == 0 ? 1.0 : 0.0) + A * Wm[i] + B * W2[i];
}

void mat3_mul(const double* A, const double* B, double* C) {
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      C[3 * i + j] = 0;
      for (int k = 0; k < 3; ++k) C[3 * i + j] += A[3 * i + k] * B[3 * k + j];
    }
}

bool solve6(double H[36], const double b[6], double x[6]) {
  // Gaussian elimination with partial pivoting
  int piv[6];
  double M[6][7];
  for (int i = 0; i < 6; ++i) {
    for (int j = 0; j < 6; ++j) M[i][j] = H[6 * i + j];
    M[i][6] = b[i];
    piv[i] = i;
  }
  for (int col = 0; col < 6; ++col) {
    int best = col;
    for (int r = col + 1; r < 6; ++r)
      if (std::fabs(M[r][col]) > std::fabs(M[best][col])) best = r;
    if (std::fabs(M[best][col]) < 1e-14) return false;
    std::swap(M[col], M[best]);
    (void)piv;
    for (int r = col + 1; r < 6; ++r) {
      const double f = M[r][col] / M[col][col];
      for (int c = col; c < 7; ++c) M[r][c] -= f * M[col][c];
    }
  }
  for (int i = 5; i >= 0; --i) {
    double s = M[i][6];
    for (int j = i + 1; j < 6; ++j) s -= M[i][j] * x[j];
    x[i] = s / M[i][i];
  }
  return true;
}

}  // namespace

// Contour-based Gauss-Newton refinement (edge_refine.cpp semantics):
// per iteration, render the depth image under the current pose, extract
// the silhouette contour, match each given visible-contour pixel to its
// nearest rendered-contour pixel, back-project via rendered depth, build
// the 2x6 reprojection Jacobian in the model frame and solve damped
// normal equations (rot damping 5e3, trans damping 5e5), right-multiply
// the update.
// Core refiner. `dbg` (may be null) receives one uint8 frame per
// iteration [iterations * height * width]: 0 background, 1 rendered
// silhouette interior, 2 rendered silhouette contour, 3 target
// (visible-mask) contour — the reference's edge_refine_debug.cpp
// per-iteration introspection images, minus the OpenGL dependency.
static int zn_edge_refine_impl(const float* vertices, int n_vertices,
                               const int* faces, int n_faces,
                               const double* K, int width, int height,
                               const int* contour_xy, int n_contour,
                               int iterations, double damp_rot,
                               double damp_trans,
                               double* R_io, double* t_io,
                               unsigned char* dbg) {
  if (n_contour < 3) return 1;
  std::vector<int> cls((size_t)width * height);
  std::vector<float> depth((size_t)width * height);
  std::vector<int> ones(n_faces, 1);
  const double fx = K[0], cx = K[2], fy = K[4], cy = K[5];

  for (int it = 0; it < iterations; ++it) {
    zn_render_label(vertices, n_vertices, faces, n_faces, ones.data(), K,
                    R_io, t_io, width, height, cls.data(), depth.data());
    // rendered silhouette contour pixels
    std::vector<int> rc;
    rc.reserve(4096);
    for (int y = 1; y < height - 1; ++y)
      for (int x = 1; x < width - 1; ++x) {
        const size_t i = (size_t)y * width + x;
        if (cls[i] == 0) continue;
        if (cls[i - 1] == 0 || cls[i + 1] == 0 || cls[i - width] == 0 ||
            cls[i + width] == 0) {
          rc.push_back(x);
          rc.push_back(y);
        }
      }
    if (dbg) {
      unsigned char* fr = dbg + (size_t)it * width * height;
      for (size_t i = 0; i < (size_t)width * height; ++i)
        fr[i] = cls[i] ? 1 : 0;
      for (size_t k = 0; k < rc.size(); k += 2)
        fr[(size_t)rc[k + 1] * width + rc[k]] = 2;
      for (int ci = 0; ci < n_contour; ++ci) {
        const int ux = contour_xy[2 * ci], uy = contour_xy[2 * ci + 1];
        if (ux >= 0 && ux < width && uy >= 0 && uy < height)
          fr[(size_t)uy * width + ux] = 3;
      }
    }
    if (rc.size() < 6) return 2;

    double H[36] = {0}, bvec[6] = {0};
    int n_used = 0;
    for (int ci = 0; ci < n_contour; ++ci) {
      const int ux = contour_xy[2 * ci], uy = contour_xy[2 * ci + 1];
      // nearest rendered-contour pixel
      long best = -1;
      long bd = std::numeric_limits<long>::max();
      for (size_t k = 0; k < rc.size(); k += 2) {
        const long dx = rc[k] - ux, dy = rc[k + 1] - uy;
        const long dd = dx * dx + dy * dy;
        if (dd < bd) { bd = dd; best = (long)k; }
      }
      const int rx = rc[best], ry = rc[best + 1];
      const float z = depth[(size_t)ry * width + rx];
      if (z <= 0) continue;
      // camera-frame 3D point of the matched silhouette pixel
      const double Xc = (rx + 0.5 - cx) / fx * z;
      const double Yc = (ry + 0.5 - cy) / fy * z;
      const double Zc = z;
      // residual: where the visible contour says this point should be
      const double r0 = ux + 0.5 - (fx * Xc / Zc + cx);
      const double r1 = uy + 0.5 - (fy * Yc / Zc + cy);
      // Jacobian wrt right-multiplied twist (model frame): d(uv)/d xi =
      // J_proj * [ -R*[p]_x | R ] with p the MODEL-frame point.
      // model-frame point p = R^T (Pc - t)
      const double px = R_io[0] * (Xc - t_io[0]) + R_io[3] * (Yc - t_io[1]) +
                        R_io[6] * (Zc - t_io[2]);
      const double py = R_io[1] * (Xc - t_io[0]) + R_io[4] * (Yc - t_io[1]) +
                        R_io[7] * (Zc - t_io[2]);
      const double pz = R_io[2] * (Xc - t_io[0]) + R_io[5] * (Yc - t_io[1]) +
                        R_io[8] * (Zc - t_io[2]);
      // dPc/dw = R * d(w x p)/dw = -R [p]_x ; dPc/dv = R
      double dPc[3][6];
      const double Px[9] = {0, -pz, py, pz, 0, -px, -py, px, 0};
      for (int i = 0; i < 3; ++i) {
        for (int j = 0; j < 3; ++j) {
          // rotation part: -(R [p]_x)
          double s = 0;
          for (int k = 0; k < 3; ++k) s += R_io[3 * i + k] * Px[3 * k + j];
          dPc[i][j] = -s;
          dPc[i][3 + j] = R_io[3 * i + j];
        }
      }
      // projection Jacobian
      const double iz = 1.0 / Zc;
      double Ju[6], Jv[6];
      for (int j = 0; j < 6; ++j) {
        Ju[j] = fx * (dPc[0][j] * iz - Xc * iz * iz * dPc[2][j]);
        Jv[j] = fy * (dPc[1][j] * iz - Yc * iz * iz * dPc[2][j]);
      }
      for (int i = 0; i < 6; ++i) {
        for (int j = 0; j < 6; ++j)
          H[6 * i + j] += Ju[i] * Ju[j] + Jv[i] * Jv[j];
        bvec[i] += Ju[i] * r0 + Jv[i] * r1;
      }
      n_used++;
    }
    if (n_used < 6) return 3;
    for (int i = 0; i < 3; ++i) H[6 * i + i] += damp_rot;
    for (int i = 3; i < 6; ++i) H[6 * i + i] += damp_trans;
    double xi[6];
    if (!solve6(H, bvec, xi)) return 4;
    // right-multiply update: R <- R * exp(w); t <- t + R * v... for a
    // model-frame twist, Pc' = R exp(w)(p + ... ) — apply:
    double dR[9], Rn[9];
    so3_exp(xi, dR);
    mat3_mul(R_io, dR, Rn);
    const double v0 = xi[3], v1 = xi[4], v2 = xi[5];
    double tv[3];
    for (int i = 0; i < 3; ++i)
      tv[i] = R_io[3 * i] * v0 + R_io[3 * i + 1] * v1 + R_io[3 * i + 2] * v2;
    std::memcpy(R_io, Rn, sizeof(Rn));
    for (int i = 0; i < 3; ++i) t_io[i] += tv[i];
  }
  return 0;
}

int zn_edge_refine(const float* vertices, int n_vertices,
                   const int* faces, int n_faces,
                   const double* K, int width, int height,
                   const int* contour_xy, int n_contour,
                   int iterations, double damp_rot, double damp_trans,
                   double* R_io, double* t_io) {
  return zn_edge_refine_impl(vertices, n_vertices, faces, n_faces, K,
                             width, height, contour_xy, n_contour,
                             iterations, damp_rot, damp_trans, R_io,
                             t_io, nullptr);
}

int zn_edge_refine_debug(const float* vertices, int n_vertices,
                         const int* faces, int n_faces,
                         const double* K, int width, int height,
                         const int* contour_xy, int n_contour,
                         int iterations, double damp_rot,
                         double damp_trans,
                         double* R_io, double* t_io,
                         unsigned char* dbg_frames) {
  return zn_edge_refine_impl(vertices, n_vertices, faces, n_faces, K,
                             width, height, contour_xy, n_contour,
                             iterations, damp_rot, damp_trans, R_io,
                             t_io, dbg_frames);
}

// ---------------------------------------------------------------------------
// Outer border following
// ---------------------------------------------------------------------------

// The outer borders of a binary mask as cv::findContours(mask,
// RETR_EXTERNAL, CHAIN_APPROX_NONE) gives them: Suzuki-Abe border
// following (Suzuki & Abe 1985) over a copy of the mask padded by one
// background pixel, every border pixel marked 2, or -126 where the
// trace saw background to its east. A raster scan starts an outer border
// at each 0 -> 1 step whose last marked pixel to the left in the row is
// not marked 2 (a border seen from inside: the step lies in a hole, and
// RETR_EXTERNAL skips it and all it holds). Each border starts at its
// first pixel in raster order and turns counterclockwise on the screen
// (down the left side first); a pixel is written each time the trace
// visits it. The list comes out last found first, as cv::findContours
// returns it.
//
// mask [height, width] (nonzero = foreground). Fills at most
// `cap_points` (x, y) pairs into xy and `cap_contours` lengths into
// lens, in output order; returns the number of contours and sets
// *n_points to the number of points, both counted in full even when
// they exceed the capacities (the caller then calls again with room).
int zn_find_external_contours(const unsigned char* mask, int width,
                              int height, int* xy, int cap_points,
                              int* lens, int cap_contours,
                              int* n_points) {
  const int step = width + 2;
  std::vector<signed char> img((size_t)step * (height + 2), 0);
  for (int y = 0; y < height; ++y)
    for (int x = 0; x < width; ++x)
      img[(size_t)(y + 1) * step + x + 1] =
          mask[(size_t)y * width + x] != 0;
  // neighbour offsets by chain code: E, NE, N, NW, W, SW, S, SE, twice
  int deltas[16];
  const int dx[8] = {1, 1, 0, -1, -1, -1, 0, 1};
  const int dy[8] = {0, -1, -1, -1, 0, 1, 1, 1};
  for (int s = 0; s < 16; ++s) deltas[s] = dy[s & 7] * step + dx[s & 7];
  const signed char nbd = 2, right = (signed char)(2 | -128);

  // contours in the order found: [start, end) into pts
  std::vector<int> pts;
  std::vector<size_t> bounds;
  signed char* base = img.data();
  for (int y = 1; y <= height; ++y) {
    int prev = 0;
    size_t lnbd = (size_t)y * step;   // the row's pad pixel
    for (int x = 1; x <= width + 1; ++x) {
      const size_t at = (size_t)y * step + x;
      const int p = base[at];
      if (p == prev) continue;
      if (prev == 0 && p == 1 && base[lnbd] <= 0) {
        // trace the outer border that starts at (x, y)
        bounds.push_back(pts.size());
        signed char* i0 = base + at;
        int px = x - 1, py = y - 1;
        int s = 4;
        const int s_first = s;
        signed char* i1;
        do {
          s = (s - 1) & 7;
          i1 = i0 + deltas[s];
        } while (*i1 == 0 && s != s_first);
        if (s == s_first) {               // a pixel alone
          *i0 = right;
          pts.push_back(px);
          pts.push_back(py);
        } else {
          signed char* i3 = i0;
          signed char* i4;
          for (;;) {
            const int s_end = s;
            while (s < 15) {
              i4 = i3 + deltas[++s];
              if (*i4 != 0) break;
            }
            s &= 7;
            if ((unsigned)(s - 1) < (unsigned)s_end)
              *i3 = right;
            else if (*i3 == 1)
              *i3 = nbd;
            pts.push_back(px);
            pts.push_back(py);
            px += dx[s];
            py += dy[s];
            if (i4 == i0 && i3 == i1) break;
            i3 = i4;
            s = (s + 4) & 7;
          }
        }
        bounds.push_back(pts.size());
        prev = base[at];
        lnbd = at;
        continue;   // the scan goes on after the start pixel
      }
      prev = p;
      if (p & -2) lnbd = at;
    }
  }
  const int n = (int)(bounds.size() / 2);
  *n_points = (int)(pts.size() / 2);
  if (n <= cap_contours && *n_points <= cap_points) {
    int* out = xy;
    for (int c = n - 1, k = 0; c >= 0; --c, ++k) {
      const size_t a = bounds[2 * c], b = bounds[2 * c + 1];
      lens[k] = (int)((b - a) / 2);
      std::memcpy(out, pts.data() + a, (b - a) * sizeof(int));
      out += b - a;
    }
  }
  return n;
}

}  // extern "C"
