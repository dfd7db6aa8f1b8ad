// zebra_native (the port's copy): the depth / class-id rasterizer and
// the hierarchical balanced surface partitioner.
//
// A copy of native/zebra_native.cpp's `zn_render_label`,
// `balanced_split`, `zn_partition_mesh`, `zn_face_classes` and
// `zn_class_centroids` (the same C interface and the same expressions),
// built by zebrapose_tpu_torch/ops/_build.py with the flags of
// native/Makefile (no -ffast-math, no -march=native), so its ids, depth,
// partition and centroids are bit-equal to the JAX package's library
// built by the same compiler. The partition draws from std::mt19937
// through std::shuffle and orders with an unstable std::sort: another
// standard library may give another partition of the same mesh. Host
// code, consumed via ctypes (zebrapose_tpu_torch/native). The contour
// refiner of that file is not copied yet.

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

}  // extern "C"
