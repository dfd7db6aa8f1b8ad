// zebra_native (the port's copy): the depth / class-id rasterizer.
//
// A copy of the rasterizer of native/zebra_native.cpp (`zn_render_label`,
// the same C interface and the same float expressions), built by
// zebrapose_tpu_torch/ops/_build.py with the flags of native/Makefile
// (no -ffast-math, no -march=native), so its ids and depth are bit-equal
// to the JAX package's library. Host code, consumed via ctypes
// (zebrapose_tpu_torch/native). The partitioner and the contour refiner
// of that file are not copied yet.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
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

}  // extern "C"
