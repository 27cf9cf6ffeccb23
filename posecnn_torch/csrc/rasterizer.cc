// Software triangle rasterizer with a z-buffer: the host renderer of the
// port's synthetic scenes (data/synthetic.py) and of the bank refresh
// (data/bank_refresh.py).
//
// The port's own copy of the JAX package's rasterizer
// (posecnn_tpu/native/rasterizer.cc), with the same arithmetic: renders from
// the two packages are bit-equal when both are built with the same compiler
// on the same machine. One call rasterizes one object instance into shared
// color/depth/label/vertmap buffers; callers compose multi-object scenes by
// calling it per object (the shared z-buffer, not the draw order, decides
// what is in front).
//
// Build: posecnn_torch/_build.py, g++ -O3 -shared -fPIC -ffp-contract=off
// (no contraction of a*b+c into FMA, which GCC does by default on targets
// that have it, such as aarch64, and which would change the rounding).
// Binding: ctypes (posecnn_torch/native.py), which releases the GIL around
// each call.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>

extern "C" {

// vertices: (V,3) object-frame points; faces: (F,3) vertex indices;
// vertex_colors: (V,3) in [0,1] or nullptr (flat color via base_color);
// pose: row-major 3x4 [R|t] object->camera; K: row-major 3x3 intrinsics;
// light: 5 floats [lx,ly,lz, ambient, diffuse] — camera-frame light
// direction (need not be normalized) + Lambert terms: a per-face Lambert
// term, with the direction randomized per scene by the caller so shading
// carries rotation information.
// Buffers: color (H,W,3) uint8, depth (H,W) float32 (0 = empty),
// label (H,W) int32, vertmap (H,W,3) float32 (object coordinates).
// All buffers are read-modify-write with z-test so multiple calls compose.
void rasterize_mesh(
    const float* vertices, int num_vertices,
    const int* faces, int num_faces,
    const float* vertex_colors, const float* base_color,
    const float* pose, const float* K, const float* light,
    int height, int width, int cls_id,
    uint8_t* color, float* depth, int32_t* label, float* vertmap) {
  const float fx = K[0], px = K[2], fy = K[4], py = K[5];

  // transform vertices to camera frame + project
  float* cam = new float[num_vertices * 3];
  float* scr = new float[num_vertices * 2];
  for (int i = 0; i < num_vertices; i++) {
    const float* v = vertices + 3 * i;
    for (int r = 0; r < 3; r++) {
      cam[3 * i + r] = pose[4 * r + 0] * v[0] + pose[4 * r + 1] * v[1] +
                       pose[4 * r + 2] * v[2] + pose[4 * r + 3];
    }
    const float z = std::max(cam[3 * i + 2], 1e-6f);
    scr[2 * i + 0] = fx * cam[3 * i + 0] / z + px;
    scr[2 * i + 1] = fy * cam[3 * i + 1] / z + py;
  }

  // Lambert shading: |n.l| is used (not one-sided) because hull meshes have
  // unoriented faces; ambient + diffuse from the light argument.
  float ldir[3] = {light[0], light[1], light[2]};
  const float ambient = light[3], diffuse = light[4];
  {
    const float ln = std::sqrt(ldir[0] * ldir[0] + ldir[1] * ldir[1] + ldir[2] * ldir[2]);
    if (ln > 1e-12f) { ldir[0] /= ln; ldir[1] /= ln; ldir[2] /= ln; }
  }

  for (int f = 0; f < num_faces; f++) {
    const int i0 = faces[3 * f], i1 = faces[3 * f + 1], i2 = faces[3 * f + 2];
    const float* p0 = scr + 2 * i0;
    const float* p1 = scr + 2 * i1;
    const float* p2 = scr + 2 * i2;
    const float z0 = cam[3 * i0 + 2], z1 = cam[3 * i1 + 2], z2 = cam[3 * i2 + 2];
    if (z0 <= 1e-6f || z1 <= 1e-6f || z2 <= 1e-6f) continue;  // behind camera

    const float area = (p1[0] - p0[0]) * (p2[1] - p0[1]) -
                       (p2[0] - p0[0]) * (p1[1] - p0[1]);
    if (std::fabs(area) < 1e-9f) continue;

    // face normal in camera frame for shading + backface handling
    float e1[3], e2[3], n[3];
    for (int k = 0; k < 3; k++) {
      e1[k] = cam[3 * i1 + k] - cam[3 * i0 + k];
      e2[k] = cam[3 * i2 + k] - cam[3 * i0 + k];
    }
    n[0] = e1[1] * e2[2] - e1[2] * e2[1];
    n[1] = e1[2] * e2[0] - e1[0] * e2[2];
    n[2] = e1[0] * e2[1] - e1[1] * e2[0];
    float nl = std::sqrt(n[0] * n[0] + n[1] * n[1] + n[2] * n[2]);
    if (nl < 1e-12f) continue;
    float shade = std::fabs((n[0] * ldir[0] + n[1] * ldir[1] + n[2] * ldir[2]) / nl);
    shade = ambient + diffuse * shade;

    const int min_x = std::max(0, (int)std::floor(std::min({p0[0], p1[0], p2[0]})));
    const int max_x = std::min(width - 1, (int)std::ceil(std::max({p0[0], p1[0], p2[0]})));
    const int min_y = std::max(0, (int)std::floor(std::min({p0[1], p1[1], p2[1]})));
    const int max_y = std::min(height - 1, (int)std::ceil(std::max({p0[1], p1[1], p2[1]})));
    if (min_x > max_x || min_y > max_y) continue;

    const float inv_area = 1.0f / area;
    const float iz0 = 1.0f / z0, iz1 = 1.0f / z1, iz2 = 1.0f / z2;

    for (int y = min_y; y <= max_y; y++) {
      for (int x = min_x; x <= max_x; x++) {
        const float cx = x + 0.5f, cy = y + 0.5f;
        float w0 = ((p1[0] - cx) * (p2[1] - cy) - (p2[0] - cx) * (p1[1] - cy)) * inv_area;
        float w1 = ((p2[0] - cx) * (p0[1] - cy) - (p0[0] - cx) * (p2[1] - cy)) * inv_area;
        float w2 = 1.0f - w0 - w1;
        if (w0 < 0 || w1 < 0 || w2 < 0) continue;

        // perspective-correct interpolation
        const float iz = w0 * iz0 + w1 * iz1 + w2 * iz2;
        const float z = 1.0f / iz;
        const int idx = y * width + x;
        if (depth[idx] > 0 && depth[idx] <= z) continue;  // z-test

        depth[idx] = z;
        label[idx] = cls_id;
        const float a0 = w0 * iz0 * z, a1 = w1 * iz1 * z, a2 = w2 * iz2 * z;
        for (int k = 0; k < 3; k++) {
          vertmap[3 * idx + k] = a0 * vertices[3 * i0 + k] +
                                 a1 * vertices[3 * i1 + k] +
                                 a2 * vertices[3 * i2 + k];
          float c;
          if (vertex_colors) {
            c = a0 * vertex_colors[3 * i0 + k] + a1 * vertex_colors[3 * i1 + k] +
                a2 * vertex_colors[3 * i2 + k];
          } else {
            c = base_color[k];
          }
          c *= shade;
          color[3 * idx + k] = (uint8_t)std::min(255.0f, std::max(0.0f, c * 255.0f));
        }
      }
    }
  }
  delete[] cam;
  delete[] scr;
}

// Render only a depth + label map (for ICP-style refinement and visibility
// tests) — same math without color/vertmap writes.
void rasterize_depth(
    const float* vertices, int num_vertices,
    const int* faces, int num_faces,
    const float* pose, const float* K,
    int height, int width, int cls_id,
    float* depth, int32_t* label) {
  const float fx = K[0], px = K[2], fy = K[4], py = K[5];
  float* cam = new float[num_vertices * 3];
  float* scr = new float[num_vertices * 2];
  for (int i = 0; i < num_vertices; i++) {
    const float* v = vertices + 3 * i;
    for (int r = 0; r < 3; r++) {
      cam[3 * i + r] = pose[4 * r + 0] * v[0] + pose[4 * r + 1] * v[1] +
                       pose[4 * r + 2] * v[2] + pose[4 * r + 3];
    }
    const float z = std::max(cam[3 * i + 2], 1e-6f);
    scr[2 * i + 0] = fx * cam[3 * i + 0] / z + px;
    scr[2 * i + 1] = fy * cam[3 * i + 1] / z + py;
  }
  for (int f = 0; f < num_faces; f++) {
    const int i0 = faces[3 * f], i1 = faces[3 * f + 1], i2 = faces[3 * f + 2];
    const float* p0 = scr + 2 * i0;
    const float* p1 = scr + 2 * i1;
    const float* p2 = scr + 2 * i2;
    const float z0 = cam[3 * i0 + 2], z1 = cam[3 * i1 + 2], z2 = cam[3 * i2 + 2];
    if (z0 <= 1e-6f || z1 <= 1e-6f || z2 <= 1e-6f) continue;
    const float area = (p1[0] - p0[0]) * (p2[1] - p0[1]) -
                       (p2[0] - p0[0]) * (p1[1] - p0[1]);
    if (std::fabs(area) < 1e-9f) continue;
    const int min_x = std::max(0, (int)std::floor(std::min({p0[0], p1[0], p2[0]})));
    const int max_x = std::min(width - 1, (int)std::ceil(std::max({p0[0], p1[0], p2[0]})));
    const int min_y = std::max(0, (int)std::floor(std::min({p0[1], p1[1], p2[1]})));
    const int max_y = std::min(height - 1, (int)std::ceil(std::max({p0[1], p1[1], p2[1]})));
    const float inv_area = 1.0f / area;
    const float iz0 = 1.0f / z0, iz1 = 1.0f / z1, iz2 = 1.0f / z2;
    for (int y = min_y; y <= max_y; y++) {
      for (int x = min_x; x <= max_x; x++) {
        const float cx = x + 0.5f, cy = y + 0.5f;
        float w0 = ((p1[0] - cx) * (p2[1] - cy) - (p2[0] - cx) * (p1[1] - cy)) * inv_area;
        float w1 = ((p2[0] - cx) * (p0[1] - cy) - (p0[0] - cx) * (p2[1] - cy)) * inv_area;
        float w2 = 1.0f - w0 - w1;
        if (w0 < 0 || w1 < 0 || w2 < 0) continue;
        const float z = 1.0f / (w0 * iz0 + w1 * iz1 + w2 * iz2);
        const int idx = y * width + x;
        if (depth[idx] > 0 && depth[idx] <= z) continue;
        depth[idx] = z;
        label[idx] = cls_id;
      }
    }
  }
  delete[] cam;
  delete[] scr;
}

}  // extern "C"
