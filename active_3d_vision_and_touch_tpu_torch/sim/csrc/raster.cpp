// Triangle depth rasterizer for the host-side simulator.
//
// Native replacement for the rasterization the reference outsourced to
// pyrender/EGL (simulator/rendering/*.py). Renders a perspective depth map
// (+ face ids) of a triangle soup with a z-buffer; shading happens in
// Python from the face ids. Single-threaded per call; callers parallelize
// across scenes/cameras with a thread pool (ctypes releases the GIL).
//
// Build: see Makefile (g++ -O3 -shared -fPIC).

#include <cstdint>
#include <cmath>
#include <algorithm>
#include <vector>

extern "C" {

// cam_rot: 3x3 row-major world->camera (rows = right, down, forward)
// depth_out: H*W floats, 0 = no hit; face_id_out: H*W int32, -1 = no hit
void rasterize_depth(const float* verts, int n_verts,
                     const int32_t* faces, int n_faces,
                     const float* cam_pos, const float* cam_rot,
                     float fx, float fy, float cx, float cy,
                     int width, int height,
                     float znear,
                     float* depth_out, int32_t* face_id_out) {
    const int npix = width * height;
    for (int i = 0; i < npix; ++i) {
        depth_out[i] = 0.0f;
        face_id_out[i] = -1;
    }

    // transform all vertices to camera space once
    std::vector<float> cam(n_verts * 3);
    for (int v = 0; v < n_verts; ++v) {
        float px = verts[3 * v] - cam_pos[0];
        float py = verts[3 * v + 1] - cam_pos[1];
        float pz = verts[3 * v + 2] - cam_pos[2];
        for (int r = 0; r < 3; ++r) {
            cam[3 * v + r] = cam_rot[3 * r] * px + cam_rot[3 * r + 1] * py +
                             cam_rot[3 * r + 2] * pz;
        }
    }

    for (int f = 0; f < n_faces; ++f) {
        const int32_t i0 = faces[3 * f], i1 = faces[3 * f + 1], i2 = faces[3 * f + 2];
        const float* a = &cam[3 * i0];
        const float* b = &cam[3 * i1];
        const float* c = &cam[3 * i2];
        // near-plane reject (no clipping — cameras sit away from geometry)
        if (a[2] <= znear || b[2] <= znear || c[2] <= znear) continue;

        const float inv_za = 1.0f / a[2], inv_zb = 1.0f / b[2], inv_zc = 1.0f / c[2];
        const float ax = fx * a[0] * inv_za + cx, ay = fy * a[1] * inv_za + cy;
        const float bx = fx * b[0] * inv_zb + cx, by = fy * b[1] * inv_zb + cy;
        const float cx_ = fx * c[0] * inv_zc + cx, cy_ = fy * c[1] * inv_zc + cy;

        int minx = std::max(0, (int)std::floor(std::min({ax, bx, cx_})));
        int maxx = std::min(width - 1, (int)std::ceil(std::max({ax, bx, cx_})));
        int miny = std::max(0, (int)std::floor(std::min({ay, by, cy_})));
        int maxy = std::min(height - 1, (int)std::ceil(std::max({ay, by, cy_})));
        if (minx > maxx || miny > maxy) continue;

        const float area = (bx - ax) * (cy_ - ay) - (by - ay) * (cx_ - ax);
        if (std::fabs(area) < 1e-12f) continue;
        const float inv_area = 1.0f / area;

        for (int y = miny; y <= maxy; ++y) {
            const float py = y + 0.0f;
            for (int x = minx; x <= maxx; ++x) {
                const float px = x + 0.0f;
                float w0 = ((bx - px) * (cy_ - py) - (by - py) * (cx_ - px)) * inv_area;
                float w1 = ((cx_ - px) * (ay - py) - (cy_ - py) * (ax - px)) * inv_area;
                float w2 = 1.0f - w0 - w1;
                if (w0 < 0.0f || w1 < 0.0f || w2 < 0.0f) continue;
                // perspective-correct depth: 1/z interpolates linearly
                const float inv_z = w0 * inv_za + w1 * inv_zb + w2 * inv_zc;
                const float z = 1.0f / inv_z;
                const int idx = y * width + x;
                if (depth_out[idx] == 0.0f || z < depth_out[idx]) {
                    depth_out[idx] = z;
                    face_id_out[idx] = f;
                }
            }
        }
    }
}

// Möller–Trumbore ray/mesh intersection: returns number of hits written
// (up to max_hits), filling t values and face ids, unsorted.
int ray_mesh_hits(const float* verts, int n_verts,
                  const int32_t* faces, int n_faces,
                  const float* origin, const float* dir,
                  float* t_out, int32_t* face_out, int max_hits) {
    (void)n_verts;
    int hits = 0;
    const float eps = 1e-9f;
    for (int f = 0; f < n_faces && hits < max_hits; ++f) {
        const float* a = &verts[3 * faces[3 * f]];
        const float* b = &verts[3 * faces[3 * f + 1]];
        const float* c = &verts[3 * faces[3 * f + 2]];
        float e1[3] = {b[0] - a[0], b[1] - a[1], b[2] - a[2]};
        float e2[3] = {c[0] - a[0], c[1] - a[1], c[2] - a[2]};
        float p[3] = {dir[1] * e2[2] - dir[2] * e2[1],
                      dir[2] * e2[0] - dir[0] * e2[2],
                      dir[0] * e2[1] - dir[1] * e2[0]};
        float det = e1[0] * p[0] + e1[1] * p[1] + e1[2] * p[2];
        if (std::fabs(det) < eps) continue;
        float inv_det = 1.0f / det;
        float s[3] = {origin[0] - a[0], origin[1] - a[1], origin[2] - a[2]};
        float u = (s[0] * p[0] + s[1] * p[1] + s[2] * p[2]) * inv_det;
        if (u < 0.0f || u > 1.0f) continue;
        float q[3] = {s[1] * e1[2] - s[2] * e1[1],
                      s[2] * e1[0] - s[0] * e1[2],
                      s[0] * e1[1] - s[1] * e1[0]};
        float v = (dir[0] * q[0] + dir[1] * q[1] + dir[2] * q[2]) * inv_det;
        if (v < 0.0f || u + v > 1.0f) continue;
        float t = (e2[0] * q[0] + e2[1] * q[1] + e2[2] * q[2]) * inv_det;
        if (t < 0.0f) continue;
        t_out[hits] = t;
        face_out[hits] = f;
        ++hits;
    }
    return hits;
}

}  // extern "C"
