// Orthographic z-buffer mesh rasterizer (CPU, C ABI).
//
// A copy of human_dynamics_tpu/native/rasterizer.cpp for the PyTorch port,
// which builds it at first use into its own build directory
// (viz/renderer.py). It stands in for the CUDA neural_renderer of the
// reference's VisRenderer (src/util/render/nmr_renderer.py), which is used
// for visualisation only, so this is a plain scanline rasterizer with:
//   - orthographic projection (verts arrive pre-projected to [-1,1]^2
//     with z kept for depth),
//   - lambertian shading: intensity = int_amb + int_dir * max(0, n.l)
//     (NMR's lighting model with the reference's defaults
//     direction [1,.5,-1], int_dir 0.3, int_amb 0.7),
//   - silhouette mask output,
//   - white background compositing left to the caller (mask returned).
//
// Build: g++ -O3 -shared -fPIC rasterizer.cpp -o librasterizer.so

#include <cmath>
#include <cstdint>
#include <cstring>
#include <algorithm>

extern "C" {

// verts: (n_verts, 3) float, x/y in [-1, 1] (x right, y DOWN), z depth
//        (smaller = closer to camera).
// faces: (n_faces, 3) int32 vertex indices.
// color: (3,) float base color in [0, 1].
// light_dir: (3,) float, need not be normalized.
// out_rgb: (size, size, 3) float, overwritten where mask=1.
// out_mask: (size, size) float in {0, 1}.
void render_mesh(
    const float* verts, int n_verts,
    const int32_t* faces, int n_faces,
    int size,
    const float* color,
    const float* light_dir, float int_dir, float int_amb,
    float* out_rgb, float* out_mask)
{
    const int n_pix = size * size;
    float* zbuf = new float[n_pix];
    for (int i = 0; i < n_pix; ++i) zbuf[i] = 1e30f;
    std::memset(out_mask, 0, n_pix * sizeof(float));

    // Normalize light.
    float lnorm = std::sqrt(light_dir[0] * light_dir[0] +
                            light_dir[1] * light_dir[1] +
                            light_dir[2] * light_dir[2]);
    float lx = light_dir[0] / lnorm;
    float ly = light_dir[1] / lnorm;
    float lz = light_dir[2] / lnorm;

    const float half = 0.5f * (float)size;

    for (int f = 0; f < n_faces; ++f) {
        const int32_t i0 = faces[3 * f], i1 = faces[3 * f + 1],
                      i2 = faces[3 * f + 2];
        if (i0 < 0 || i0 >= n_verts || i1 < 0 || i1 >= n_verts ||
            i2 < 0 || i2 >= n_verts)
            continue;
        // Pixel coords: x in [-1,1] -> [0, size].
        const float x0 = (verts[3 * i0] + 1.f) * half;
        const float y0 = (verts[3 * i0 + 1] + 1.f) * half;
        const float z0 = verts[3 * i0 + 2];
        const float x1 = (verts[3 * i1] + 1.f) * half;
        const float y1 = (verts[3 * i1 + 1] + 1.f) * half;
        const float z1 = verts[3 * i1 + 2];
        const float x2 = (verts[3 * i2] + 1.f) * half;
        const float y2 = (verts[3 * i2 + 1] + 1.f) * half;
        const float z2 = verts[3 * i2 + 2];

        // Face normal in 3D (screen x, screen y-down, z): flip y back to
        // y-up for lighting so normals match the camera frame.
        const float ax = x1 - x0, ay = -(y1 - y0), az = z1 - z0;
        const float bx = x2 - x0, by = -(y2 - y0), bz = z2 - z0;
        float nx_ = ay * bz - az * by;
        float ny_ = az * bx - ax * bz;
        float nz_ = ax * by - ay * bx;
        const float nn = std::sqrt(nx_ * nx_ + ny_ * ny_ + nz_ * nz_);
        if (nn < 1e-12f) continue;
        nx_ /= nn; ny_ /= nn; nz_ /= nn;
        // Camera looks along +z (after look_at from -z); make normals
        // face the camera.
        if (nz_ > 0.f) { nx_ = -nx_; ny_ = -ny_; nz_ = -nz_; }

        float ndotl = nx_ * lx + ny_ * ly + nz_ * lz;
        if (ndotl < 0.f) ndotl = 0.f;
        const float intensity = std::min(1.f, int_amb + int_dir * ndotl);
        const float r = std::min(1.f, color[0] * intensity);
        const float g = std::min(1.f, color[1] * intensity);
        const float b = std::min(1.f, color[2] * intensity);

        // Bounding box.
        int min_x = (int)std::floor(std::min(x0, std::min(x1, x2)));
        int max_x = (int)std::ceil(std::max(x0, std::max(x1, x2)));
        int min_y = (int)std::floor(std::min(y0, std::min(y1, y2)));
        int max_y = (int)std::ceil(std::max(y0, std::max(y1, y2)));
        min_x = std::max(min_x, 0);
        min_y = std::max(min_y, 0);
        max_x = std::min(max_x, size - 1);
        max_y = std::min(max_y, size - 1);
        if (min_x > max_x || min_y > max_y) continue;

        const float denom = (y1 - y2) * (x0 - x2) + (x2 - x1) * (y0 - y2);
        if (std::fabs(denom) < 1e-12f) continue;
        const float inv_denom = 1.f / denom;

        for (int py = min_y; py <= max_y; ++py) {
            const float fy = (float)py + 0.5f;
            for (int px = min_x; px <= max_x; ++px) {
                const float fx = (float)px + 0.5f;
                const float w0 =
                    ((y1 - y2) * (fx - x2) + (x2 - x1) * (fy - y2)) *
                    inv_denom;
                const float w1 =
                    ((y2 - y0) * (fx - x2) + (x0 - x2) * (fy - y2)) *
                    inv_denom;
                const float w2 = 1.f - w0 - w1;
                if (w0 < 0.f || w1 < 0.f || w2 < 0.f) continue;
                const float z = w0 * z0 + w1 * z1 + w2 * z2;
                const int idx = py * size + px;
                if (z < zbuf[idx]) {
                    zbuf[idx] = z;
                    out_rgb[3 * idx] = r;
                    out_rgb[3 * idx + 1] = g;
                    out_rgb[3 * idx + 2] = b;
                    out_mask[idx] = 1.f;
                }
            }
        }
    }
    delete[] zbuf;
}

}  // extern "C"
