// dvren-tpu native runtime library (C ABI, loaded via ctypes).
//
// Role in the framework (mirrors the reference's split where the CPU
// implementation is the high-precision oracle and the accelerator runs the
// hot path, SURVEY.md section 4):
//   - scalar-sequential double-precision kernels for ray generation,
//     trilinear field evaluation and transmittance integration - the
//     independent referee the JAX pipeline is validated against;
//   - packed-ragged conversion between the dense (N, K) sample
//     lattice and the reference-style packed sample stream with per-ray
//     prefix offsets (hp_samp_t.ray_offset parity view, hp.h:135);
//   - binary PPM encoding for the CLI.
//
// Behavioral contract follows DESIGN_SPECIFICATION.md:87-94 (alpha via
// expm1 with Taylor guard, T recurrence, early termination at T <= 1e-4)
// and the camera model of ray_cpu.cpp:182-226 / ray_cuda.cu:57-84; the
// implementation is original (vectorizable flat loops, double accumulation).

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <algorithm>
#include <vector>

namespace {

constexpr double kStopThreshold = 1e-4;
constexpr double kOpacityEps = 1e-6;

inline double alpha_from(double sigma, double dt) {
    const double od = sigma * dt;
    if (od <= 0.0) return 0.0;
    if (od < 1e-4) return od * (1.0 - 0.5 * od);
    const double a = -std::expm1(-od);
    return std::min(1.0, std::max(a, 0.0));
}

struct GridView {
    const float* data;
    int nx, ny, nz, channels;   // channels == 0 -> scalar grid
};

inline float fetch(const GridView& g, int ix, int iy, int iz, int c) {
    const long idx = ((static_cast<long>(iz) * g.ny + iy) * g.nx + ix);
    return g.channels > 0 ? g.data[idx * g.channels + c] : g.data[idx];
}

// world -> [0,1] local; returns false when outside under OOB_ZERO.
inline bool to_local(const float p[3], const float* bmin, const float* bmax,
                     int oob, double local[3]) {
    bool outside = false;
    for (int i = 0; i < 3; ++i) {
        const double ext = static_cast<double>(bmax[i]) - bmin[i];
        double c = ext != 0.0 ? (p[i] - bmin[i]) / ext : 0.0;
        if (c < 0.0 || c > 1.0) outside = true;
        local[i] = c;
    }
    if (oob == 1) {  // clamp
        for (int i = 0; i < 3; ++i)
            local[i] = std::min(1.0, std::max(0.0, local[i]));
        return true;
    }
    return !outside;
}

inline double sample_channel(const GridView& g, const double local[3],
                             int interp, int c) {
    const double fx = local[0] * (g.nx - 1);
    const double fy = local[1] * (g.ny - 1);
    const double fz = local[2] * (g.nz - 1);
    if (interp == 0) {  // nearest, round half away from zero (coords >= 0)
        const int ix = std::min(g.nx - 1, std::max(0, (int)std::floor(fx + 0.5)));
        const int iy = std::min(g.ny - 1, std::max(0, (int)std::floor(fy + 0.5)));
        const int iz = std::min(g.nz - 1, std::max(0, (int)std::floor(fz + 0.5)));
        return fetch(g, ix, iy, iz, c);
    }
    const int x0 = std::min(g.nx - 1, std::max(0, (int)std::floor(fx)));
    const int y0 = std::min(g.ny - 1, std::max(0, (int)std::floor(fy)));
    const int z0 = std::min(g.nz - 1, std::max(0, (int)std::floor(fz)));
    const int x1 = std::min(x0 + 1, g.nx - 1);
    const int y1 = std::min(y0 + 1, g.ny - 1);
    const int z1 = std::min(z0 + 1, g.nz - 1);
    const double tx = fx - x0, ty = fy - y0, tz = fz - z0;

    auto lerp = [](double a, double b, double t) { return a + (b - a) * t; };
    const double c00 = lerp(fetch(g, x0, y0, z0, c), fetch(g, x1, y0, z0, c), tx);
    const double c10 = lerp(fetch(g, x0, y1, z0, c), fetch(g, x1, y1, z0, c), tx);
    const double c01 = lerp(fetch(g, x0, y0, z1, c), fetch(g, x1, y0, z1, c), tx);
    const double c11 = lerp(fetch(g, x0, y1, z1, c), fetch(g, x1, y1, z1, c), tx);
    return lerp(lerp(c00, c10, ty), lerp(c01, c11, ty), tz);
}

}  // namespace

extern "C" {

// ---------------------------------------------------------------- version

int dvn_abi_version(void) { return 4; }

// ---------------------------------------------------------------- ray gen

// model: 0 = pinhole (+0.5 pixel centers), 1 = orthographic (plane-offset
// origins, no +0.5 - the reference's CUDA convention, ray_cuda.cu:57-84).
int dvn_generate_rays(int model, const float* K, const float* c2w,
                      float ortho_scale, int width, int /*height*/,
                      int roi_x, int roi_y, int roi_w, int roi_h,
                      float t_near, float t_far,
                      float* origins, float* dirs, float* tn, float* tf,
                      uint32_t* pixel_ids) {
    if (!K || !c2w || !origins || !dirs || !tn || !tf || !pixel_ids)
        return 1;
    const double fx = K[0], fy = K[4], cx = K[2], cy = K[5];
    const double r[9] = {c2w[0], c2w[1], c2w[2], c2w[4], c2w[5], c2w[6],
                         c2w[8], c2w[9], c2w[10]};
    const double t[3] = {c2w[3], c2w[7], c2w[11]};

    long idx = 0;
    for (int ly = 0; ly < roi_h; ++ly) {
        for (int lx = 0; lx < roi_w; ++lx, ++idx) {
            const int px = roi_x + lx, py = roi_y + ly;
            double d[3], o[3] = {t[0], t[1], t[2]};
            if (model == 0) {
                const double a = ((px + 0.5) - cx) / fx;
                const double b = ((py + 0.5) - cy) / fy;
                d[0] = r[0] * a + r[1] * b + r[2];
                d[1] = r[3] * a + r[4] * b + r[5];
                d[2] = r[6] * a + r[7] * b + r[8];
            } else {
                d[0] = r[2]; d[1] = r[5]; d[2] = r[8];
                const double u = (px - cx) / fx * ortho_scale;
                const double v = (py - cy) / fy * ortho_scale;
                o[0] += r[0] * u + r[1] * v;
                o[1] += r[3] * u + r[4] * v;
                o[2] += r[6] * u + r[7] * v;
            }
            const double len = std::sqrt(
                std::max(d[0] * d[0] + d[1] * d[1] + d[2] * d[2], 1e-300));
            for (int i = 0; i < 3; ++i) {
                dirs[idx * 3 + i] = static_cast<float>(d[i] / len);
                origins[idx * 3 + i] = static_cast<float>(o[i]);
            }
            tn[idx] = t_near;
            tf[idx] = t_far;
            pixel_ids[idx] = static_cast<uint32_t>(py) * width + px;
        }
    }
    return 0;
}

// ------------------------------------------------------------- field eval

int dvn_eval_grid(const float* grid, int nx, int ny, int nz, int channels,
                  const float* bbox_min, const float* bbox_max,
                  int interp, int oob,
                  const float* positions, long n_points, float* out) {
    if (!grid || !positions || !out || nx <= 0 || ny <= 0 || nz <= 0)
        return 1;
    const GridView g{grid, nx, ny, nz, channels};
    const int nc = channels > 0 ? channels : 1;
    for (long i = 0; i < n_points; ++i) {
        double local[3];
        const bool inside = to_local(positions + i * 3, bbox_min, bbox_max,
                                     oob, local);
        for (int c = 0; c < nc; ++c) {
            out[i * nc + c] = inside
                ? static_cast<float>(sample_channel(g, local, interp, c))
                : 0.0f;
        }
    }
    return 0;
}

// ------------------------------------------------------------ integration

// Dense-lattice integration, double accumulation, sequential recurrence
// with early termination. aux (optional, may be null): (alpha, weight,
// T_before, logT_before) per slot, zero for unprocessed slots.
int dvn_integrate(long n_rays, int max_steps,
                  const float* sigma, const float* color, const float* dt,
                  const uint8_t* mask, float t_near, float t_far,
                  float* radiance, float* trans, float* opacity,
                  float* depth, float* aux) {
    if (!sigma || !color || !dt || !mask) return 1;
    for (long ray = 0; ray < n_rays; ++ray) {
        double T = 1.0, acc[3] = {0, 0, 0}, depth_w = 0.0;
        double t_cursor = t_near;
        const long base = ray * max_steps;
        for (int k = 0; k < max_steps; ++k) {
            const long s = base + k;
            if (!mask[s]) continue;
            const double dts = dt[s];
            const double a = alpha_from(sigma[s], dts);
            const double T_before = T;
            const double w = T_before * a;
            for (int c = 0; c < 3; ++c) acc[c] += w * color[s * 3 + c];
            depth_w += w * (t_cursor + 0.5 * dts);
            if (aux) {
                aux[s * 4 + 0] = static_cast<float>(a);
                aux[s * 4 + 1] = static_cast<float>(w);
                aux[s * 4 + 2] = static_cast<float>(T_before);
                aux[s * 4 + 3] = static_cast<float>(
                    std::log(std::max(T_before, 1e-30)));
            }
            T *= std::max(1.0 - a, 0.0);
            t_cursor += dts;
            if (T <= kStopThreshold) break;
        }
        for (int c = 0; c < 3; ++c)
            radiance[ray * 3 + c] = static_cast<float>(acc[c]);
        trans[ray] = static_cast<float>(T);
        const double op = 1.0 - T;
        opacity[ray] = static_cast<float>(op);
        depth[ray] = static_cast<float>(
            op > kOpacityEps ? depth_w / op : t_far);
    }
    return 0;
}

// --------------------------------------------------- packed-ragged views

// Count live samples and fill (n_rays + 1) prefix offsets.
long dvn_ray_offsets(long n_rays, int max_steps, const uint8_t* mask,
                     uint32_t* offsets) {
    long total = 0;
    for (long ray = 0; ray < n_rays; ++ray) {
        offsets[ray] = static_cast<uint32_t>(total);
        const long base = ray * max_steps;
        for (int k = 0; k < max_steps; ++k)
            total += mask[base + k] ? 1 : 0;
    }
    offsets[n_rays] = static_cast<uint32_t>(total);
    return total;
}

// Compact dense (n_rays, max_steps, channels) values into the packed
// stream (row-major over live slots). Returns packed count.
long dvn_pack_samples(long n_rays, int max_steps, int channels,
                      const uint8_t* mask, const float* dense,
                      float* packed) {
    long out = 0;
    const long stride = static_cast<long>(max_steps) * channels;
    for (long ray = 0; ray < n_rays; ++ray) {
        const float* row = dense + ray * stride;
        const uint8_t* mrow = mask + ray * max_steps;
        for (int k = 0; k < max_steps; ++k) {
            if (!mrow[k]) continue;
            std::memcpy(packed + out * channels, row + (long)k * channels,
                        sizeof(float) * channels);
            ++out;
        }
    }
    return out;
}

// Scatter packed per-sample values back onto the dense lattice (inverse of
// dvn_pack_samples); unmasked slots are zero-filled.
long dvn_unpack_samples(long n_rays, int max_steps, int channels,
                        const uint8_t* mask, const float* packed,
                        float* dense) {
    long in = 0;
    const long stride = static_cast<long>(max_steps) * channels;
    for (long ray = 0; ray < n_rays; ++ray) {
        float* row = dense + ray * stride;
        const uint8_t* mrow = mask + ray * max_steps;
        for (int k = 0; k < max_steps; ++k) {
            if (mrow[k]) {
                std::memcpy(row + (long)k * channels, packed + in * channels,
                            sizeof(float) * channels);
                ++in;
            } else {
                std::memset(row + (long)k * channels, 0,
                            sizeof(float) * channels);
            }
        }
    }
    return in;
}

// ---------------------------------------------------------------- PPM IO

int dvn_write_ppm(const char* path, const float* image, int width,
                  int height) {
    FILE* f = std::fopen(path, "wb");
    if (!f) return 1;
    std::fprintf(f, "P6\n%d %d\n255\n", width, height);
    const long n = static_cast<long>(width) * height * 3;
    for (long i = 0; i < n; ++i) {
        const float v = std::min(1.0f, std::max(0.0f, image[i]));
        const unsigned char b =
            static_cast<unsigned char>(std::lround(v * 255.0f));
        std::fputc(b, f);
    }
    std::fclose(f);
    return 0;
}

}  // extern "C"
