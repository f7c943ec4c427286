// Device code shared by the path-tracing kernels (sphere_megakernel.cu,
// tape_kernel.cu): the PCG4D counter RNG, the camera sample, the sky and
// the RTIOW material scatter. It is the CUDA twin of the JAX package's
// kernels/common.py (pcg4d_planes, camera_ray_planes, scatter_planes,
// sky_planes, shade_and_advance) and repeats, operation for operation, the
// plain torch path (render/sampling.py, render/integrator.py,
// render/materials.py). Built with -fmad=false and without fast math, so
// every kernel that includes it takes the same float decisions as the
// plain version.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace csgr {

constexpr float kTwoPi = 6.28318530717958647692f;
constexpr float kInv2p24 = 1.0f / 16777216.0f;
constexpr int kCamFloats = 19;  // origin, lower_left, horizontal, vertical, u, v, lens_radius

__device__ __forceinline__ void pcg4d(uint32_t& a, uint32_t& b, uint32_t& c, uint32_t& d) {
  a = a * 1664525u + 1013904223u;
  b = b * 1664525u + 1013904223u;
  c = c * 1664525u + 1013904223u;
  d = d * 1664525u + 1013904223u;
  a += b * d; b += c * a; c += a * b; d += b * c;
  a ^= a >> 16; b ^= b >> 16; c ^= c >> 16; d ^= d >> 16;
  a += b * d; b += c * a; c += a * b; d += b * c;
}

__device__ __forceinline__ float unit_float(uint32_t x) {
  return static_cast<float>(x >> 8) * kInv2p24;
}

// One path's state: origin, direction, throughput, gathered radiance.
struct Path {
  float ox, oy, oz, dx, dy, dz;
  float tr, tg, tb;
  float sr, sg, sb;
};

// Camera sample s of pixel (x, y): jitter and optional thin lens
// (common.camera_ray_planes; integrator.render_tile). Counters
// (pix, s, 0xA5A5A5A5, seed). Resets throughput, keeps radiance.
__device__ __forceinline__ void camera_ray(const float* cam, int x, int y, uint32_t pix,
                                           uint32_t s, uint32_t seed, int width, int height,
                                           int lens, Path& p) {
  uint32_t r0 = pix, r1 = s, r2 = 0xA5A5A5A5u, r3 = seed;
  pcg4d(r0, r1, r2, r3);
  const float st_x = (static_cast<float>(x) + unit_float(r0)) / static_cast<float>(width);
  const float st_y = 1.0f - (static_cast<float>(y) + unit_float(r1)) / static_cast<float>(height);
  float offx = 0.0f, offy = 0.0f, offz = 0.0f;
  if (lens) {
    const float lens_radius = cam[18];
    const float lr = sqrtf(unit_float(r2));
    const float phi = kTwoPi * unit_float(r3);
    const float rd0 = lens_radius * (lr * cosf(phi));
    const float rd1 = lens_radius * (lr * sinf(phi));
    offx = rd0 * cam[12] + rd1 * cam[15];
    offy = rd0 * cam[13] + rd1 * cam[16];
    offz = rd0 * cam[14] + rd1 * cam[17];
  }
  p.ox = cam[0] + offx; p.oy = cam[1] + offy; p.oz = cam[2] + offz;
  p.dx = cam[3] + st_x * cam[6] + st_y * cam[9] - cam[0] - offx;
  p.dy = cam[4] + st_x * cam[7] + st_y * cam[10] - cam[1] - offy;
  p.dz = cam[5] + st_x * cam[8] + st_y * cam[11] - cam[2] - offz;
  p.tr = 1.0f; p.tg = 1.0f; p.tb = 1.0f;
}

// 1/|d| as the plain version's vec.normalized(d, eps=1e-20) forms it.
__device__ __forceinline__ float inv_length(const Path& p) {
  return 1.0f / sqrtf(fmaxf(p.dx * p.dx + p.dy * p.dy + p.dz * p.dz, 1e-20f));
}

// A miss: the sky (0 rtiow, 1 wololo, 2 black) weighted by the throughput.
__device__ __forceinline__ void add_sky(Path& p, int sky, float udy) {
  if (sky == 2) return;
  const float t = sky == 0 ? 0.5f * (udy + 1.0f) : udy;
  p.sr += p.tr * ((1.0f - t) + t * 0.5f);
  p.sg += p.tg * ((1.0f - t) + t * 0.7f);
  p.sb += p.tb * ((1.0f - t) + t * 1.0f);
}

// A hit at (hx, hy, hz): emission, material scatter (common.scatter_planes /
// materials.scatter) and the path's advance. (nx, ny, nz) is the unit
// normal opposing the ray; ``front`` picks the dielectric's eta ratio;
// (udx, udy, udz) is the unit incoming direction. Uniforms come from the
// counters (pix, s, bounce, seed). Returns false when the path ends here.
__device__ __forceinline__ bool shade(Path& p, float hx, float hy, float hz, float nx, float ny,
                                      float nz, bool front, int kind, float param, float ar,
                                      float ag, float ab, float udx, float udy, float udz,
                                      uint32_t pix, uint32_t s, uint32_t bounce, uint32_t seed) {
  uint32_t q0 = pix, q1 = s, q2 = bounce, q3 = seed;
  pcg4d(q0, q1, q2, q3);
  const float u0 = unit_float(q0), u1 = unit_float(q1), u2 = unit_float(q2);

  if (kind == 0 || kind == 4) {  // normal-map debug shading / emissive
    if (kind == 0) {
      p.sr += p.tr * (0.5f * (nx + 1.0f));
      p.sg += p.tg * (0.5f * (ny + 1.0f));
      p.sb += p.tb * (0.5f * (nz + 1.0f));
    } else {
      p.sr += p.tr * ar;
      p.sg += p.tg * ag;
      p.sb += p.tb * ab;
    }
    return false;
  }

  const float z = 1.0f - 2.0f * u0;
  const float rr = sqrtf(fmaxf(0.0f, 1.0f - z * z));
  const float phi = kTwoPi * u1;
  const float rux = rr * cosf(phi), ruy = rr * sinf(phi), ruz = z;
  const float ud_n = udx * nx + udy * ny + udz * nz;
  const float rfx = udx - 2.0f * ud_n * nx;
  const float rfy = udy - 2.0f * ud_n * ny;
  const float rfz = udz - 2.0f * ud_n * nz;

  float ndx, ndy, ndz;
  if (kind == 1) {  // Lambertian: n + random unit vector
    ndx = nx + rux; ndy = ny + ruy; ndz = nz + ruz;
    if (ndx * ndx + ndy * ndy + ndz * ndz < 1e-12f) { ndx = nx; ndy = ny; ndz = nz; }
  } else if (kind == 2) {  // metal: mirror + fuzz, absorbed below the surface
    ndx = rfx + param * rux; ndy = rfy + param * ruy; ndz = rfz + param * ruz;
    if (ndx * nx + ndy * ny + ndz * nz <= 0.0f) return false;
  } else {  // dielectric: Snell + Schlick
    const float ior = fmaxf(param, 1e-6f);
    const float eta = front ? 1.0f / ior : ior;
    const float cos_t = fminf(-ud_n, 1.0f);
    const float sin_t = sqrtf(fmaxf(0.0f, 1.0f - cos_t * cos_t));
    const float q = (1.0f - eta) / (1.0f + eta);
    const float r0s = q * q;
    const float c1 = 1.0f - cos_t;
    const float c2 = c1 * c1;
    const float rp = r0s + (1.0f - r0s) * (c2 * c2 * c1);  // Schlick
    if (eta * sin_t > 1.0f || u2 < rp) {
      ndx = rfx; ndy = rfy; ndz = rfz;
    } else {
      const float ppx = eta * (udx + cos_t * nx);
      const float ppy = eta * (udy + cos_t * ny);
      const float ppz = eta * (udz + cos_t * nz);
      const float par = -sqrtf(fabsf(1.0f - (ppx * ppx + ppy * ppy + ppz * ppz)));
      ndx = ppx + par * nx; ndy = ppy + par * ny; ndz = ppz + par * nz;
    }
  }
  if (kind != 3) { p.tr *= ar; p.tg *= ag; p.tb *= ab; }
  p.ox = hx; p.oy = hy; p.oz = hz;
  p.dx = ndx; p.dy = ndy; p.dz = ndz;
  return true;
}

}  // namespace csgr
