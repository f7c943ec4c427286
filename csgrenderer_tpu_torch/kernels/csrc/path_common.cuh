// Device code shared by the path-tracing kernels (sphere_megakernel.cu,
// tape_kernel.cu): the PCG4D counter RNG, the camera sample, the sky, the
// RTIOW material scatter and next-event estimation (NEE) with MIS. It is
// the CUDA twin of the JAX package's kernels/common.py (pcg4d_planes,
// camera_ray_planes, scatter_planes, sky_planes, shade_and_advance,
// nee_sample_planes, scatter_pdf_*_planes, bsdf_mis_scale_*planes) and
// repeats, operation for operation, the plain torch path
// (render/sampling.py, render/integrator.py, render/materials.py,
// render/lights.py). Built with -fmad=false and without fast math, so every
// kernel that includes it takes the same float decisions as the plain
// version.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace csgr {

constexpr float kTwoPi = 6.28318530717958647692f;
constexpr float kFourPi = 12.5663706143591729539f;
constexpr float kInvPi = 0.318309886183790671538f;
constexpr float kInv2p24 = 1.0f / 16777216.0f;
constexpr int kCamFloats = 19;  // origin, lower_left, horizontal, vertical, u, v, lens_radius

// NEE constants of render/lights.py and render/integrator.py
constexpr uint32_t kNeeBit = 0x80000000u;  // bounce-counter bit of the NEE uniforms
constexpr float kLampMiss = 1e30f;         // sphere_ray_t's miss
constexpr float kLampMissCut = 1e29f;      // a lamp distance at or past this is a miss
constexpr float kShadowScale = 0.9999f;    // occluded iff a hit lies below tl * this
constexpr float kOutsideScale = 1.000001f; // p is outside a lamp iff dist^2 > r^2 * this
constexpr float kGlossyFuzz = 1e-4f;       // metal with fuzz above this pairs with NEE

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
// kNee: a lamp's emission is scaled by ``emit_scale`` (the MIS partner
// weight, 1 where none applies); without NEE the code is as it was.
template <bool kNee = false>
__device__ __forceinline__ bool shade(Path& p, float hx, float hy, float hz, float nx, float ny,
                                      float nz, bool front, int kind, float param, float ar,
                                      float ag, float ab, float udx, float udy, float udz,
                                      uint32_t pix, uint32_t s, uint32_t bounce, uint32_t seed,
                                      float emit_scale = 1.0f) {
  uint32_t q0 = pix, q1 = s, q2 = bounce, q3 = seed;
  pcg4d(q0, q1, q2, q3);
  const float u0 = unit_float(q0), u1 = unit_float(q1), u2 = unit_float(q2);

  if (kind == 0 || kind == 4) {  // normal-map debug shading / emissive
    if (kind == 0) {
      p.sr += p.tr * (0.5f * (nx + 1.0f));
      p.sg += p.tg * (0.5f * (ny + 1.0f));
      p.sb += p.tb * (0.5f * (nz + 1.0f));
    } else if (kNee) {  // (throughput * emitted) * weight, as the plain version groups it
      p.sr += p.tr * ar * emit_scale;
      p.sg += p.tg * ag * emit_scale;
      p.sb += p.tb * ab * emit_scale;
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

// ---------------------------------------------------------------------------
// Next-event estimation with MIS (render/lights.py, integrator.trace_paths)
// ---------------------------------------------------------------------------

// Cosine-lobe pdf of a scatter direction d (lights.scatter_pdf_lambertian).
__device__ __forceinline__ float scatter_pdf_lam(float nx, float ny, float nz, float dx, float dy,
                                                 float dz) {
  const float inv = 1.0f / sqrtf(fmaxf(dx * dx + dy * dy + dz * dz, 1e-20f));
  return fmaxf(nx * (dx * inv) + ny * (dy * inv) + nz * (dz * inv), 0.0f) * kInvPi;
}

// Fuzzy-metal lobe pdf of direction d (lights.scatter_pdf_metal): the
// scatter's endpoint is uniform on the radius-fuzz sphere around the unit
// mirror direction. (udx, udy, udz) is the unit incoming direction.
__device__ __forceinline__ float scatter_pdf_metal(float udx, float udy, float udz, float nx,
                                                   float ny, float nz, float fuzz, float dx,
                                                   float dy, float dz) {
  const float udn = udx * nx + udy * ny + udz * nz;
  const float rx = udx - 2.0f * udn * nx;
  const float ry = udy - 2.0f * udn * ny;
  const float rz = udz - 2.0f * udn * nz;
  const float inv = 1.0f / sqrtf(fmaxf(dx * dx + dy * dy + dz * dz, 1e-20f));
  const float c = (dx * inv) * rx + (dy * inv) * ry + (dz * inv) * rz;
  const float f = fmaxf(fuzz, kGlossyFuzz);
  const float g2 = c * c - 1.0f + f * f;
  if (!(fuzz > kGlossyFuzz && g2 > 0.0f)) return 0.0f;
  const float g = sqrtf(fmaxf(g2, 1e-20f));
  const float tp = c + g, tm = c - g;
  const float num = (tp > 0.0f ? tp * tp : 0.0f) + (tm > 0.0f ? tm * tm : 0.0f);
  return num / (kFourPi * f * g);
}

// The cone's inverse pdf 2 pi (1 - cos_max) of lamp (c, r) seen from o,
// with cos_max; false when o is inside the lamp (no cone).
__device__ __forceinline__ bool lamp_cone(float tox, float toy, float toz, float r, float& dist2,
                                          float& cos_max) {
  dist2 = tox * tox + toy * toy + toz * toz;
  const float r2 = r * r;
  cos_max = sqrtf(fmaxf(1.0f - r2 / fmaxf(dist2, 1e-20f), 0.0f));
  return dist2 > r2 * kOutsideScale;
}

// The balance-heuristic partner weight of lamp emission reached by a
// scatter of pdf prev_pdf from o (lights._cone_partner):
// q / (q + 1), q = prev_pdf * L * ip, ip = BIG when o is inside the lamp.
__device__ __forceinline__ float partner_weight(float cx, float cy, float cz, float r, float ox,
                                                float oy, float oz, float prev_pdf, int n_lamps) {
  float dist2, cos_max;
  const bool outside = lamp_cone(cx - ox, cy - oy, cz - oz, r, dist2, cos_max);
  const float ip = outside ? kTwoPi * (1.0f - cos_max) : kLampMiss;
  const float q = prev_pdf * static_cast<float>(n_lamps) * ip;
  return q / (q + 1.0f);
}

// The NEE uniforms of a vertex (counters (pix, s, bounce | kNeeBit, seed))
// and the lamp they pick, uniformly among n_lamps.
__device__ __forceinline__ int nee_pick(uint32_t pix, uint32_t s, uint32_t bounce, uint32_t seed,
                                        int n_lamps, float& u1, float& u2) {
  uint32_t q0 = pix, q1 = s, q2 = bounce | kNeeBit, q3 = seed;
  pcg4d(q0, q1, q2, q3);
  u1 = unit_float(q1);
  u2 = unit_float(q2);
  return min(static_cast<int>(unit_float(q0) * static_cast<float>(n_lamps)), n_lamps - 1);
}

// One lamp sample from hit point P (lights.nee_contribution up to its
// shadow ray; common.nee_sample_planes): a direction uniform in the cone of
// lamp (c, r, emission e), the analytic lamp distance tl along it, and the
// folded MIS-weighted contribution w = albedo * e * q / (1 + q),
// q = pdf_b * L * ip. pdf_b is the vertex's own lobe: the cosine lobe at a
// Lambertian vertex, the metal lobe (gated by cos > 0) at a glossy one.
// Returns false when there is nothing to trace (a back-facing or empty
// lobe, P inside the lamp, or the lamp missed): the plain version's
// contribution is then exactly zero. Otherwise the caller traces a shadow
// ray (P, d) and adds the throughput times w when no hit lies below
// tl * kShadowScale.
struct LampSample {
  float dx, dy, dz, tl, wr, wg, wb;
};

__device__ __forceinline__ bool nee_sample(float px, float py, float pz, float nx, float ny,
                                           float nz, bool lambertian, float fuzz, float udx,
                                           float udy, float udz, float ar, float ag, float ab,
                                           float cx, float cy, float cz, float r, float er,
                                           float eg, float eb, int n_lamps, float u1, float u2,
                                           LampSample& ls) {
  // sample_sphere_cone
  const float tox = cx - px, toy = cy - py, toz = cz - pz;
  float dist2, cos_max;
  const bool outside = lamp_cone(tox, toy, toz, r, dist2, cos_max);
  const float z = 1.0f + u2 * (cos_max - 1.0f);  // cos(theta) uniform in [cos_max, 1]
  const float phi = kTwoPi * u1;
  const float sin_t = sqrtf(fmaxf(1.0f - z * z, 0.0f));
  const float inv = 1.0f / sqrtf(fmaxf(dist2, 1e-20f));
  const float wx = tox * inv, wy = toy * inv, wz = toz * inv;
  const float sign = wz >= 0.0f ? 1.0f : -1.0f;  // branchless orthonormal basis around w
  const float a = -1.0f / (sign + wz);
  const float b = wx * wy * a;
  const float t0x = 1.0f + sign * wx * wx * a, t0y = sign * b, t0z = -sign * wx;
  const float t1x = b, t1y = sign + wy * wy * a, t1z = -wy;
  const float cp = cosf(phi) * sin_t, sp = sinf(phi) * sin_t;
  ls.dx = cp * t0x + sp * t1x + z * wx;
  ls.dy = cp * t0y + sp * t1y + z * wy;
  ls.dz = cp * t0z + sp * t1z + z * wz;
  const float inv_pdf = outside ? kTwoPi * (1.0f - cos_max) : 0.0f;

  // the vertex lobe's pdf toward the sample
  const float cos_n = nx * ls.dx + ny * ls.dy + nz * ls.dz;
  float pdf_b;
  if (lambertian) {
    pdf_b = fmaxf(cos_n, 0.0f) * kInvPi;
  } else {  // light below the horizon carries no BRDF (the metal absorbs it)
    pdf_b = cos_n > 0.0f ? scatter_pdf_metal(udx, udy, udz, nx, ny, nz, fuzz, ls.dx, ls.dy, ls.dz)
                       : 0.0f;
  }

  // sphere_ray_t: the nearest t > 1e-3 on the lamp along the sample
  const float ocx = px - cx, ocy = py - cy, ocz = pz - cz;
  const float half_b = ocx * ls.dx + ocy * ls.dy + ocz * ls.dz;
  const float cc = (ocx * ocx + ocy * ocy + ocz * ocz) - r * r;
  const float disc = half_b * half_b - cc;
  ls.tl = kLampMiss;
  if (disc >= 0.0f) {  // the plain version's NaN on a miss rejects every test below
    const float sq = sqrtf(disc);
    const float t0 = -half_b - sq, t1 = -half_b + sq;
    const float t = t0 > 1e-3f ? t0 : t1;
    if (t > 1e-3f) ls.tl = t;
  }
  if (!(pdf_b > 0.0f && inv_pdf > 0.0f && ls.tl < kLampMissCut)) return false;

  const float q = pdf_b * static_cast<float>(n_lamps) * inv_pdf;
  const float scale = q / (1.0f + q);
  ls.wr = ar * er * scale;
  ls.wg = ag * eg * scale;
  ls.wb = ab * eb * scale;
  return true;
}

// The scatter pdf a NEE path carries to its next vertex: the cosine lobe
// after a Lambertian scatter, the metal lobe after a glossy one, 0 after
// any other vertex (integrator.trace_paths' prev_pdf_b).
__device__ __forceinline__ float carried_pdf(const Path& p, bool lambertian, bool glossy, float nx,
                                             float ny, float nz, float fuzz, float udx, float udy,
                                             float udz) {
  if (lambertian) return scatter_pdf_lam(nx, ny, nz, p.dx, p.dy, p.dz);
  if (glossy) return scatter_pdf_metal(udx, udy, udz, nx, ny, nz, fuzz, p.dx, p.dy, p.dz);
  return 0.0f;
}

}  // namespace csgr
