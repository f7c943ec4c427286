// Sphere path-tracing megakernel for Hopper (sm_90a), grid and brute modes.
//
// Replaces csgrenderer_tpu/kernels/megakernel.py::_make_kernel (the Pallas
// TPU kernel launched by _render_packed) in both of its sphere modes:
//   - grid mode: the globals (ground, heroes, spilled spheres) are brute
//     forced, then a per-ray 2D xz-grid DDA walks m-slot cell lists
//     (worklist.grid_setup / grid_step);
//   - brute mode: every sphere is tested against every ray (intersect_tile).
// It computes what the TPU kernel computes (RTIOW materials, PCG4D counters
// keyed by (pixel, sample, bounce, seed), per-pixel radiance over spp,
// traced-segment counts), not its block structure: one thread per pixel,
// looping over samples and bounces. Next-event estimation is not here.
//
// What bounds it on an H100: divergent FP32 ALU work (threads of a warp
// take different materials, bounce counts and DDA walk lengths) and the
// dependent global loads of each DDA step (cell list, then each listed
// sphere). This first version does nothing yet about either: no ray
// regeneration or compaction, no shared-memory staging of the tables.
//
// Numerics: the kernel repeats, operation for operation and in the same
// order, the float arithmetic of its plain torch version (the reference's
// expanded quadratic, materials, camera), and is built with -fmad=false and
// without --use_fast_math, so no multiply-add is contracted and sqrt and
// division are IEEE-rounded: kernel and plain version take the same
// silhouette decisions. A non-positive discriminant is tested explicitly,
// so a miss or an empty slot can never become a hit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kBig = 1e30f;
constexpr float kBigCut = 5e29f;
constexpr float kEpsFlat = 1e-12f;
constexpr float kTwoPi = 6.28318530717958647692f;
constexpr float kInv2p24 = 1.0f / 16777216.0f;
constexpr float kTMin = 1e-3f;  // hit epsilon along t
constexpr float kTFar = 1e9f;   // farthest valid hit

struct Params {
  const float* cam;      // [24]: origin, lower_left, horizontal, vertical, u, v, lens_radius
  const float4* sph;     // [S, 3] float4: (cx,cy,cz,r2) (c.c,r,kind,param) (ar,ag,ab,0)
  int n_brute;           // spheres brute-forced per segment (the globals in grid mode)
  const int* cell_ids;   // [cx*cz, m] reordered sphere ids, -1 = empty (grid mode)
  int cx, cz, m, max_steps;
  float x0, z0, x1, z1, y_lo, y_hi, cell, inv_cell;
  int width, height, spp, max_bounces;
  uint32_t seed, sample_offset;
  int lens, sky;         // sky: 0 rtiow, 1 wololo, 2 black
  float* out_rgb;        // [H, W, 3]
  int* out_rays;         // [H, W]
};

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

struct Ray {
  float ox, oy, oz, dx, dy, dz;
  float od, oo, a, inv_a;  // o.d, o.o, d.d, 1/d.d
};

// Nearest root past kTMin of the expanded quadratic (intersect.quadratic_t),
// or kBig. g0 = (cx, cy, cz, r2), cc = c.c.
__device__ __forceinline__ float sphere_t(const Ray& r, float4 g0, float cc) {
  const float dc = r.dx * g0.x + r.dy * g0.y + r.dz * g0.z;
  const float oc = r.ox * g0.x + r.oy * g0.y + r.oz * g0.z;
  const float half_b = r.od - dc;
  const float c_term = r.oo - 2.0f * oc + cc - g0.w;
  const float disc = half_b * half_b - r.a * c_term;
  if (!(disc > 0.0f)) return kBig;
  const float sq = sqrtf(disc);
  const float t0 = (-half_b - sq) * r.inv_a;
  const float t1 = (-half_b + sq) * r.inv_a;
  const float t = t0 > kTMin ? t0 : t1;
  return (t > kTMin && t < kTFar) ? t : kBig;
}

__device__ __forceinline__ float sphere_t(const Params& p, const Ray& r, int id) {
  return sphere_t(r, __ldg(p.sph + 3 * id), __ldg(reinterpret_cast<const float*>(p.sph + 3 * id + 1)));
}

__device__ __forceinline__ void axis_range(float o, float d, float inv, float lo, float hi,
                                           float& lo_t, float& hi_t) {
  if (fabsf(d) < kEpsFlat) {
    const bool inside = o >= lo && o <= hi;
    lo_t = inside ? -kBig : kBig;
    hi_t = inside ? kBig : -kBig;
    return;
  }
  const float t0 = (lo - o) * inv;
  const float t1 = (hi - o) * inv;
  lo_t = fminf(t0, t1);
  hi_t = fmaxf(t0, t1);
}

// 2D xz-grid DDA over the cell lists (worklist.grid_setup + grid_step),
// refining (t_best, id_best) found by the globals.
__device__ void grid_walk(const Params& p, const Ray& r, float& t_best, int& id_best) {
  const float ox = r.ox, oy = r.oy, oz = r.oz, dx = r.dx, dy = r.dy, dz = r.dz;
  const float inv_dx = 1.0f / dx, inv_dy = 1.0f / dy, inv_dz = 1.0f / dz;
  float tx_lo, tx_hi, ty_lo, ty_hi, tz_lo, tz_hi;
  axis_range(ox, dx, inv_dx, p.x0, p.x1, tx_lo, tx_hi);
  axis_range(oy, dy, inv_dy, p.y_lo, p.y_hi, ty_lo, ty_hi);
  axis_range(oz, dz, inv_dz, p.z0, p.z1, tz_lo, tz_hi);
  const float t_in = fmaxf(fmaxf(tx_lo, ty_lo), fmaxf(tz_lo, 1e-3f));
  const float t_out = fminf(fminf(fminf(tx_hi, ty_hi), tz_hi), t_best);
  if (!(t_in <= t_out)) return;

  const float px = ox + t_in * dx;
  const float pz = oz + t_in * dz;
  int ix = static_cast<int>(fminf(fmaxf(floorf((px - p.x0) * p.inv_cell), 0.0f),
                                  static_cast<float>(p.cx - 1)));
  int iz = static_cast<int>(fminf(fmaxf(floorf((pz - p.z0) * p.inv_cell), 0.0f),
                                  static_cast<float>(p.cz - 1)));
  const int step_x = (dx > 0.0f) - (dx < 0.0f);
  const int step_z = (dz > 0.0f) - (dz < 0.0f);
  const bool flat_x = fabsf(dx) < kEpsFlat;
  const bool flat_z = fabsf(dz) < kEpsFlat;
  const float next_bx = p.x0 + static_cast<float>(ix + (step_x > 0 ? 1 : 0)) * p.cell;
  const float next_bz = p.z0 + static_cast<float>(iz + (step_z > 0 ? 1 : 0)) * p.cell;
  float tmaxx = flat_x ? kBig : (next_bx - ox) * inv_dx;
  float tmaxz = flat_z ? kBig : (next_bz - oz) * inv_dz;
  const float tdx = flat_x ? kBig : fabsf(p.cell * inv_dx);
  const float tdz = flat_z ? kBig : fabsf(p.cell * inv_dz);

  for (int step = 0; step < p.max_steps; ++step) {
    const int* row = p.cell_ids + (ix * p.cz + iz) * p.m;
    for (int j = 0; j < p.m; ++j) {
      const int id = __ldg(row + j);
      if (id < 0) break;  // lists are packed from slot 0
      const float t = sphere_t(p, r, id);
      if (t < t_best) {  // strict: the earlier cell, then the lower slot, wins ties
        t_best = t;
        id_best = id;
      }
    }
    const float t_next = fminf(tmaxx, tmaxz);
    const bool go_x = tmaxx <= tmaxz;
    const int ix2 = ix + (go_x ? step_x : 0);
    const int iz2 = iz + (go_x ? 0 : step_z);
    if (go_x) tmaxx += tdx; else tmaxz += tdz;
    const bool in_grid = ix2 >= 0 && ix2 < p.cx && iz2 >= 0 && iz2 < p.cz;
    if (!(in_grid && t_next <= t_out && t_next < t_best)) break;
    ix = ix2;
    iz = iz2;
  }
}

template <bool kGrid>
__global__ void __launch_bounds__(128) sphere_megakernel(const Params p) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= p.width || y >= p.height) return;
  const uint32_t pix = static_cast<uint32_t>(y) * static_cast<uint32_t>(p.width) + x;

  float cam[19];
#pragma unroll
  for (int i = 0; i < 19; ++i) cam[i] = __ldg(p.cam + i);
  const float lens_radius = cam[18];

  float acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f;
  int rays = 0;
  for (int k = 0; k < p.spp; ++k) {
    const uint32_t s = static_cast<uint32_t>(k) + p.sample_offset;
    // camera sample: jitter + thin lens (common.camera_ray_planes)
    uint32_t r0 = pix, r1 = s, r2 = 0xA5A5A5A5u, r3 = p.seed;
    pcg4d(r0, r1, r2, r3);
    const float st_x = (static_cast<float>(x) + unit_float(r0)) / static_cast<float>(p.width);
    const float st_y = 1.0f - (static_cast<float>(y) + unit_float(r1)) / static_cast<float>(p.height);
    float offx = 0.0f, offy = 0.0f, offz = 0.0f;
    if (p.lens) {
      const float lr = sqrtf(unit_float(r2));
      const float phi = kTwoPi * unit_float(r3);
      const float rd0 = lens_radius * (lr * cosf(phi));
      const float rd1 = lens_radius * (lr * sinf(phi));
      offx = rd0 * cam[12] + rd1 * cam[15];
      offy = rd0 * cam[13] + rd1 * cam[16];
      offz = rd0 * cam[14] + rd1 * cam[17];
    }
    float ox = cam[0] + offx, oy = cam[1] + offy, oz = cam[2] + offz;
    float dx = cam[3] + st_x * cam[6] + st_y * cam[9] - cam[0] - offx;
    float dy = cam[4] + st_x * cam[7] + st_y * cam[10] - cam[1] - offy;
    float dz = cam[5] + st_x * cam[8] + st_y * cam[11] - cam[2] - offz;

    float tr = 1.0f, tg = 1.0f, tb = 1.0f;
    float sr = 0.0f, sg = 0.0f, sb = 0.0f;
    for (int bounce = 0; bounce < p.max_bounces; ++bounce) {
      ++rays;
      Ray ray;
      ray.ox = ox; ray.oy = oy; ray.oz = oz; ray.dx = dx; ray.dy = dy; ray.dz = dz;
      ray.od = ox * dx + oy * dy + oz * dz;
      ray.oo = ox * ox + oy * oy + oz * oz;
      ray.a = dx * dx + dy * dy + dz * dz;
      ray.inv_a = 1.0f / ray.a;

      // nearest hit: brute pass (all spheres, or the globals), then the walk
      float t_best = kBig;
      int id_best = 0;
      for (int i = 0; i < p.n_brute; ++i) {
        const float t = sphere_t(p, ray, i);
        if (t < t_best) {
          t_best = t;
          id_best = i;
        }
      }
      if (kGrid) grid_walk(p, ray, t_best, id_best);

      const float inv_len = 1.0f / sqrtf(fmaxf(ray.a, 1e-20f));
      const float udx = dx * inv_len, udy = dy * inv_len, udz = dz * inv_len;
      if (!(t_best < kBigCut)) {  // miss: sky, path ends
        if (p.sky != 2) {
          const float t = p.sky == 0 ? 0.5f * (udy + 1.0f) : udy;
          sr += tr * ((1.0f - t) + t * 0.5f);
          sg += tg * ((1.0f - t) + t * 0.7f);
          sb += tb * ((1.0f - t) + t * 1.0f);
        }
        break;
      }

      const float4 g0 = __ldg(p.sph + 3 * id_best);
      const float4 g1 = __ldg(p.sph + 3 * id_best + 1);
      const float4 g2 = __ldg(p.sph + 3 * id_best + 2);
      const float rad = g1.y;  // signed: a negative radius flips the normal
      const int kind = static_cast<int>(g1.z);
      const float param = g1.w;
      const float ar = g2.x, ag = g2.y, ab = g2.z;

      const float hx = ox + t_best * dx, hy = oy + t_best * dy, hz = oz + t_best * dz;
      const float onx = (hx - g0.x) / rad, ony = (hy - g0.y) / rad, onz = (hz - g0.z) / rad;
      const bool front = dx * onx + dy * ony + dz * onz < 0.0f;
      const float sgn = front ? 1.0f : -1.0f;
      const float nx = onx * sgn, ny = ony * sgn, nz = onz * sgn;

      // material scatter (common.scatter_planes / materials.scatter)
      uint32_t q0 = pix, q1 = s, q2 = static_cast<uint32_t>(bounce), q3 = p.seed;
      pcg4d(q0, q1, q2, q3);
      const float u0 = unit_float(q0), u1 = unit_float(q1), u2 = unit_float(q2);

      if (kind == 0 || kind == 4) {  // normal-map debug shading / emissive
        if (kind == 0) {
          sr += tr * (0.5f * (nx + 1.0f));
          sg += tg * (0.5f * (ny + 1.0f));
          sb += tb * (0.5f * (nz + 1.0f));
        } else {
          sr += tr * ar;
          sg += tg * ag;
          sb += tb * ab;
        }
        break;
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
        if (ndx * nx + ndy * ny + ndz * nz <= 0.0f) break;
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
      if (kind != 3) { tr *= ar; tg *= ag; tb *= ab; }
      ox = hx; oy = hy; oz = hz;
      dx = ndx; dy = ndy; dz = ndz;
    }
    acc_r += sr;
    acc_g += sg;
    acc_b += sb;
  }
  const float spp = static_cast<float>(p.spp);
  float* out = p.out_rgb + 3 * static_cast<size_t>(pix);
  out[0] = acc_r / spp;
  out[1] = acc_g / spp;
  out[2] = acc_b / spp;
  p.out_rays[pix] = rays;
}

}  // namespace

extern "C" int csgr_sphere_render(
    const void* cam, const void* spheres, int n_brute, const void* cell_ids,
    int cx, int cz, int m, int max_steps, float x0, float z0, float x1, float z1,
    float y_lo, float y_hi, float cell, float inv_cell, int width, int height,
    int spp, int max_bounces, unsigned int seed, unsigned int sample_offset,
    int lens, int sky, void* out_rgb, void* out_rays, void* stream) {
  Params p;
  p.cam = static_cast<const float*>(cam);
  p.sph = static_cast<const float4*>(spheres);
  p.n_brute = n_brute;
  p.cell_ids = static_cast<const int*>(cell_ids);
  p.cx = cx; p.cz = cz; p.m = m; p.max_steps = max_steps;
  p.x0 = x0; p.z0 = z0; p.x1 = x1; p.z1 = z1;
  p.y_lo = y_lo; p.y_hi = y_hi; p.cell = cell; p.inv_cell = inv_cell;
  p.width = width; p.height = height; p.spp = spp; p.max_bounces = max_bounces;
  p.seed = seed; p.sample_offset = sample_offset;
  p.lens = lens; p.sky = sky;
  p.out_rgb = static_cast<float*>(out_rgb);
  p.out_rays = static_cast<int*>(out_rays);

  const dim3 block(16, 8);
  const dim3 grid((width + block.x - 1) / block.x, (height + block.y - 1) / block.y);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (p.cell_ids != nullptr) {
    sphere_megakernel<true><<<grid, block, 0, st>>>(p);
  } else {
    sphere_megakernel<false><<<grid, block, 0, st>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* csgr_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
