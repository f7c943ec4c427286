// Triangle-mesh path-tracing kernel for Hopper (sm_90a): brute and grid
// modes, each with and without next-event estimation (NEE) toward the
// mesh's emissive faces.
//
// Replaces csgrenderer_tpu/kernels/trimesh_kernel.py::_make_kernel (the
// Pallas TPU kernel launched by _render_mesh_packed) in all its modes:
//   - brute mode: Möller-Trumbore (MT) of every face against every ray
//     (intersect_tile), the winner the first face of least t;
//   - grid mode: the big faces (the JAX "globals") brute-forced, then a
//     per-ray 3D voxel DDA (tri_worklist.tri_grid_setup / _dda_advance3 /
//     tri_grid_step) over CSR face lists; it also serves the meshes the
//     TPU needed its stream and HBM modes for, because the lists sit in
//     device memory at any size;
//   - the NEE variant: at every Lambertian or glossy hit one lamp face of
//     the [n_lamps, 16] table is area-sampled (common.nee_sample_tri_planes)
//     and a shadow ray decides its MIS-weighted contribution; lamp emission
//     found by such a vertex's scatter carries the partner weight.
// It computes what the TPU kernel computes (RTIOW materials, PCG4D counters
// keyed by (pixel, sample, bounce, seed), per-pixel radiance over spp,
// traced-segment counts; shadow rays are not counted), not its block
// structure: one thread per pixel, looping over samples and bounces. The
// TPU's one-hot MXU gathers, bf16 hi/lo tables with cell-relative v0,
// occupancy tiers, paged dense map and chunk chains are not here: a thread
// loads a face record by its id.
//
// Shadow rays are any-hit tests with the plain version's identity-free
// rule: the lamp is occluded iff some face is hit below tl * (1 - 1e-4).
// Brute mode tests every face; grid mode the globals, then the walk with
// its best t starting at that bound, so its exit clamps there. The search
// stops at the first such hit.
//
// What bounds it on an H100: divergent FP32 ALU work (an MT test is 52
// operations, and threads of a warp take different walks, materials
// and bounce counts) and the dependent global loads of each DDA step (the
// voxel's offsets, then each listed face's 48 bytes). This first version
// does nothing yet about either: no ray compaction, no shared-memory
// staging, no wider-than-a-thread traversal.
//
// Numerics: the kernel repeats, operation for operation and in the same
// order, the float arithmetic of its plain torch version
// (render/trimesh.mt_t, tri_worklist._walk, render/lights.py), and is
// built with -fmad=false and without --use_fast_math, so sqrt and division
// are IEEE-rounded and no multiply-add is contracted. Unit normals are
// read from the face table (made once by the packer with the plain
// version's operation), never re-derived. A zero or NaN determinant is
// rejected explicitly, so a degenerate face can never become a hit.

#include <cuda_runtime.h>
#include <stdint.h>

#include "path_common.cuh"

namespace {

constexpr float kMiss = 1e30f;     // t of a face that is not hit
constexpr float kHitCut = 5e29f;   // a nearest t below this is a hit
constexpr float kBig = 1e30f;      // the walk's infinity
constexpr float kEpsFlat = 1e-12f;
constexpr float kTMin = 1e-3f;     // hit epsilon along t
constexpr int kFaceF4 = 5;         // float4 per face record

struct Params {
  const float* cam;       // [24]: origin, lower_left, horizontal, vertical, u, v, lens_radius
  const float4* faces;    // [F, 5] float4: (v0, e1x) (e1yz, e2xy) (e2z, n)
                          // (kind, param, ar, ag) (ab, 0, 0, 0)
  int n_faces;
  const int* glob_ids;    // [G] globals (grid mode)
  int n_glob;
  const int* offsets;     // [V + 1] CSR offsets, voxel (ix * ny + iy) * nz + iz; null: brute mode
  const int* face_ids;    // [P] face ids, ascending within a voxel
  int nx, ny, nz;
  float lo[3], hi[3], cell, inv_cell;
  const float4* lamps;    // [n_lamps, 4] float4: (v0, e1x) (e1yz, e2xy) (e2z, emit) (n, area)
  int n_lamps;
  int width, height, spp, max_bounces;
  uint32_t seed, sample_offset;
  int lens, sky;          // sky: 0 rtiow, 1 wololo, 2 black
  float* out_rgb;         // [H, W, 3]
  int* out_rays;          // [H, W]
};

struct Ray {
  float o[3], d[3];
};

// MT t of face id, kMiss where not hit (render/trimesh.mt_t).
__device__ __forceinline__ float tri_t(const Params& p, const Ray& r, int id) {
  const float4 a = __ldg(p.faces + kFaceF4 * id);
  const float4 b = __ldg(p.faces + kFaceF4 * id + 1);
  const float4 c = __ldg(p.faces + kFaceF4 * id + 2);
  const float e1x = a.w, e1y = b.x, e1z = b.y, e2x = b.z, e2y = b.w, e2z = c.x;
  const float dx = r.d[0], dy = r.d[1], dz = r.d[2];
  const float pvx = dy * e2z - dz * e2y;
  const float pvy = dz * e2x - dx * e2z;
  const float pvz = dx * e2y - dy * e2x;
  const float det = e1x * pvx + e1y * pvy + e1z * pvz;
  if (!(det != 0.0f)) return kMiss;  // degenerate (or NaN): the plain version's NaN rejects it
  const float inv_det = 1.0f / det;
  const float tvx = r.o[0] - a.x, tvy = r.o[1] - a.y, tvz = r.o[2] - a.z;
  const float u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det;
  const float qx = tvy * e1z - tvz * e1y;
  const float qy = tvz * e1x - tvx * e1z;
  const float qz = tvx * e1y - tvy * e1x;
  const float v = (dx * qx + dy * qy + dz * qz) * inv_det;
  const float t = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
  return (u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t > kTMin) ? t : kMiss;
}

// 3D DDA over the voxel lists (tri_worklist._walk), refining (t_best,
// id_best) found by the globals. kAny: stop at the first t below t_best
// (a shadow ray whose t_best starts at its bound) and return true then.
template <bool kAny>
__device__ bool grid_walk(const Params& p, const Ray& r, float& t_best, int& id_best) {
  const int dims[3] = {p.nx, p.ny, p.nz};
  float t_in = kTMin, t_out = kBig;
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    const float o = r.o[ax], d = r.d[ax];
    float lo_t, hi_t;
    if (fabsf(d) < kEpsFlat) {
      const bool inside = o >= p.lo[ax] && o <= p.hi[ax];
      lo_t = inside ? -kBig : kBig;
      hi_t = inside ? kBig : -kBig;
    } else {
      const float inv = 1.0f / d;
      const float t0 = (p.lo[ax] - o) * inv;
      const float t1 = (p.hi[ax] - o) * inv;
      lo_t = fminf(t0, t1);
      hi_t = fmaxf(t0, t1);
    }
    t_in = fmaxf(t_in, lo_t);
    t_out = fminf(t_out, hi_t);
  }
  t_out = fminf(t_out, t_best);
  if (!(t_in <= t_out)) return false;

  int idx[3], step[3];
  float tmax[3], td[3];
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    const float o = r.o[ax], d = r.d[ax];
    const float pc = o + t_in * d;
    idx[ax] = static_cast<int>(fminf(fmaxf(floorf((pc - p.lo[ax]) * p.inv_cell), 0.0f),
                                     static_cast<float>(dims[ax] - 1)));
    step[ax] = (d > 0.0f) - (d < 0.0f);
    const bool flat = fabsf(d) < kEpsFlat;
    const float next_b = p.lo[ax] + static_cast<float>(idx[ax] + (step[ax] > 0 ? 1 : 0)) * p.cell;
    tmax[ax] = flat ? kBig : (next_b - o) / d;
    td[ax] = flat ? kBig : fabsf(p.cell / d);
  }

  const int max_steps = p.nx + p.ny + p.nz;
  for (int s = 0; s < max_steps; ++s) {
    const int vox = (idx[0] * p.ny + idx[1]) * p.nz + idx[2];
    const int k1 = __ldg(p.offsets + vox + 1);
    for (int k = __ldg(p.offsets + vox); k < k1; ++k) {
      const int id = __ldg(p.face_ids + k);
      const float t = tri_t(p, r, id);
      if (t < t_best) {  // strict: the earlier voxel, then the lower list slot, wins ties
        if (kAny) return true;
        t_best = t;
        id_best = id;
      }
    }
    const float t_next = fminf(fminf(tmax[0], tmax[1]), tmax[2]);
    const bool go_x = tmax[0] <= tmax[1] && tmax[0] <= tmax[2];
    const bool go_y = !go_x && tmax[1] <= tmax[2];
    const int ax = go_x ? 0 : (go_y ? 1 : 2);
    idx[ax] += step[ax];
    tmax[ax] += td[ax];
    const bool in_grid = idx[0] >= 0 && idx[0] < p.nx && idx[1] >= 0 && idx[1] < p.ny &&
                         idx[2] >= 0 && idx[2] < p.nz;
    if (!(in_grid && t_next <= t_out && t_next < t_best)) break;
  }
  return false;
}

// The nearest hit: every face (brute), or the globals then the walk (grid).
template <bool kGrid>
__device__ __forceinline__ void nearest(const Params& p, const Ray& r, float& t_best,
                                        int& id_best) {
  t_best = kMiss;
  id_best = 0;
  const int n = kGrid ? p.n_glob : p.n_faces;
  for (int i = 0; i < n; ++i) {
    const int id = kGrid ? __ldg(p.glob_ids + i) : i;
    const float t = tri_t(p, r, id);
    if (t < t_best) {  // strict: the lowest face id wins ties (argmin)
      t_best = t;
      id_best = id;
    }
  }
  if (kGrid) grid_walk<false>(p, r, t_best, id_best);
}

// A shadow ray: true iff some face is hit below t_max.
template <bool kGrid>
__device__ __forceinline__ bool occluded(const Params& p, const Ray& r, float t_max) {
  const int n = kGrid ? p.n_glob : p.n_faces;
  for (int i = 0; i < n; ++i) {
    if (tri_t(p, r, kGrid ? __ldg(p.glob_ids + i) : i) < t_max) return true;
  }
  if (!kGrid) return false;
  float t_best = t_max;
  int id_best = 0;
  return grid_walk<true>(p, r, t_best, id_best);
}

template <bool kGrid, bool kNee>
__global__ void __launch_bounds__(128) trimesh_kernel(const Params p) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= p.width || y >= p.height) return;
  const uint32_t pix = static_cast<uint32_t>(y) * static_cast<uint32_t>(p.width) + x;

  float cam[csgr::kCamFloats];
#pragma unroll
  for (int i = 0; i < csgr::kCamFloats; ++i) cam[i] = __ldg(p.cam + i);

  csgr::Path path;
  float acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f;
  int rays = 0;
  for (int k = 0; k < p.spp; ++k) {
    const uint32_t s = static_cast<uint32_t>(k) + p.sample_offset;
    csgr::camera_ray(cam, x, y, pix, s, p.seed, p.width, p.height, p.lens, path);
    path.sr = 0.0f; path.sg = 0.0f; path.sb = 0.0f;
    float prev_pdf = 0.0f;  // NEE: pdf of the scatter that made this ray, 0 on camera rays
    for (int bounce = 0; bounce < p.max_bounces; ++bounce) {
      ++rays;
      const float ox = path.ox, oy = path.oy, oz = path.oz;
      const float dx = path.dx, dy = path.dy, dz = path.dz;
      const Ray ray = {{ox, oy, oz}, {dx, dy, dz}};
      float t_best;
      int id_best;
      nearest<kGrid>(p, ray, t_best, id_best);

      const float inv_len = csgr::inv_length(path);
      const float udx = dx * inv_len, udy = dy * inv_len, udz = dz * inv_len;
      if (!(t_best < kHitCut)) {  // miss: sky, path ends
        csgr::add_sky(path, p.sky, udy);
        break;
      }

      const float4* f = p.faces + kFaceF4 * id_best;
      const float4 g2 = __ldg(f + 2), g3 = __ldg(f + 3), g4 = __ldg(f + 4);
      const float hx = ox + t_best * dx, hy = oy + t_best * dy, hz = oz + t_best * dz;
      // the geometric normal turned against the ray; front face from it
      const bool front = dx * g2.y + dy * g2.z + dz * g2.w < 0.0f;
      const float sgn = front ? 1.0f : -1.0f;
      const float nx = g2.y * sgn, ny = g2.z * sgn, nz = g2.w * sgn;
      const int kind = static_cast<int>(g3.x);
      const float param = g3.y, ar = g3.z, ag = g3.w, ab = g4.x;
      if (!kNee) {
        if (!csgr::shade(path, hx, hy, hz, nx, ny, nz, front, kind, param, ar, ag, ab, udx, udy,
                         udz, pix, s, static_cast<uint32_t>(bounce), p.seed)) {
          break;
        }
        continue;
      }

      // a lamp face reached by a pairable scatter: the partner weight
      const float emit_scale = kind == 4 && prev_pdf > 0.0f
          ? csgr::partner_weight_tri(p.lamps, p.n_lamps, hx, hy, hz, ox, oy, oz, prev_pdf)
          : 1.0f;
      const bool lambertian = kind == 1;
      const bool glossy = kind == 2 && param > csgr::kGlossyFuzz;
      if (lambertian || glossy) {
        float u1, u2;
        const int li = csgr::nee_pick(pix, s, static_cast<uint32_t>(bounce), p.seed, p.n_lamps,
                                      u1, u2);
        csgr::LampSample ls;
        if (csgr::nee_sample_tri(hx, hy, hz, nx, ny, nz, lambertian, param, udx, udy, udz, ar, ag,
                                 ab, p.lamps + 4 * li, p.n_lamps, u1, u2, ls)) {
          const Ray shadow = {{hx, hy, hz}, {ls.dx, ls.dy, ls.dz}};
          if (!occluded<kGrid>(p, shadow, ls.tl * csgr::kShadowScale)) {
            path.sr += path.tr * ls.wr;
            path.sg += path.tg * ls.wg;
            path.sb += path.tb * ls.wb;
          }
        }
      }
      if (!csgr::shade<true>(path, hx, hy, hz, nx, ny, nz, front, kind, param, ar, ag, ab, udx,
                             udy, udz, pix, s, static_cast<uint32_t>(bounce), p.seed,
                             emit_scale)) {
        break;
      }
      prev_pdf = csgr::carried_pdf(path, lambertian, glossy, nx, ny, nz, param, udx, udy, udz);
    }
    acc_r += path.sr;
    acc_g += path.sg;
    acc_b += path.sb;
  }
  const float spp = static_cast<float>(p.spp);
  float* out = p.out_rgb + 3 * static_cast<size_t>(pix);
  out[0] = acc_r / spp;
  out[1] = acc_g / spp;
  out[2] = acc_b / spp;
  p.out_rays[pix] = rays;
}

}  // namespace

extern "C" int csgr_mesh_render(
    const void* cam, const void* faces, int n_faces, const void* glob_ids, int n_glob,
    const void* offsets, const void* face_ids, int nx, int ny, int nz, float x0, float y0,
    float z0, float x1, float y1, float z1, float cell, float inv_cell, const void* lamps,
    int n_lamps, int width, int height, int spp, int max_bounces, unsigned int seed,
    unsigned int sample_offset, int lens, int sky, void* out_rgb, void* out_rays,
    void* stream) {
  Params p;
  p.cam = static_cast<const float*>(cam);
  p.faces = static_cast<const float4*>(faces);
  p.n_faces = n_faces;
  p.glob_ids = static_cast<const int*>(glob_ids);
  p.n_glob = n_glob;
  p.offsets = static_cast<const int*>(offsets);
  p.face_ids = static_cast<const int*>(face_ids);
  p.nx = nx; p.ny = ny; p.nz = nz;
  p.lo[0] = x0; p.lo[1] = y0; p.lo[2] = z0;
  p.hi[0] = x1; p.hi[1] = y1; p.hi[2] = z1;
  p.cell = cell; p.inv_cell = inv_cell;
  p.lamps = static_cast<const float4*>(lamps);
  p.n_lamps = n_lamps;
  p.width = width; p.height = height; p.spp = spp; p.max_bounces = max_bounces;
  p.seed = seed; p.sample_offset = sample_offset;
  p.lens = lens; p.sky = sky;
  p.out_rgb = static_cast<float*>(out_rgb);
  p.out_rays = static_cast<int*>(out_rays);

  const dim3 block(16, 8);
  const dim3 grid((width + block.x - 1) / block.x, (height + block.y - 1) / block.y);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool nee = n_lamps > 0;
  if (p.offsets != nullptr) {
    if (nee) {
      trimesh_kernel<true, true><<<grid, block, 0, st>>>(p);
    } else {
      trimesh_kernel<true, false><<<grid, block, 0, st>>>(p);
    }
  } else if (nee) {
    trimesh_kernel<false, true><<<grid, block, 0, st>>>(p);
  } else {
    trimesh_kernel<false, false><<<grid, block, 0, st>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* csgr_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
