// Sphere path-tracing megakernel for Hopper (sm_90a), grid and brute modes,
// each with and without next-event estimation (NEE).
//
// Replaces csgrenderer_tpu/kernels/megakernel.py::_make_kernel (the Pallas
// TPU kernel launched by _render_packed) in its sphere modes:
//   - grid mode: the globals (ground, heroes, spilled spheres) are brute
//     forced, then a per-ray 2D xz-grid DDA walks m-slot cell lists
//     (worklist.grid_setup / grid_step);
//   - brute mode: every sphere is tested against every ray (intersect_tile);
//   - the NEE variant (n_lights > 0: the brute pass's occlusion_t and the
//     grid path's nee_sample / nee_mis_scale hooks): at every Lambertian or
//     glossy hit one lamp of the [n_lights, 8] table is cone-sampled and a
//     shadow ray decides its MIS-weighted contribution; lamp emission found
//     by such a vertex's scatter carries the partner weight.
// It computes what the TPU kernel computes (RTIOW materials, PCG4D counters
// keyed by (pixel, sample, bounce, seed), per-pixel radiance over spp,
// traced-segment counts), not its block structure: one thread per pixel,
// looping over samples and bounces; with NEE a sample is one query loop
// whose every turn traces one ray, a path segment or a shadow ray (the
// Pallas grid path's shadow segments woven into the wavefront were a TPU
// occupancy device).
//
// Shadow rays: built as a Ray and tested with the same sphere_t as the path
// rays (not the Pallas unit-direction occlusion shortcut), through the same
// brute pass and grid walk: against every sphere in brute mode, against
// the globals and then the grid walk, whose t_best starts at the lamp
// distance so its exit clamps there, in grid mode. The visibility rule is
// the plain version's identity-free one: the lamp is occluded iff some hit
// lies below tl * (1 - 1e-4); in grid mode the search stops at the first
// such hit among the globals and skips the walk, which gives the same
// answer (in brute mode the pass runs to its end: a loop with one exit
// measured about 20% faster there than one stopping at the first hit).
// The Pallas grid path also excluded the lamp's own hit by sphere id, to
// absorb the drift of its bf16 tables; these tables are exact f32, so the
// id is not read (the lamp table keeps it, column 7, for the packer's
// layout). The NEE
// instantiations count the shadow rays they trace, by the plain version's
// rule (a lamp sample that nee_sample keeps, occluded or not: lights.
// nee_contribution's ``traced``): each warp adds the lanes that keep one
// to a CTA counter in shared memory where they keep it (a counter held in
// a register through the bounce loop cost the NEE instantiations 8-16
// bytes more of spills), and the CTA adds its count once, at its end, to a
// 64-bit word (out_shadow) that the launcher zeroes. Shadow rays stay out
// of the per-pixel segment counts (out_rays), as the plain version keeps
// them out of ``rays``.
//
// What bounds it on an H100: divergent FP32 ALU work (threads of a warp
// take different materials, bounce counts and DDA walk lengths; with NEE,
// some hold a shadow ray and others a segment) and the dependent loads of
// each DDA step (cell list, then each listed sphere). What the design does:
//   - the tables a sphere test reads (the [S, 8] geometry table and the
//     cell lists: 19,456 bytes for RTIOW) are staged once per CTA in shared
//     memory by two bulk (TMA 1D) copies on an mbarrier; a cell's eight
//     slots are two int4 loads. Tables over the device's opt-in limit run
//     the same code reading them from global memory (kShared = false): the
//     launcher chooses by size;
//   - persistent CTAs (the occupancy the register budget allows: eight per
//     SM at 64 registers, up to 1,056 on an H100) take 16x2-pixel work
//     units from a per-launch counter, so the tables are staged 1,056 times
//     a frame, not 8,100, and the tail of a frame (sky rows against lattice
//     rows) is balanced. 64 registers a thread measured best for the main
//     path among budgets of 48-80 (and none); the grid-NEE query loop runs
//     best at 72 (seven CTAs per SM: 3-4% faster than 64 or 80), brute NEE
//     at 64;
//   - with NEE, one query loop a sample (trace_nee_sample): a vertex keeps
//     its lamp sample as its lane's pending shadow query, and the next turn
//     traces that query, or the path's next segment where none is pending,
//     through the one brute pass and the one walk, so a warp's lanes walk
//     together whatever query each holds (56-80% of a warp's lanes active
//     in a walk on the night488 frames). A shadow ray traced inside the
//     segment that made it walks as a phase of its own with the other
//     lanes masked off (48-62% active) and takes a second walk site, which
//     wants the rolled slot loop: 17.9-18.1 ms for night488 at 960x540 and
//     64 spp on an H100, against 14.0-14.2 ms for the query loop;
//   - paths stay one sample at a time per thread: regenerating a lane's
//     next sample as soon as its path ends (Aila and Laine's persistent
//     loop) was measured slower here; it mixes camera rays, whose walks are
//     long and coherent, with bounce rays in one warp.
//
// Stats mode (kStats, grid mode from staged tables: the rtiow and night
// cells' instantiations): the same image and counts, and per launch a block
// of work counts (persistent.cuh): the segment loop's warp turns, the grid
// walk's cell-loop turns by warp and by lane, and with NEE the shadow
// queries' part of the lane turns. The launcher runs it where out_stats is
// not null; the other launches compile as if it were not there.
//
// The G-buffer mode (sphere_gbuffer, csgr_sphere_gbuffer) replaces no
// Pallas kernel: it is the port's kernel for the JAX package's jnp AOV cast
// (csgrenderer_tpu/render/aov.py::render_aovs, which XLA fuses). One
// centred primary ray a pixel, no RNG and no lens, through the render
// modes' brute pass and grid walk over the same staged tables; it writes
// depth, the face-forwarded normal, the albedo (the sky colour on a miss)
// and the hit byte: 29 bytes a pixel, so it is bound by the walk's
// operations, as the render modes are.
//
// Numerics: the kernel repeats, operation for operation and in the same
// order, the float arithmetic of its plain torch version (the reference's
// expanded quadratic, materials, camera), and is built with -fmad=false and
// without --use_fast_math, so no multiply-add is contracted and sqrt and
// division are IEEE-rounded: kernel and plain version take the same
// silhouette decisions. A non-positive discriminant is tested explicitly,
// so a miss or an empty slot can never become a hit. The camera sample,
// RNG, sky and material scatter live in path_common.cuh, shared with the
// CSG kernel (tape_kernel.cu).

#include <cuda_runtime.h>
#include <stdint.h>

#include "path_common.cuh"
#include "persistent.cuh"

// The CTA's dynamic shared memory (smem_tables, persistent.cuh) holds the
// [S, 8] f32 geometry table, then the [cx*cz, 8] int32 cell lists (kShared
// instantiations only).

namespace {

constexpr float kBig = 1e30f;
constexpr float kBigCut = 5e29f;
constexpr float kEpsFlat = 1e-12f;
constexpr float kTMin = 1e-3f;  // hit epsilon along t
constexpr float kTFar = 1e9f;   // farthest valid hit

constexpr int kSlots = 8;  // cell list slots (worklist.M_SLOTS): two int4 per cell
constexpr int kThreads = 128;             // a CTA: four warps
// CTAs per SM the register budget allows (measured, PERF.md): 64 registers
// a thread, but 72 for the grid-NEE query loop
constexpr int kMinCtas = 8, kGridNeeMinCtas = 7;

template <bool kGrid, bool kNee>
constexpr int kCtasPerSm = kGrid && kNee ? kGridNeeMinCtas : kMinCtas;

struct Params {
  const float* cam;      // [24]: origin, lower_left, horizontal, vertical, u, v, lens_radius
  const float4* sph;     // [S, 3] float4: (cx,cy,cz,r2) (c.c,r,kind,param) (ar,ag,ab,0)
  const float4* geo;     // [S, 2] float4: the first two of sph's, what a sphere test reads
  int n_brute;           // spheres brute-forced per segment (the globals in grid mode)
  const int* cell_ids;   // [cx*cz, kSlots] reordered sphere ids, -1 = empty (grid mode)
  int geo_bytes, cell_bytes;  // the two tables' sizes, as staged in shared memory
  int cx, cz, max_steps;
  float x0, z0, x1, z1, y_lo, y_hi, cell, inv_cell;
  const float4* lamps;   // [n_lamps, 2] float4: (cx,cy,cz,|r|) (er,eg,eb,sphere id) (NEE)
  int n_lamps;
  int width, height, spp, max_bounces;
  int rows, row_offset;  // the slab rendered: rows [row_offset, row_offset + rows)
  uint32_t seed, sample_offset;
  // one device word read in place of sample_offset when not null: a
  // launch captured in a CUDA graph takes each replay's offset from it
  const uint32_t* sample_offset_at;
  int lens, sky;         // sky: 0 rtiow, 1 wololo, 2 black
  float* out_rgb;        // [rows, W, 3]
  int* out_rays;         // [rows, W]
  int* work;             // the work-unit counter, zeroed before each launch
  unsigned long long* out_shadow;  // NEE: the launch's shadow rays, zeroed before it
};

struct Ray {
  float ox, oy, oz, dx, dy, dz;
  float od, oo, a, inv_a;  // o.d, o.o, d.d, 1/d.d
};

// The per-ray terms as intersect.ray_terms forms them.
__device__ __forceinline__ Ray make_ray(float ox, float oy, float oz, float dx, float dy,
                                        float dz) {
  Ray ray;
  ray.ox = ox; ray.oy = oy; ray.oz = oz; ray.dx = dx; ray.dy = dy; ray.dz = dz;
  ray.od = ox * dx + oy * dy + oz * dz;
  ray.oo = ox * ox + oy * oy + oz * oz;
  ray.a = dx * dx + dy * dy + dz * dz;
  ray.inv_a = 1.0f / ray.a;
  return ray;
}

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

// The tables, read from shared memory (kShared: the geometry table, then
// the cell lists, staged once per CTA by stage_tables) or from global
// memory (tables too large for a CTA's shared memory).
template <bool kShared>
__device__ __forceinline__ float4 geo_load(const Params& p, int i) {  // float4 i of geo
  if constexpr (kShared) return reinterpret_cast<const float4*>(smem_tables)[i];
  else return __ldg(p.geo + i);
}

template <bool kShared>
__device__ __forceinline__ float geo_cc(const Params& p, int id) {  // c.c of sphere id
  if constexpr (kShared) return reinterpret_cast<const float*>(smem_tables)[8 * id + 4];
  else return __ldg(reinterpret_cast<const float*>(p.geo) + 8 * id + 4);
}

template <bool kShared>
__device__ __forceinline__ int4 cell_quad(const Params& p, int q) {  // int4 q of cell_ids
  if constexpr (kShared) {
    return reinterpret_cast<const int4*>(smem_tables + p.geo_bytes)[q];
  } else {
    return __ldg(reinterpret_cast<const int4*>(p.cell_ids) + q);
  }
}

template <bool kShared>
__device__ __forceinline__ float sphere_t(const Params& p, const Ray& r, int id) {
  return sphere_t(r, geo_load<kShared>(p, 2 * id), geo_cc<kShared>(p, id));
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

// One slot of a cell list: sphere id's test refines (t_best, id_best).
// Strict: the earlier cell, then the lower slot, wins ties.
template <bool kShared>
__device__ __forceinline__ void slot_test(const Params& p, const Ray& r, int id, float& t_best,
                                          int& id_best) {
  const float t = sphere_t<kShared>(p, r, id);
  if (t < t_best) {
    t_best = t;
    id_best = id;
  }
}

// 2D xz-grid DDA over the cell lists (worklist.grid_setup + grid_step),
// refining (t_best, id_best) found by the globals. A cell's list is read
// as two int4, both loaded before the first test, and its eight slot
// tests are unrolled: 13% faster than a rolled loop on the grid frame,
// and 15-24% in the NEE query loop. Every kernel calls the walk from one
// site (the NEE instantiations from their query loop, for path and shadow
// rays alike). A stats instantiation passes its lane's Stats, in which
// each step's turn is counted (csgr::walk_turn); the others pass none.
template <bool kShared, class... Stats>
__device__ void grid_walk(const Params& p, const Ray& r, float& t_best, int& id_best,
                          Stats&... st) {
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
    if constexpr (sizeof...(Stats) > 0) csgr::walk_turn(st...);
    const int q = (ix * p.cz + iz) * (kSlots / 4);  // the cell's list: two int4, both loaded
    const int4 a = cell_quad<kShared>(p, q), b = cell_quad<kShared>(p, q + 1);
    const int ids[kSlots] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      if (ids[j] < 0) break;  // lists are packed from slot 0
      slot_test<kShared>(p, r, ids[j], t_best, id_best);
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

// The shadow rays the CTA has traced, in its shared memory (only the NEE
// instantiations, which call this, hold the word).
__device__ __forceinline__ unsigned int& cta_shadow_rays() {
  __shared__ unsigned int count;
  return count;
}

// Counts one shadow ray for each lane of the warp that calls this together:
// the lowest of them adds their number to the CTA's counter.
__device__ __forceinline__ void count_shadow_ray() {
  const unsigned lanes = __activemask();
  if (static_cast<int>(threadIdx.x & 31) == __ffs(lanes) - 1) {
    atomicAdd(&cta_shadow_rays(), static_cast<unsigned int>(__popc(lanes)));
  }
}

// The shadow query a NEE vertex leaves for its lane's next turn of the
// query loop: a ray from the path's origin (the vertex) along d, and the
// contribution c = throughput * w that it adds when no hit lies below
// t_max. t_max is kBig when no query is pending.
struct ShadowQuery {
  float dx, dy, dz, t_max, cr, cg, cb;
};

// The path vertex at the nearest hit (t_best, id_best) of the path's ray,
// at ``bounce``: the sky (a miss), or the hit's emission and scatter.
// Returns false when the path ends here. With NEE, lamp emission carries
// its partner weight, and a Lambertian or glossy hit keeps its lamp sample
// as the pending shadow query ``sq``, with the throughput before the
// scatter; where the path ends, its origin is the vertex all the same,
// where a pending shadow query starts. ``prev_pdf`` (NEE) is the pdf of
// the scatter that made the ray, 0 on camera rays; it is updated for the
// next segment.
template <bool kNee, bool kShared>
__device__ __forceinline__ bool shade_vertex(const Params& p, csgr::Path& path, float t_best,
                                             int id_best, uint32_t pix, uint32_t s, int bounce,
                                             float& prev_pdf, ShadowQuery& sq) {
  const float ox = path.ox, oy = path.oy, oz = path.oz;
  const float dx = path.dx, dy = path.dy, dz = path.dz;
  const float inv_len = csgr::inv_length(path);
  const float udx = dx * inv_len, udy = dy * inv_len, udz = dz * inv_len;
  if (!(t_best < kBigCut)) {  // miss: sky, path ends
    csgr::add_sky(path, p.sky, udy);
    return false;
  }

  const float4 g0 = geo_load<kShared>(p, 2 * id_best);
  const float4 g1 = geo_load<kShared>(p, 2 * id_best + 1);
  const float4 g2 = __ldg(p.sph + 3 * id_best + 2);  // albedo: once per hit, from global memory
  const float rad = g1.y;  // signed: a negative radius flips the normal

  const float hx = ox + t_best * dx, hy = oy + t_best * dy, hz = oz + t_best * dz;
  const float onx = (hx - g0.x) / rad, ony = (hy - g0.y) / rad, onz = (hz - g0.z) / rad;
  const bool front = dx * onx + dy * ony + dz * onz < 0.0f;
  const float sgn = front ? 1.0f : -1.0f;
  const int kind = static_cast<int>(g1.z);
  if (!kNee) {
    return csgr::shade(path, hx, hy, hz, onx * sgn, ony * sgn, onz * sgn, front, kind, g1.w,
                       g2.x, g2.y, g2.z, udx, udy, udz, pix, s, static_cast<uint32_t>(bounce),
                       p.seed);
  }

  const float nx = onx * sgn, ny = ony * sgn, nz = onz * sgn;
  // a lamp reached by a pairable scatter: its own centre and |r| give the
  // partner weight (common.bsdf_mis_scale_planes)
  const float emit_scale = kind == 4 && prev_pdf > 0.0f
      ? csgr::partner_weight(g0.x, g0.y, g0.z, fabsf(rad), ox, oy, oz, prev_pdf, p.n_lamps)
      : 1.0f;
  const bool lambertian = kind == 1;
  const bool glossy = kind == 2 && g1.w > csgr::kGlossyFuzz;
  if (lambertian || glossy) {
    float u1, u2;
    const int li = csgr::nee_pick(pix, s, static_cast<uint32_t>(bounce), p.seed, p.n_lamps,
                                  u1, u2);
    const float4 l0 = __ldg(p.lamps + 2 * li), l1 = __ldg(p.lamps + 2 * li + 1);
    csgr::LampSample ls;
    if (csgr::nee_sample(hx, hy, hz, nx, ny, nz, lambertian, g1.w, udx, udy, udz, g2.x, g2.y,
                         g2.z, l0.x, l0.y, l0.z, l0.w, l1.x, l1.y, l1.z, p.n_lamps, u1, u2,
                         ls)) {
      count_shadow_ray();
      sq.dx = ls.dx; sq.dy = ls.dy; sq.dz = ls.dz;
      sq.t_max = ls.tl * csgr::kShadowScale;
      sq.cr = path.tr * ls.wr;
      sq.cg = path.tg * ls.wg;
      sq.cb = path.tb * ls.wb;
    }
  }
  if (!csgr::shade<true>(path, hx, hy, hz, nx, ny, nz, front, kind, g1.w, g2.x, g2.y, g2.z,
                         udx, udy, udz, pix, s, static_cast<uint32_t>(bounce), p.seed,
                         emit_scale)) {
    path.ox = hx; path.oy = hy; path.oz = hz;  // a metal's absorbed scatter leaves it unset
    return false;
  }
  prev_pdf = csgr::carried_pdf(path, lambertian, glossy, nx, ny, nz, g1.w, udx, udy, udz);
  return true;
}

// One path segment of pixel ``pix``, sample ``s``, at ``bounce`` (the
// instantiations without NEE): the nearest hit, then its vertex. Returns
// false when the path ends here. ``st``: as grid_walk's.
template <bool kGrid, bool kShared, class... Stats>
__device__ __forceinline__ bool trace_segment(const Params& p, csgr::Path& path, uint32_t pix,
                                              uint32_t s, int bounce, Stats&... st) {
  const Ray ray = make_ray(path.ox, path.oy, path.oz, path.dx, path.dy, path.dz);

  // nearest hit: brute pass (all spheres, or the globals), then the walk
  float t_best = kBig;
  int id_best = 0;
  for (int i = 0; i < p.n_brute; ++i) {
    const float t = sphere_t<kShared>(p, ray, i);
    if (t < t_best) {
      t_best = t;
      id_best = i;
    }
  }
  if (kGrid) grid_walk<kShared>(p, ray, t_best, id_best, st...);
  float prev_pdf;  // NEE state, not read without NEE
  ShadowQuery sq;
  return shade_vertex<false, kShared>(p, path, t_best, id_best, pix, s, bounce, prev_pdf, sq);
}

// One NEE sample of pixel ``pix`` (sample ``s``): one query loop over the
// path's segments and its vertices' shadow rays. Each turn traces one ray
// through one brute pass and one grid walk: the lane's pending shadow
// query if it holds one, else its path's next segment, so a warp's lanes
// walk together whatever query each holds. A shadow query is resolved
// before the path's next segment; a Lambertian or glossy vertex's scatter
// adds no radiance, so its contribution lands where it would if it were
// traced at the vertex, and the sum keeps its order. Adds the segments
// traced to ``rays``. ``st``: as grid_walk's; a stats instantiation also
// counts the segment turns and the shadow queries' part of the walk turns.
template <bool kGrid, bool kShared, class... Stats>
__device__ __forceinline__ void trace_nee_sample(const Params& p, csgr::Path& path, uint32_t pix,
                                                 uint32_t s, int& rays, Stats&... st) {
  float prev_pdf = 0.0f;  // pdf of the scatter that made the path's ray, 0 on camera rays
  ShadowQuery sq;
  sq.t_max = kBig;
  int bounce = 0;
  bool live = p.max_bounces > 0;
  while (live || sq.t_max < kBigCut) {
    const bool shadow = sq.t_max < kBigCut;
    const Ray ray = make_ray(path.ox, path.oy, path.oz, shadow ? sq.dx : path.dx,
                             shadow ? sq.dy : path.dy, shadow ? sq.dz : path.dz);
    float t_best = sq.t_max;  // kBig for a segment
    int id_best = 0;
    for (int i = 0; i < p.n_brute; ++i) {
      const float t = sphere_t<kShared>(p, ray, i);
      if (t < t_best) {
        t_best = t;
        id_best = i;
        if (kGrid && shadow) break;  // occluded
      }
    }
    if (kGrid && !(shadow && t_best < sq.t_max)) {
      if constexpr (sizeof...(Stats) > 0) {
        csgr::Stats& lane = csgr::lane_stats(st...);
        const unsigned before = lane.walk_lane;
        grid_walk<kShared>(p, ray, t_best, id_best, lane);
        if (shadow) lane.shadow_lane += lane.walk_lane - before;
      } else {
        grid_walk<kShared>(p, ray, t_best, id_best);
      }
    }
    if (shadow) {
      if (!(t_best < sq.t_max)) {
        path.sr += sq.cr;
        path.sg += sq.cg;
        path.sb += sq.cb;
      }
      sq.t_max = kBig;
      continue;
    }
    if constexpr (sizeof...(Stats) > 0) csgr::segment_turn(st...);
    ++rays;
    live = shade_vertex<true, kShared>(p, path, t_best, id_best, pix, s, bounce, prev_pdf, sq);
    live = live && ++bounce < p.max_bounces;
  }
}

// One pixel's spp paths, one after another, each up to max_bounces
// segments; the radiance is summed in sample order. ``st``: as grid_walk's;
// a stats instantiation also counts the segment loop's turns.
template <bool kGrid, bool kNee, bool kShared, class... Stats>
__device__ __forceinline__ void render_pixel(const Params& p, const float* cam,
                                             uint32_t sample_offset, int x, int row,
                                             Stats&... st) {
  const int y = row + p.row_offset;  // in the frame: camera and RNG keys are global
  const uint32_t pix = static_cast<uint32_t>(y) * static_cast<uint32_t>(p.width) + x;
  const size_t out_pix = static_cast<size_t>(row) * p.width + x;
  float acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f;
  int rays = 0;
  csgr::Path path;
  for (int k = 0; k < p.spp; ++k) {
    const uint32_t s = static_cast<uint32_t>(k) + sample_offset;
    csgr::camera_ray(cam, x, y, pix, s, p.seed, p.width, p.height, p.lens, path);
    path.sr = 0.0f; path.sg = 0.0f; path.sb = 0.0f;
    if constexpr (kNee) {
      trace_nee_sample<kGrid, kShared>(p, path, pix, s, rays, st...);
    } else {
      for (int bounce = 0; bounce < p.max_bounces; ++bounce) {
        if constexpr (sizeof...(Stats) > 0) csgr::segment_turn(st...);
        ++rays;
        if (!trace_segment<kGrid, kShared>(p, path, pix, s, bounce, st...)) break;
      }
    }
    acc_r += path.sr;
    acc_g += path.sg;
    acc_b += path.sb;
  }
  const float spp = static_cast<float>(p.spp);
  float* out = p.out_rgb + 3 * out_pix;
  out[0] = acc_r / spp;
  out[1] = acc_g / spp;
  out[2] = acc_b / spp;
  p.out_rays[out_pix] = rays;
}

// Persistent CTAs of four warps (persistent.cuh): a CTA stages the tables
// once (kShared), then each warp takes 16x2-pixel work units from the
// launch's counter until the slab is done (16x8 tiles per CTA measured 6%
// slower on the grid frame). The NEE instantiations count the CTA's shadow
// rays in shared memory and add them to out_shadow at the end. A stats
// launch (kStats: grid mode from staged tables) adds each work unit's
// stats to its block, the shadow word with NEE only.
template <bool kGrid, bool kNee, bool kShared, bool kStats>
__global__ void __launch_bounds__(kThreads, (kCtasPerSm<kGrid, kNee>))
    sphere_megakernel(const csgr::StatsParams<Params, kStats> p) {
  if constexpr (kNee) {
    if (threadIdx.x == 0) cta_shadow_rays() = 0;
    __syncthreads();
  }
  if constexpr (kShared) csgr::stage_tables<2>({p.geo, p.cell_ids}, {p.geo_bytes, p.cell_bytes});
  float cam[csgr::kCamFloats];
#pragma unroll
  for (int i = 0; i < csgr::kCamFloats; ++i) cam[i] = __ldg(p.cam + i);
  const uint32_t sample_offset =
      p.sample_offset_at != nullptr ? __ldg(p.sample_offset_at) : p.sample_offset;
  csgr::for_each_pixel(p.work, p.width, p.rows, [&](int x, int row) {
    if constexpr (kStats) {
      csgr::Stats st;
      render_pixel<kGrid, kNee, kShared>(p, cam, sample_offset, x, row, st);
      csgr::add_stats<kNee ? 4 : 3>(p.stats, st);
    } else {
      render_pixel<kGrid, kNee, kShared>(p, cam, sample_offset, x, row);
    }
  });
  if constexpr (kNee) {
    __syncthreads();
    if (threadIdx.x == 0 && cta_shadow_rays() != 0) {
      atomicAdd(p.out_shadow, static_cast<unsigned long long>(cta_shadow_rays()));
    }
  }
}

template <bool kGrid, bool kNee, bool kShared, bool kStats>
cudaError_t launch(const csgr::StatsParams<Params, kStats>& p, cudaStream_t st) {
  const int smem = kShared ? p.geo_bytes + p.cell_bytes : 0;
  return csgr::launch_persistent(sphere_megakernel<kGrid, kNee, kShared, kStats>, p, kThreads,
                                 smem, p.width, p.rows, p.work, st);
}

template <bool kShared>
cudaError_t launch_mode(const Params& p, bool grid, bool nee, cudaStream_t st) {
  if (grid) {
    return nee ? launch<true, true, kShared, false>(p, st)
               : launch<true, false, kShared, false>(p, st);
  }
  return nee ? launch<false, true, kShared, false>(p, st)
             : launch<false, false, kShared, false>(p, st);
}

// The G-buffer mode's outputs, beside the scene (p.width x p.height pixels).
struct GbufferParams {
  Params p;
  float* depth;    // [H, W]: t * |d|, +inf on a miss
  float* normal;   // [H, W, 3]: face-forwarded unit normal, 0 on a miss
  float* albedo;   // [H, W, 3]: the sphere's albedo, the sky colour on a miss
  uint8_t* hit;    // [H, W]: 1 on a hit
};

// One pixel of render/aov.py::render_aovs through the packed scene's plain
// hit function: the centred st of render_aovs, Camera.rays without a lens
// (its zero offset added and subtracted as there), the nearest hit, then
// SphereScene.surface_hit's normal and integrator.sky_color's albedo. The
// st divide by the frame's size is a product with its rounded reciprocal:
// that is what torch's CUDA division by a Python number computes (one ulp
// from the quotient for a fifth of the pixels), so the kernel takes the
// plain version's bits on the card.
template <bool kGrid, bool kShared>
__device__ __forceinline__ void gbuffer_pixel(const GbufferParams& g, const float* cam, int x,
                                              int y) {
  const Params& p = g.p;
  const float st_x = (static_cast<float>(x) + 0.5f) * (1.0f / static_cast<float>(p.width));
  const float st_y =
      1.0f - (static_cast<float>(y) + 0.5f) * (1.0f / static_cast<float>(p.height));
  const float ox = cam[0] + 0.0f, oy = cam[1] + 0.0f, oz = cam[2] + 0.0f;
  const float dx = cam[3] + st_x * cam[6] + st_y * cam[9] - cam[0] - 0.0f;
  const float dy = cam[4] + st_x * cam[7] + st_y * cam[10] - cam[1] - 0.0f;
  const float dz = cam[5] + st_x * cam[8] + st_y * cam[11] - cam[2] - 0.0f;
  const Ray ray = make_ray(ox, oy, oz, dx, dy, dz);
  float t_best = kBig;
  int id_best = 0;
  for (int i = 0; i < p.n_brute; ++i) {
    const float t = sphere_t<kShared>(p, ray, i);
    if (t < t_best) {
      t_best = t;
      id_best = i;
    }
  }
  if (kGrid) grid_walk<kShared>(p, ray, t_best, id_best);

  const size_t pix = static_cast<size_t>(y) * p.width + x;
  float* n = g.normal + 3 * pix;
  float* a = g.albedo + 3 * pix;
  if (!(t_best < kBigCut)) {  // a miss: no depth, no normal, the sky's colour
    g.depth[pix] = __int_as_float(0x7f800000);
    n[0] = 0.0f; n[1] = 0.0f; n[2] = 0.0f;
    // vec.normalized(d, eps=1e-20) as torch forms it on the card: rsqrt
    const float udy = dy * rsqrtf(fmaxf(dx * dx + dy * dy + dz * dz, 1e-20f));
    const float t = p.sky == 0 ? 0.5f * (udy + 1.0f) : udy;
    const bool black = p.sky == 2;
    a[0] = black ? 0.0f : (1.0f - t) + t * 0.5f;
    a[1] = black ? 0.0f : (1.0f - t) + t * 0.7f;
    a[2] = black ? 0.0f : (1.0f - t) + t * 1.0f;
    g.hit[pix] = 0;
    return;
  }
  const float4 g0 = geo_load<kShared>(p, 2 * id_best);
  const float4 g1 = geo_load<kShared>(p, 2 * id_best + 1);
  const float4 g2 = __ldg(p.sph + 3 * id_best + 2);
  const float rad = g1.y;
  const float hx = ox + t_best * dx, hy = oy + t_best * dy, hz = oz + t_best * dz;
  const float onx = (hx - g0.x) / rad, ony = (hy - g0.y) / rad, onz = (hz - g0.z) / rad;
  const float sgn = dx * onx + dy * ony + dz * onz < 0.0f ? 1.0f : -1.0f;
  g.depth[pix] = t_best * sqrtf(dx * dx + dy * dy + dz * dz);
  n[0] = onx * sgn; n[1] = ony * sgn; n[2] = onz * sgn;
  a[0] = g2.x; a[1] = g2.y; a[2] = g2.z;
  g.hit[pix] = 1;
}

// Persistent CTAs over the frame, as sphere_megakernel's.
template <bool kGrid, bool kShared>
__global__ void __launch_bounds__(kThreads, kMinCtas) sphere_gbuffer(const GbufferParams g) {
  const Params& p = g.p;
  if constexpr (kShared) csgr::stage_tables<2>({p.geo, p.cell_ids}, {p.geo_bytes, p.cell_bytes});
  float cam[csgr::kCamFloats];
#pragma unroll
  for (int i = 0; i < csgr::kCamFloats; ++i) cam[i] = __ldg(p.cam + i);
  csgr::for_each_pixel(p.work, p.width, p.height, [&](int x, int y) {
    gbuffer_pixel<kGrid, kShared>(g, cam, x, y);
  });
}

template <bool kGrid, bool kShared>
cudaError_t launch_gbuffer(const GbufferParams& g, cudaStream_t st) {
  const int smem = kShared ? g.p.geo_bytes + g.p.cell_bytes : 0;
  return csgr::launch_persistent(sphere_gbuffer<kGrid, kShared>, g, kThreads, smem, g.p.width,
                                 g.p.height, g.p.work, st);
}

// The scene half of Params, as both entry points take it; a CUDA error
// code (invalid value or misaligned address) when the tables are unusable.
cudaError_t scene_params(Params& p, const void* cam, const void* spheres, const void* geometry,
                         int n_spheres, int n_brute, const void* cell_ids, int cx, int cz, int m,
                         int max_steps, float x0, float z0, float x1, float z1, float y_lo,
                         float y_hi, float cell, float inv_cell) {
  if (n_brute > n_spheres || (cell_ids != nullptr && m != kSlots)) return cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(geometry) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(cell_ids) % 16 != 0) {
    return cudaErrorMisalignedAddress;  // the bulk copies and int4 loads
  }
  p.cam = static_cast<const float*>(cam);
  p.sph = static_cast<const float4*>(spheres);
  p.geo = static_cast<const float4*>(geometry);
  p.n_brute = n_brute;
  p.cell_ids = static_cast<const int*>(cell_ids);
  p.geo_bytes = n_spheres * 8 * 4;
  p.cell_bytes = cell_ids != nullptr ? cx * cz * kSlots * 4 : 0;
  p.cx = cx; p.cz = cz; p.max_steps = max_steps;
  p.x0 = x0; p.z0 = z0; p.x1 = x1; p.z1 = z1;
  p.y_lo = y_lo; p.y_hi = y_hi; p.cell = cell; p.inv_cell = inv_cell;
  return cudaSuccess;
}

}  // namespace

// The most table bytes (geometry and cell lists) a CTA can stage on
// ``device``: its opt-in shared memory per block less the kernel's static
// shared memory; a negative CUDA error code on failure.
extern "C" int csgr_sphere_table_limit(int device) {
  return csgr::table_limit(sphere_megakernel<true, true, true, false>, device);
}

// shared_tables: 1 stages the geometry and cell tables in shared memory
// (the caller has checked that they fit csgr_sphere_table_limit), 0 reads
// them from global memory. sample_offset_at: null, or one device uint32
// that each thread reads in place of sample_offset when the launch runs.
// out_rays holds rows x width int32 segment counts and one int32 more: the
// launch's work counter. out_shadow (NEE: n_lamps > 0) is one uint64 that
// the launch zeroes, then sets to the shadow rays it traces; null
// otherwise, when it is not read. out_stats: null, or (grid mode from
// staged tables only) csgr::kStatsWords uint64 that the launch zeroes and
// fills through the stats instantiation (the shadow word with NEE only).
extern "C" int csgr_sphere_render(
    const void* cam, const void* spheres, const void* geometry, int n_spheres, int n_brute,
    const void* cell_ids, int cx, int cz, int m, int max_steps, float x0, float z0, float x1,
    float z1, float y_lo, float y_hi, float cell, float inv_cell, const void* lamps, int n_lamps,
    int width, int height, int rows, int row_offset,
    int spp, int max_bounces, unsigned int seed, unsigned int sample_offset,
    const void* sample_offset_at, int lens, int sky, int shared_tables, void* out_rgb,
    void* out_rays, void* out_shadow, void* out_stats, void* stream) {
  const bool nee = n_lamps > 0;
  if (rows < 1 || row_offset < 0 || row_offset + rows > height || spp < 1 || max_bounces < 0 ||
      (nee && out_shadow == nullptr) ||
      (out_stats != nullptr && (cell_ids == nullptr || !shared_tables))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  csgr::WithStats<Params> p;
  const cudaError_t bad = scene_params(p, cam, spheres, geometry, n_spheres, n_brute, cell_ids,
                                       cx, cz, m, max_steps, x0, z0, x1, z1, y_lo, y_hi, cell,
                                       inv_cell);
  if (bad != cudaSuccess) return static_cast<int>(bad);
  p.lamps = static_cast<const float4*>(lamps);
  p.n_lamps = n_lamps;
  p.width = width; p.height = height; p.spp = spp; p.max_bounces = max_bounces;
  p.rows = rows; p.row_offset = row_offset;
  p.seed = seed; p.sample_offset = sample_offset;
  p.sample_offset_at = static_cast<const uint32_t*>(sample_offset_at);
  p.lens = lens; p.sky = sky;
  p.out_rgb = static_cast<float*>(out_rgb);
  p.out_rays = static_cast<int*>(out_rays);
  p.work = p.out_rays + static_cast<size_t>(rows) * width;
  p.out_shadow = static_cast<unsigned long long*>(out_shadow);
  p.stats = static_cast<unsigned long long*>(out_stats);

  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (nee) {  // in stream order, before the launch
    const cudaError_t z = cudaMemsetAsync(out_shadow, 0, sizeof(unsigned long long), st);
    if (z != cudaSuccess) return static_cast<int>(z);
  }
  if (out_stats != nullptr) {
    const cudaError_t z =
        cudaMemsetAsync(out_stats, 0, csgr::kStatsWords * sizeof(unsigned long long), st);
    if (z != cudaSuccess) return static_cast<int>(z);
    return static_cast<int>(nee ? launch<true, true, true, true>(p, st)
                                : launch<true, false, true, true>(p, st));
  }
  const bool grid = cell_ids != nullptr;
  const Params& plain = p;
  const cudaError_t e = shared_tables ? launch_mode<true>(plain, grid, nee, st)
                                      : launch_mode<false>(plain, grid, nee, st);
  return static_cast<int>(e);
}

// The G-buffer mode over the whole width x height frame: the scene
// arguments as csgr_sphere_render's; depth [H, W] f32, normal and albedo
// [H, W, 3] f32, hit [H, W] u8; work is one int32, the launch's work
// counter, which the launch zeroes.
extern "C" int csgr_sphere_gbuffer(
    const void* cam, const void* spheres, const void* geometry, int n_spheres, int n_brute,
    const void* cell_ids, int cx, int cz, int m, int max_steps, float x0, float z0, float x1,
    float z1, float y_lo, float y_hi, float cell, float inv_cell, int width, int height, int sky,
    int shared_tables, void* depth, void* normal, void* albedo, void* hit, void* work,
    void* stream) {
  if (width < 1 || height < 1) return static_cast<int>(cudaErrorInvalidValue);
  GbufferParams g = {};
  const cudaError_t bad = scene_params(g.p, cam, spheres, geometry, n_spheres, n_brute, cell_ids,
                                       cx, cz, m, max_steps, x0, z0, x1, z1, y_lo, y_hi, cell,
                                       inv_cell);
  if (bad != cudaSuccess) return static_cast<int>(bad);
  g.p.width = width; g.p.height = height; g.p.sky = sky;
  g.p.work = static_cast<int*>(work);
  g.depth = static_cast<float*>(depth);
  g.normal = static_cast<float*>(normal);
  g.albedo = static_cast<float*>(albedo);
  g.hit = static_cast<uint8_t*>(hit);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool grid = cell_ids != nullptr;
  cudaError_t e;
  if (shared_tables) e = grid ? launch_gbuffer<true, true>(g, st) : launch_gbuffer<false, true>(g, st);
  else e = grid ? launch_gbuffer<true, false>(g, st) : launch_gbuffer<false, false>(g, st);
  return static_cast<int>(e);
}

extern "C" const char* csgr_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
