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
// structure: a thread renders a pixel, looping over samples and bounces.
// The TPU's one-hot MXU gathers, bf16 hi/lo tables with cell-relative v0,
// occupancy tiers, paged dense map and chunk chains are not here: a thread
// loads a face's record by its id.
//
// Shadow rays are any-hit tests with the plain version's identity-free
// rule: the lamp is occluded iff some face is hit below tl * (1 - 1e-4).
// Brute mode tests every face; grid mode the globals, then the walk with
// its best t starting at that bound, so its exit clamps there. The search
// stops at the first such hit.
//
// What bounds it on an H100: divergent FP32 ALU work (an MT test is 52
// operations, and threads of a warp take different walks, materials
// and bounce counts) and the dependent loads of each DDA step (the voxel's
// offsets, then each listed face's id and record). What the design does:
//   - the MT table ([F, 3] float4: v0, e1, e2, the 48 bytes a test reads,
//     16-byte aligned) is apart from the shading record (normal, material,
//     albedo: read once per hit), so a test's three loads stay in one
//     record and the tables are small enough to stage;
//   - the tables a walk reads (MT table, CSR offsets, face ids, globals;
//     65 KB for the 966-face meshnight scene) are staged once per CTA in
//     shared memory by one bulk (TMA 1D) copy on an mbarrier whenever they
//     fit a block's opt-in shared memory; larger meshes (the 15,362-face
//     bench mesh: 1,251,952 bytes; the 102,402-face mesh of
//     mesh_demo_scene(5, 5): 19,925,808 bytes, which fit the H100's 50 MB
//     L2) run the same code reading them from global memory and L2
//     (kShared = false): the launcher chooses by size;
//   - persistent CTAs (persistent.cuh) take 16x2-pixel work units per warp
//     from a per-launch counter, so the tables are staged once per CTA and
//     the tail of a frame is balanced. CTAs are large (kStagedThreads,
//     kGlobalThreads), so the SM's shared memory holds few copies of the
//     tables or of the occupancy mask while its warps stay resident;
//   - the walk keeps its per-axis state (voxel, next crossing, step) in
//     scalars, not in arrays indexed by the axis it advances, so nothing of
//     it lives in the local-memory stack frame;
//   - the walk over tables in global memory first reads its voxel's bit in
//     the grid's occupancy mask (tri_worklist.occupancy_mask: one bit per
//     block of f x f x f voxels, set iff a voxel of the block lists a
//     face), staged per CTA in shared memory, and loads the voxel's two
//     CSR offsets from L2 only where the bit is set. Most voxels a walk
//     crosses are empty (97.6% of the 102,402-face mesh's grid; the mask
//     answers 96.8% of its visits), and each such step cost two dependent
//     L2 loads before the DDA could advance.
//     An unset bit means an empty list, so the walk visits the same voxels
//     and tests the same faces in the same order as without the mask. f is
//     the finest power-of-two block edge whose mask fits
//     tri_worklist.MASK_BUDGET (62 KB, so the SM's shared memory stays
//     within its 64 KB carveout and 192 KB of L1 stay for the records and
//     lists the walk reads; f = 2 for the 102,402-face mesh's 257 x 67 x
//     193 grid, f = 1, a bit per voxel, for the 15,362-face mesh's), a rule
//     of the grid's dims, so a voxel's block coordinate is a shift (i >>
//     mask_shift).
//     The walk over staged tables has no mask: its offsets are already
//     loads from shared memory, as a mask word would be;
//   - on a grid of f > 1 that walk is two-level: a coarse mask (one bit
//     per block of C x C x C voxels, C = 4f: 8 for the 102,402-face mesh, a
//     33 x 9 x 25 mask in 944 bytes; tri_worklist.coarse_block), staged
//     after the fine one in the same bulk copy, is read first at each turn.
//     In an empty coarse block the turn leaves the block (a skip): its exit
//     is the least of its three far-face crossings, each the voxel's next
//     crossing plus the voxels left in the block times the axis's step in
//     t; the axis it leaves by moves to the next block's first voxel, and
//     each other axis by the crossings it has before the exit, a count that
//     errs low (follow_axis), so no rounding steps past a voxel the ray
//     crosses. In an occupied block the turn is the flat walk's step. Both
//     kinds share one advance (two_level_step: a fine step is a block of
//     one voxel), so a warp whose lanes mix them runs one loop and one
//     advance, not two. Empty space, 97% of a walk's visits on the
//     102,402-face mesh, is crossed in a quarter of the turns; every face
//     is still tested in every voxel the ray crosses, so the hits are the
//     flat walk's. The two-level walk is its own instantiation (kCoarse),
//     launched where the grid has a coarse level (coarse_shift > 0). A grid
//     of f = 1 has none: there a skip saves at most three fine steps and
//     costs more than it saves, so its walk is the flat one, as over staged
//     tables.
//
// Every launch counts the Möller-Trumbore tests of its path segments (the
// globals or every face, then the faces the walk lists: what the plain
// version's counts call global_tests + face_tests) into one int64 word,
// the voxel visits of its path segments that the occupancy mask answered
// (the plain walk's masked_visits; 0 where the walk has no mask) into a
// second one and the turns that skipped a coarse block (coarse_skips) into
// a third: each pixel's counts in registers, reduced over the warp's lanes
// at the end of each work unit, added by one atomic each.
// Shadow rays' tests and visits are not counted, as shadow rays are not
// counted in the segments.
//
// Stats mode (kStats, the grid walk over global memory without NEE: the
// mesh cell's instantiation): the same image and counts, and per launch a
// block of work counts (persistent.cuh): the bounce loop's warp turns and
// the walk loop's turns (fine steps and coarse skips) by warp and by lane.
// The launcher runs it where out_stats is not null; the other launches
// compile as if it were not there.
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

#include <type_traits>

#include "path_common.cuh"
#include "persistent.cuh"

// The CTA's dynamic shared memory (smem_tables, persistent.cuh) holds the
// staged tables as one block: the [F, 3] float4 MT table, then (grid mode)
// the CSR offsets, the face ids and the globals, each at the byte offset
// the packer gave it (kShared instantiations); or (grid mode, kShared =
// false) the grid's occupancy masks, uint32 words: the fine one, then the
// coarse one at byte coarse_at.

namespace {

constexpr float kMiss = 1e30f;     // t of a face that is not hit
constexpr float kHitCut = 5e29f;   // a nearest t below this is a hit
constexpr float kBig = 1e30f;      // the walk's infinity
constexpr float kEpsFlat = 1e-12f;
constexpr float kTMin = 1e-3f;     // hit epsilon along t
constexpr int kFaceF4 = 5;         // float4 per shading record
constexpr int kMtF4 = 3;           // float4 per MT record

// CTA size and register budget (measured, PERF.md): a CTA that reads
// global memory is 32 warps, one per SM (at most 64 registers a thread),
// so an SM stages one copy of the occupancy mask; with the mask, 16-spp
// frames of 3,842 to 245,762 faces ran 4-6% faster than with two
// sixteen-warp CTAs an SM, and those 2-5% faster than with eight four-warp
// ones, whose eight copies of the mask an SM cost L1;
// CTAs that stage the tables are sixteen warps, two per SM (64 registers;
// 128-thread CTAs, three per SM under 65 KB of tables, ran the meshnight
// grid-NEE frame 17% slower). The NEE kernels, which hold a path and a
// shadow ray, are sixteen warps with no register budget: at 64 registers
// the grid-NEE kernel spilled 352 bytes a thread and ran that frame 18%
// slower.
constexpr int kGlobalThreads = 1024, kGlobalMinCtas = 1;
constexpr int kStagedThreads = 512, kStagedMinCtas = 2;
constexpr int kNeeThreads = 512, kNeeMinCtas = 1;

template <bool kShared, bool kNee>
constexpr int kThreads = kNee ? kNeeThreads : kShared ? kStagedThreads : kGlobalThreads;
template <bool kShared, bool kNee>
constexpr int kMinCtas = kNee ? kNeeMinCtas : kShared ? kStagedMinCtas : kGlobalMinCtas;

struct Params {
  const float* cam;       // [24]: origin, lower_left, horizontal, vertical, u, v, lens_radius
  const float4* faces;    // [F, 5] float4 shading records: (v0, e1x) (e1yz, e2xy) (e2z, n)
                          // (kind, param, ar, ag) (ab, 0, 0, 0)
  const unsigned char* tables;  // the staged block in global memory (layout above)
  int table_bytes;
  int n_faces;
  int n_glob, glob_at;    // globals (grid mode): count, byte offset in the tables
  int off_at, ids_at;     // CSR offsets [V + 1] (voxel (ix * ny + iy) * nz + iz) and face
                          // ids [P] (ascending within a voxel): byte offsets in the tables
  int nx, ny, nz;
  float lo[3], hi[3], cell, inv_cell;
  const float4* lamps;    // [n_lamps, 4] float4: (v0, e1x) (e1yz, e2xy) (e2z, emit) (n, area)
  int n_lamps;
  int width, height, spp, max_bounces;
  int rows, row_offset;  // the slab rendered: rows [row_offset, row_offset + rows)
  uint32_t seed, sample_offset;
  int lens, sky;          // sky: 0 rtiow, 1 wololo, 2 black
  float* out_rgb;         // [rows, W, 3]
  int* out_rays;          // [rows, W]
  int* work;              // the work-unit counter, zeroed before each launch
  unsigned long long* out_tests;  // [3]: the launch's path-segment triangle tests, the voxel
                                  // visits its mask answered and its coarse skips; zeroed
                                  // before it
};

// The launch parameters of a walk over tables in global memory: Params and
// the grid's occupancy masks, block (bx, by, bz) of f^3 voxels being bit
// b = (bx * mask_ny + by) * mask_nz + bz, bx = ix >> mask_shift (f =
// 1 << mask_shift), and the coarse mask's the same at byte coarse_at over
// blocks of C^3 voxels (C = 1 << coarse_shift; coarse_shift 0: the grid
// has no coarse level). The staged instantiations take Params alone.
struct MaskedParams : Params {
  const unsigned char* mask;  // both masks
  int mask_bytes, mask_shift, mask_ny, mask_nz;
  int coarse_at, coarse_shift, coarse_ny, coarse_nz;
};

template <bool kShared>
using KernelParams = std::conditional_t<kShared, Params, MaskedParams>;

// What a walk counts beside its triangle tests: over tables in global
// memory the visits the fine mask answered and the coarse skips; over
// staged tables an unused word.
struct MaskCounts {
  unsigned masked = 0, coarse = 0;
};

template <bool kShared>
using WalkCounts = std::conditional_t<kShared, unsigned, MaskCounts>;

struct Ray {
  float o[3], d[3];
};

// The tables, read from shared memory (kShared: staged once per CTA) or
// from global memory (tables too large for a CTA's shared memory).
template <bool kShared>
__device__ __forceinline__ float4 mt_load(const Params& p, int i) {  // float4 i of the MT table
  if constexpr (kShared) return reinterpret_cast<const float4*>(smem_tables)[i];
  else return __ldg(reinterpret_cast<const float4*>(p.tables) + i);
}

template <bool kShared>
__device__ __forceinline__ int int_load(const Params& p, int at, int i) {  // int i at byte at
  if constexpr (kShared) return reinterpret_cast<const int*>(smem_tables + at)[i];
  else return __ldg(reinterpret_cast<const int*>(p.tables + at) + i);
}

// MT t of the face whose record is (a, b, c), kMiss where not hit
// (render/trimesh.mt_t).
__device__ __forceinline__ float tri_t(const Ray& r, float4 a, float4 b, float4 c) {
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

// The bit of voxel (ix, iy, iz)'s block in the mask at byte ``at`` of the
// staged masks, blocks of 2^shift voxels on an edge, ny x nz along y and z.
__device__ __forceinline__ bool mask_bit(int at, int shift, int ny, int nz, int ix, int iy,
                                         int iz) {
  const unsigned bx = static_cast<unsigned>(ix) >> shift;
  const unsigned by = static_cast<unsigned>(iy) >> shift;
  const unsigned bz = static_cast<unsigned>(iz) >> shift;
  const unsigned b = (bx * static_cast<unsigned>(ny) + by) * static_cast<unsigned>(nz) + bz;
  return (reinterpret_cast<const uint32_t*>(smem_tables + at)[b >> 5] >> (b & 31u)) & 1u;
}

// Whether the occupancy mask marks the block of voxel (ix, iy, iz) as
// holding a listed face.
__device__ __forceinline__ bool block_occupied(const MaskedParams& p, int ix, int iy, int iz) {
  return mask_bit(0, p.mask_shift, p.mask_ny, p.mask_nz, ix, iy, iz);
}

// The same for the coarse block of voxel (ix, iy, iz).
__device__ __forceinline__ bool coarse_occupied(const MaskedParams& p, int ix, int iy, int iz) {
  return mask_bit(p.coarse_at, p.coarse_shift, p.coarse_ny, p.coarse_nz, ix, iy, iz);
}

// Voxels past voxel i in its coarse block along a step s (edge = C - 1).
__device__ __forceinline__ int left_in_block(int i, int s, int edge) {
  return s > 0 ? edge - (i & edge) : (i & edge);
}

template <bool kShared>
__device__ __forceinline__ float face_t(const Params& p, const Ray& r, int id) {
  return tri_t(r, mt_load<kShared>(p, kMtF4 * id), mt_load<kShared>(p, kMtF4 * id + 1),
               mt_load<kShared>(p, kMtF4 * id + 2));
}

// One voxel's list [k0, k1) refines (t_best, id_best); kAny returns true at
// the first t below t_best. Strict: the earlier voxel, then the lower list
// slot, wins ties.
template <bool kAny, bool kShared>
__device__ __forceinline__ bool list_test(const Params& p, const Ray& r, int k, float& t_best,
                                          int& id_best) {
  const int id = int_load<kShared>(p, p.ids_at, k);
  const float t = face_t<kShared>(p, r, id);
  if (t < t_best) {
    if (kAny) return true;
    t_best = t;
    id_best = id;
  }
  return false;
}

// On a skip, an axis the block is not left by follows the ray to the exit
// t_exit: it takes the crossings it has before t_exit, the voxel's next
// crossing tm and every step td after it, at most the voxels ``left`` in
// the block, and moves its voxel and next crossing by as many. Their count
// is their span in t times |d| / cell, rounded up, and one fewer where the
// last of them, tm + (m - 1) td as the exit is summed, does not come
// before t_exit: the count errs low, as an undercount only adds a visit
// and an overcount would step past a voxel the ray crosses (the rounding
// is far below one step, so one check does). A flat axis (tm at kBig)
// takes none.
template <int kAx>
__device__ __forceinline__ void follow_axis(const MaskedParams& p, const Ray& r, float t_exit,
                                            int left, int s, float td, int& i, float& tm) {
  const float n = ceilf((t_exit - tm) * (fabsf(r.d[kAx]) * p.inv_cell));
  float m = fminf(fmaxf(n, 0.0f), static_cast<float>(left));
  if (m > 0.0f && tm + (m - 1.0f) * td >= t_exit) m -= 1.0f;
  i += s * static_cast<int>(m);
  tm = tm + m * td;
}

// The advance of a two-level turn over a block of edge + 1 voxels (edge 0:
// the voxel, a fine step; C - 1: an empty coarse block, a skip). Along each
// axis the block's far face is crossed at the voxel's next crossing plus
// the voxels left in the block times the axis's step in t; the least of
// the three (ties as the flat walk takes them: x, then y) is the turn's
// exit, which it returns. On a skip the two other axes follow the ray
// there (follow_axis); the axis the block is left by moves to the next
// block's first voxel. A fine step is the flat walk's, bit for bit.
__device__ __forceinline__ float two_level_step(const MaskedParams& p, const Ray& r,
                                                const int (&step)[3], const float (&td)[3],
                                                int edge, int& ix, int& iy, int& iz, float& tmx,
                                                float& tmy, float& tmz) {
  int lx = 0, ly = 0, lz = 0;
  float ex = tmx, ey = tmy, ez = tmz;
  if (edge != 0) {
    lx = left_in_block(ix, step[0], edge);
    ly = left_in_block(iy, step[1], edge);
    lz = left_in_block(iz, step[2], edge);
    ex = tmx + static_cast<float>(lx) * td[0];
    ey = tmy + static_cast<float>(ly) * td[1];
    ez = tmz + static_cast<float>(lz) * td[2];
  }
  const float t_exit = fminf(fminf(ex, ey), ez);
  const bool go_x = ex <= ey && ex <= ez;
  const bool go_y = !go_x && ey <= ez;
  if (edge != 0) {
    if (!go_x) follow_axis<0>(p, r, t_exit, lx, step[0], td[0], ix, tmx);
    if (!go_y) follow_axis<1>(p, r, t_exit, ly, step[1], td[1], iy, tmy);
    if (go_x || go_y) follow_axis<2>(p, r, t_exit, lz, step[2], td[2], iz, tmz);
  }
  if (go_x) {
    ix += step[0] * (lx + 1);
    tmx = ex + td[0];
  } else if (go_y) {
    iy += step[1] * (ly + 1);
    tmy = ey + td[1];
  } else {
    iz += step[2] * (lz + 1);
    tmz = ez + td[2];
  }
  return t_exit;
}

// 3D DDA over the voxel lists (tri_worklist._walk; over tables in global
// memory two-level, tri_worklist._walk_two_level), refining (t_best,
// id_best) found by the globals; kCoarse (!kShared, a grid with a coarse
// level): two-level. kAny: stop at the first t below t_best
// (a shadow ray whose t_best starts at its bound) and return true then;
// else every listed face of a visited voxel is tested, and their number
// is added to ``tests``, and (!kShared) the visits the occupancy mask
// answers and the coarse skips to ``masked``. kRolled runs each voxel's
// list as a rolled loop (the compiler unrolls it otherwise). A stats
// instantiation passes its lane's Stats, in which each turn is counted
// (csgr::walk_turn); the others pass none.
template <bool kAny, bool kShared, bool kCoarse, bool kRolled, class... Stats>
__device__ __forceinline__ bool grid_walk(const KernelParams<kShared>& p, const Ray& r,
                                          float& t_best, int& id_best, unsigned& tests,
                                          WalkCounts<kShared>& masked, Stats&... st) {
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
  // the walk's state in scalars (an array indexed by the advancing axis
  // would live in local memory)
  int ix = idx[0], iy = idx[1], iz = idx[2];
  float tmx = tmax[0], tmy = tmax[1], tmz = tmax[2];

  const int max_steps = p.nx + p.ny + p.nz;
  for (int s = 0; s < max_steps; ++s) {
    if constexpr (sizeof...(Stats) > 0) csgr::walk_turn(st...);
    [[maybe_unused]] int edge = 0;  // kCoarse: the turn's block's edge less one voxel
    bool occupied = true;
    if constexpr (kCoarse) {
      if (!coarse_occupied(p, ix, iy, iz)) {  // an empty coarse block: a skip
        edge = (1 << p.coarse_shift) - 1;
        if constexpr (!kAny) ++masked.coarse;
      }
    }
    if constexpr (!kShared) occupied = edge == 0 && block_occupied(p, ix, iy, iz);
    if (!occupied) {  // an empty block: no offsets to load
      if constexpr (!kAny && !kShared) masked.masked += edge == 0;
    } else {
      const int vox = (ix * p.ny + iy) * p.nz + iz;
      const int k1 = int_load<kShared>(p, p.off_at, vox + 1);
      const int k0 = int_load<kShared>(p, p.off_at, vox);
      if constexpr (!kAny) tests += static_cast<unsigned>(k1 - k0);
      if constexpr (kRolled) {
#pragma unroll 1
        for (int k = k0; k < k1; ++k) {
          if (list_test<kAny, kShared>(p, r, k, t_best, id_best)) return true;
        }
      } else {
        for (int k = k0; k < k1; ++k) {
          if (list_test<kAny, kShared>(p, r, k, t_best, id_best)) return true;
        }
      }
    }
    if constexpr (kCoarse) {
      const float t_next = two_level_step(p, r, step, td, edge, ix, iy, iz, tmx, tmy, tmz);
      const bool in_grid = ix >= 0 && ix < p.nx && iy >= 0 && iy < p.ny && iz >= 0 && iz < p.nz;
      if (!(in_grid && t_next <= t_out && t_next < t_best)) break;
      continue;
    }
    const float t_next = fminf(fminf(tmx, tmy), tmz);
    const bool go_x = tmx <= tmy && tmx <= tmz;
    const bool go_y = !go_x && tmy <= tmz;
    if (go_x) {
      ix += step[0];
      tmx += td[0];
    } else if (go_y) {
      iy += step[1];
      tmy += td[1];
    } else {
      iz += step[2];
      tmz += td[2];
    }
    const bool in_grid = ix >= 0 && ix < p.nx && iy >= 0 && iy < p.ny && iz >= 0 && iz < p.nz;
    if (!(in_grid && t_next <= t_out && t_next < t_best)) break;
  }
  return false;
}

// The nearest hit: every face (brute), or the globals then the walk (grid);
// the faces tested are added to ``tests``, the walk's masked visits and
// coarse skips to ``masked``; ``st``: as grid_walk's.
template <bool kGrid, bool kNee, bool kShared, bool kCoarse, class... Stats>
__device__ __forceinline__ void nearest(const KernelParams<kShared>& p, const Ray& r,
                                        float& t_best, int& id_best, unsigned& tests,
                                        WalkCounts<kShared>& masked, Stats&... st) {
  t_best = kMiss;
  id_best = 0;
  const int n = kGrid ? p.n_glob : p.n_faces;
  tests += static_cast<unsigned>(n);
  for (int i = 0; i < n; ++i) {
    const int id = kGrid ? int_load<kShared>(p, p.glob_at, i) : i;
    const float t = face_t<kShared>(p, r, id);
    if (t < t_best) {  // strict: the lowest face id wins ties (argmin)
      t_best = t;
      id_best = id;
    }
  }
  if (kGrid) grid_walk<false, kShared, kCoarse, kNee>(p, r, t_best, id_best, tests, masked, st...);
}

// The shadow rays' walk, kept out of line (ROADMAP C-7). Inlined into the
// grid-NEE kernel as it was before its persistent-CTA redesign, the
// compiled kernel sometimes never finished validate_gpu config 7's launch
// (96x54, 1,024 spp at sample offset 6,144) and sometimes finished it with
// fewer segments (9,331,715 where every other build traces 9,416,222),
// though a shadow ray cannot change the segment count: every lane of two
// 16x2 warps lost segments, the other warps none. A host build of that
// source, inlined or not, under AddressSanitizer and UBSan and with its
// stack filled with zeros or a pattern, traced the launch right. In this
// design every build tools/shadow_walk_probe.py makes (out of line,
// inlined, inlined at -Xptxas -O0, inlined with the walk's state in
// axis-indexed arrays) traces it right three times out of three, and the
// inlined walk is 1% faster on meshnight; the fault's cause is not shown,
// so the walk stays out of line.
template <bool kShared, bool kCoarse>
__device__ __noinline__ bool shadow_walk(const KernelParams<kShared>& p, const Ray& r,
                                         float& t_best, int& id_best) {
  unsigned uncounted = 0;
  WalkCounts<kShared> unmasked{};
  return grid_walk<true, kShared, kCoarse, true>(p, r, t_best, id_best, uncounted, unmasked);
}

// A shadow ray: true iff some face is hit below t_max.
template <bool kGrid, bool kShared, bool kCoarse>
__device__ __forceinline__ bool occluded(const KernelParams<kShared>& p, const Ray& r,
                                         float t_max) {
  const int n = kGrid ? p.n_glob : p.n_faces;
  for (int i = 0; i < n; ++i) {
    if (face_t<kShared>(p, r, kGrid ? int_load<kShared>(p, p.glob_at, i) : i) < t_max) {
      return true;
    }
  }
  if (!kGrid) return false;
  float t_best = t_max;
  int id_best = 0;
  return shadow_walk<kShared, kCoarse>(p, r, t_best, id_best);
}

// One pixel's spp paths, one after another, each up to max_bounces
// segments; the radiance is summed in sample order. Returns the triangle
// tests of the pixel's path segments and adds their masked visits and
// coarse skips to ``masked``; ``st``: as grid_walk's, where a stats
// instantiation also counts the segment loop's turns.
template <bool kGrid, bool kNee, bool kShared, bool kCoarse, class... Stats>
__device__ __forceinline__ unsigned render_pixel(const KernelParams<kShared>& p, const float* cam,
                                                 int x, int row, WalkCounts<kShared>& masked,
                                                 Stats&... st) {
  const int y = row + p.row_offset;  // in the frame: camera and RNG keys are global
  const uint32_t pix = static_cast<uint32_t>(y) * static_cast<uint32_t>(p.width) + x;
  const size_t out_pix = static_cast<size_t>(row) * p.width + x;

  csgr::Path path;
  float acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f;
  int rays = 0;
  unsigned tests = 0;
  for (int k = 0; k < p.spp; ++k) {
    const uint32_t s = static_cast<uint32_t>(k) + p.sample_offset;
    csgr::camera_ray(cam, x, y, pix, s, p.seed, p.width, p.height, p.lens, path);
    path.sr = 0.0f; path.sg = 0.0f; path.sb = 0.0f;
    float prev_pdf = 0.0f;  // NEE: pdf of the scatter that made this ray, 0 on camera rays
    for (int bounce = 0; bounce < p.max_bounces; ++bounce) {
      if constexpr (sizeof...(Stats) > 0) csgr::segment_turn(st...);
      ++rays;
      const float ox = path.ox, oy = path.oy, oz = path.oz;
      const float dx = path.dx, dy = path.dy, dz = path.dz;
      const Ray ray = {{ox, oy, oz}, {dx, dy, dz}};
      float t_best;
      int id_best;
      nearest<kGrid, kNee, kShared, kCoarse>(p, ray, t_best, id_best, tests, masked, st...);

      const float inv_len = csgr::inv_length(path);
      const float udx = dx * inv_len, udy = dy * inv_len, udz = dz * inv_len;
      if (!(t_best < kHitCut)) {  // miss: sky, path ends
        csgr::add_sky(path, p.sky, udy);
        break;
      }

      const float4* f = p.faces + kFaceF4 * id_best;  // the shading record, once per hit
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
          if (!occluded<kGrid, kShared, kCoarse>(p, shadow, ls.tl * csgr::kShadowScale)) {
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
  float* out = p.out_rgb + 3 * out_pix;
  out[0] = acc_r / spp;
  out[1] = acc_g / spp;
  out[2] = acc_b / spp;
  p.out_rays[out_pix] = rays;
  return tests;
}

// A pixel's masked visits and coarse skips into the launch's second and
// third words.
__device__ __forceinline__ void add_walk_counts(unsigned long long* out_tests,
                                                const MaskCounts& c) {
  csgr::add_count(out_tests + 1, c.masked);
  csgr::add_count(out_tests + 2, c.coarse);
}

// Persistent CTAs (persistent.cuh): a CTA stages the tables once (kShared),
// or in grid mode the occupancy masks, then each warp takes 16x2-pixel work
// units from the launch's counter and adds the unit's triangle tests (and,
// walking global memory, its masked visits and coarse skips) to the
// launch's words; a stats launch (kStats: the grid walk over global memory
// without NEE) adds the unit's stats to its block. kCoarse: the two-level
// walk (a grid over global memory with a coarse level).
template <bool kGrid, bool kNee, bool kShared, bool kStats, bool kCoarse = false>
__global__ void __launch_bounds__(kThreads<kShared, kNee>, kMinCtas<kShared, kNee>)
    trimesh_kernel(const csgr::StatsParams<KernelParams<kShared>, kStats> p) {
  if constexpr (kShared) {
    csgr::stage_tables<1>({p.tables}, {p.table_bytes});
  } else if constexpr (kGrid) {
    csgr::stage_tables<1>({p.mask}, {p.mask_bytes});
  }
  float cam[csgr::kCamFloats];
#pragma unroll
  for (int i = 0; i < csgr::kCamFloats; ++i) cam[i] = __ldg(p.cam + i);
  csgr::for_each_pixel(p.work, p.width, p.rows, [&](int x, int row) {
    WalkCounts<kShared> masked{};
    if constexpr (kStats) {
      csgr::Stats st;
      csgr::add_count(p.out_tests,
                      render_pixel<kGrid, kNee, kShared, kCoarse>(p, cam, x, row, masked, st));
      if constexpr (kGrid && !kShared) add_walk_counts(p.out_tests, masked);
      csgr::add_stats<3>(p.stats, st);
    } else {
      csgr::add_count(p.out_tests,
                      render_pixel<kGrid, kNee, kShared, kCoarse>(p, cam, x, row, masked));
      if constexpr (kGrid && !kShared) add_walk_counts(p.out_tests, masked);
    }
  });
}

template <bool kGrid, bool kNee, bool kShared, bool kStats, bool kCoarse = false>
cudaError_t launch(const csgr::StatsParams<KernelParams<kShared>, kStats>& p, cudaStream_t st) {
  int smem = 0;
  if constexpr (kShared) smem = p.table_bytes;
  else if constexpr (kGrid) smem = p.mask_bytes;
  return csgr::launch_persistent(trimesh_kernel<kGrid, kNee, kShared, kStats, kCoarse>, p,
                                 kThreads<kShared, kNee>, smem, p.width, p.rows, p.work, st);
}

template <bool kShared>
cudaError_t launch_mode(const KernelParams<kShared>& p, bool grid, bool nee, cudaStream_t st) {
  if constexpr (!kShared) {
    if (grid && p.coarse_shift != 0) {
      return nee ? launch<true, true, false, false, true>(p, st)
                 : launch<true, false, false, false, true>(p, st);
    }
  }
  if (grid) {
    return nee ? launch<true, true, kShared, false>(p, st)
               : launch<true, false, kShared, false>(p, st);
  }
  return nee ? launch<false, true, kShared, false>(p, st)
             : launch<false, false, kShared, false>(p, st);
}

}  // namespace

// The most table bytes a CTA of the mesh kernel can stage on ``device``:
// its opt-in shared memory per block less the kernel's static shared
// memory; a negative CUDA error code on failure.
extern "C" int csgr_mesh_table_limit(int device) {
  return csgr::table_limit(trimesh_kernel<true, true, true, false>, device);
}

// tables: the MT table [F, 3] float4, then (grid: offsets non-negative)
// the CSR offsets, face ids and globals at byte offsets off_at, ids_at and
// glob_at; table_bytes long, 16-byte aligned, a multiple of 16.
// mask (grid mode): the occupancy masks, mask_bytes long (a multiple of
// 16, 16-byte aligned): the fine one, its blocks mask_ny x mask_nz along y
// and z, a voxel coordinate's block i >> mask_shift; then from byte
// coarse_at (a multiple of 16) the coarse one, coarse_ny x coarse_nz, block
// i >> coarse_shift (coarse_shift > mask_shift), or coarse_shift 0 where the
// grid has none; read where the tables are not staged.
// shared_tables: 1 stages them in shared memory (the caller has checked
// that they fit csgr_mesh_table_limit), 0 reads them from global memory.
// out_rays holds rows x width int32 segment counts and one int32 more: the
// launch's work counter. out_tests is three uint64, which the launch zeroes
// and then fills with its path segments' triangle tests, the voxel visits
// its mask answered and its coarse skips. out_stats: null, or (the grid
// walk over global memory without NEE only) csgr::kStatsWords uint64 that
// the launch zeroes and fills through the stats instantiation (no shadow
// word).
extern "C" int csgr_mesh_render(
    const void* cam, const void* faces, const void* tables, int table_bytes, int n_faces,
    int n_glob, int glob_at, int off_at, int ids_at, int nx, int ny, int nz, float x0, float y0,
    float z0, float x1, float y1, float z1, float cell, float inv_cell, const void* mask,
    int mask_bytes, int mask_shift, int mask_ny, int mask_nz, int coarse_at, int coarse_shift,
    int coarse_ny, int coarse_nz, const void* lamps,
    int n_lamps, int width, int height, int rows, int row_offset, int spp, int max_bounces,
    unsigned int seed, unsigned int sample_offset, int lens, int sky, int shared_tables,
    void* out_rgb, void* out_rays, void* out_tests, void* out_stats, void* stream) {
  const bool grid = off_at >= 0, nee = n_lamps > 0;
  if (rows < 1 || row_offset < 0 || row_offset + rows > height || spp < 1 || max_bounces < 0 ||
      table_bytes % 16 != 0 || table_bytes < n_faces * kMtF4 * 16 || out_tests == nullptr ||
      (out_stats != nullptr && (!grid || nee || shared_tables)) ||
      (grid && !shared_tables &&
       (mask == nullptr || mask_bytes < 16 || mask_bytes % 16 != 0 || mask_shift < 0 ||
        mask_shift > 30 ||
        (coarse_shift != 0 && (coarse_shift <= mask_shift || coarse_shift > 30 ||
                               coarse_at < 16 || coarse_at % 16 != 0 ||
                               coarse_at >= mask_bytes))))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (reinterpret_cast<uintptr_t>(tables) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(mask) % 16 != 0) {
    return static_cast<int>(cudaErrorMisalignedAddress);  // the bulk copies and float4 loads
  }
  csgr::WithStats<MaskedParams> p;
  p.cam = static_cast<const float*>(cam);
  p.faces = static_cast<const float4*>(faces);
  p.tables = static_cast<const unsigned char*>(tables);
  p.table_bytes = table_bytes;
  p.n_faces = n_faces;
  p.n_glob = n_glob; p.glob_at = glob_at;
  p.off_at = off_at; p.ids_at = ids_at;
  p.nx = nx; p.ny = ny; p.nz = nz;
  p.lo[0] = x0; p.lo[1] = y0; p.lo[2] = z0;
  p.hi[0] = x1; p.hi[1] = y1; p.hi[2] = z1;
  p.cell = cell; p.inv_cell = inv_cell;
  p.lamps = static_cast<const float4*>(lamps);
  p.n_lamps = n_lamps;
  p.width = width; p.height = height; p.spp = spp; p.max_bounces = max_bounces;
  p.rows = rows; p.row_offset = row_offset;
  p.seed = seed; p.sample_offset = sample_offset;
  p.lens = lens; p.sky = sky;
  p.out_rgb = static_cast<float*>(out_rgb);
  p.out_rays = static_cast<int*>(out_rays);
  p.work = p.out_rays + static_cast<size_t>(rows) * width;
  p.out_tests = static_cast<unsigned long long*>(out_tests);
  p.mask = static_cast<const unsigned char*>(mask);
  p.mask_bytes = mask_bytes; p.mask_shift = mask_shift;
  p.mask_ny = mask_ny; p.mask_nz = mask_nz;
  p.coarse_at = coarse_at; p.coarse_shift = coarse_shift;
  p.coarse_ny = coarse_ny; p.coarse_nz = coarse_nz;
  p.stats = static_cast<unsigned long long*>(out_stats);

  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // in stream order, before the launch
  const cudaError_t z = cudaMemsetAsync(out_tests, 0, 3 * sizeof(unsigned long long), st);
  if (z != cudaSuccess) return static_cast<int>(z);
  if (out_stats != nullptr) {
    const cudaError_t zs =
        cudaMemsetAsync(out_stats, 0, csgr::kStatsWords * sizeof(unsigned long long), st);
    if (zs != cudaSuccess) return static_cast<int>(zs);
    return static_cast<int>(coarse_shift != 0 ? launch<true, false, false, true, true>(p, st)
                                              : launch<true, false, false, true>(p, st));
  }
  const cudaError_t e = shared_tables
                            ? launch_mode<true>(static_cast<const Params&>(p), grid, nee, st)
                            : launch_mode<false>(static_cast<const MaskedParams&>(p), grid, nee,
                                                 st);
  return static_cast<int>(e);
}

extern "C" const char* csgr_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
