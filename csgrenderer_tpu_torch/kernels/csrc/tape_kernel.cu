// CSG tape path-tracing kernel for Hopper (sm_90a): event-flip mode and the
// interval-list audit mode, each with and without next-event estimation
// (NEE).
//
// Replaces csgrenderer_tpu/kernels/tape_kernel.py::_make_kernel +
// _render_tape_packed (the Pallas TPU kernel): its production mode,
// tape_hit_events, global and clustered (scene/partition.py), its audit mode
// (count_dropped: tape_hit_lists, _combine, _merge_sorted_planes,
// _single_to_list) and its NEE variant (nee_lamps). It computes what that
// kernel computes, not its block structure:
//   - per traced segment, every leaf's (enter, exit) interval in its local
//     frame (sphere, half-space, box, cylinder; _leaf_interval);
//   - event-flip mode: the nearest CSG surface is the smallest leaf
//     boundary t where the root's membership flips, evaluated per cluster
//     (one cluster = the whole tape in global mode), and `entering` is the
//     root's membership just above that t;
//   - audit mode (kLists): the whole tape's postfix ops (never the
//     clusters, as in JAX) run as a stack machine over interval lists. A
//     PUSH makes a one-slot list of the leaf interval clipped to
//     [0, kTFar] (an empty one becomes (kTFar, kTFar)); a combine of lists
//     of widths ka and kb gives exactly k_out = min(ka + kb, k) slots. Its
//     events are 0 and the operands' interleaved endpoints, which are
//     presorted, merged in order by two pointers (the values the Pallas
//     Batcher network routes); insideness at each midpoint (the last one at
//     e + 1) is (in <= m) & (m < out) OR-ed over the slots; starts and ends
//     of the result are compacted by rank into k_out slots, kTFar past the
//     end. A capped combine (ka + kb > k_out) adds max(#starts below kCut -
//     k_out, 0) to the segment's dropped-span count, which is summed per
//     pixel into out_over. The hit is min(first enter, first exit) among
//     boundaries in (kEps, kCut), entering iff the enter is not later;
//   - attribution: the leaf whose surface lies nearest the hit point (the
//     first minimum in leaf order) gives normal and material;
//   - RTIOW shading with `entering` as the dielectric's front face, PCG4D
//     counters keyed by (pixel, sample, bounce, seed), per-pixel radiance
//     over spp and the traced-segment count (path_common.cuh);
//   - NEE: the lamps are the tape's emissive sphere leaves, given as leaf
//     ids and read (position, |radius|, albedo) from the leaf table in
//     shared memory, so a re-baked tape moves them. At every Lambertian or
//     glossy hit one lamp is cone-sampled; its shadow ray is the same flip
//     search without attribution (JAX's occlusion_t, in both modes),
//     stopped at the first flip below tl * (1 - 1e-4). Lamp emission found
//     by a pairable scatter carries the partner weight of the lamp nearest
//     the hit point by |dist - r| over the lamp table
//     (bsdf_mis_scale_table_planes). Shadow rays are not counted as
//     segments.
// A thread renders a pixel, looping over samples and bounces. The tape is
// data, not code: the leaf table, leaf types, op tables, cluster table,
// lamp ids, the audit's list ops and the cluster tree are one block of
// tables that each CTA stages in shared memory and interprets at run
// time, so a new tape or a new clustering costs no build. Membership below
// and above a candidate boundary is walked through the cluster's postfix
// ops with two bit stacks (one uint64 each: stack depth <= 64).
//
// What bounds it on an H100: FP32 ALU work, O(sum L_c^2) for the flip
// walks (two candidates per leaf, each a walk over the cluster's ops) and
// O(L) for the attribution at every hit (through the cluster tree: the
// clusters a ray reaches and the leaves near its hit), plus warp
// divergence (threads of a warp differ in bounce count, material and which
// candidates they can skip). The audit mode adds O(k^2) per combine (every
// midpoint tested against every slot of both operands) and keeps its list stack
// (kMaxStack x kMaxK pairs) and event buffer in per-thread local memory:
// it is a correctness audit, slower than event-flip mode by design. What
// the design does:
//   - persistent CTAs (persistent.cuh): a CTA stages the tables once (one
//     bulk TMA copy on an mbarrier; deepcsg's whole block is 736 bytes),
//     then each warp takes 16x2-pixel work units from a per-launch
//     counter, where a one-thread-per-pixel grid staged them in every
//     16x8 block (16,200 times a 1080p frame) behind a barrier;
//   - a register budget per mode (kFlipMinCtas ...): persistent, the
//     kernels took twice the registers the block-per-tile kernel did, and
//     an SM held five CTAs where it held twelve;
//   - the NEE kernels run the flip search's loops rolled (they hold two
//     searches, the path's and the shadow ray's); the event flip runs them
//     as the compiler unrolls them;
//   - a ray's leaf intervals are held for one cluster at a time, in
//     per-thread arrays of kCap slots, the launcher picking the smallest
//     of 8, 32 and 256 that holds the tape's largest cluster (the bench
//     tapes' clusters hold 2-9 leaves): the stack frame of the event flip
//     is 96 bytes where one size of 256 slots made it 2,080 (measured
//     neither faster nor slower; slots in shared memory, [slot][thread],
//     were slower on the event flip);
//   - the cluster tree (tape_kernel_tree, the event flip without NEE on a
//     tape the packer gave a tree: 16 or more bounded clusters). A walk
//     over every cluster and an attribution over every leaf cost O(L) a
//     segment whether a ray passes next to a solid or far from it, so the
//     packer builds a binary tree of padded world boxes over the bounded
//     clusters (kernels/tape_kernel.py: ClusterTree) and the kernel
//     consults it twice. The flip search evaluates the unbounded clusters
//     (a half-space's) first, then walks the tree front to back, entering
//     a node only if its slab entry lies below the best flip so far; a
//     candidate is taken if nearer, or as near and from an earlier
//     cluster, so the flip is the flat loop's whatever order the clusters
//     come in. The attribution scores the unbounded clusters' leaves and
//     those of every cluster whose box holds the hit point, the first
//     minimum in leaf order; a leaf scores at least its distance to its
//     box, so one left out scores above the pad and cannot be the owner
//     when the best score lies below half the pad (else every leaf is
//     scored, as the flat loop does). A lane's walk runs to its next leaf
//     node before the cluster is evaluated, so the lanes of a warp
//     evaluate their clusters together (10% faster than each at its own
//     step). A tape with fewer bounded clusters runs the flat loops (the
//     threshold is conservative: the tree already wins at 8, PERF.md).
//
// Every launch counts the leaf intervals its path segments compute (the
// event flip's, cluster by cluster; the audit's, one a PUSH) into one
// int64 word: each pixel's count in a register, summed over the warp's
// lanes and added by one atomic (csgr::add_count). The tree kernel counts
// the attribution's leaf scores into a second word. Shadow rays'
// intervals are not counted, as shadow rays are not counted in the
// segments.
//
// Stats mode (kStats, the event flip without NEE at cap 8, flat or through
// the tree: the deepcsg and manyobjects cells' instantiations): the same
// image and counts, and per launch a block of work counts (persistent.cuh):
// the bounce loop's warp turns and, through the tree, the node loop's turns
// by warp and by lane (the flat flip has no walk). The launcher runs it
// where out_stats is not null; the other launches compile as if it were not
// there.
//
// Numerics: the kernel repeats, operation for operation, the float
// arithmetic of its plain torch version (kernels/tape_kernel.py:
// render_image_tape_plain), and is built with -fmad=false and without fast
// math. A candidate boundary is a stored enter/exit value, compared with
// the stored values of every leaf, so the owning leaf's own membership at
// its boundary rests on exact < versus <= between equal floats. The
// half-space's -on/dn (inf or NaN when parallel) and the zero-direction
// slabs are replaced by selects, never used in arithmetic. The audit
// mode's clip keeps a NaN (as torch.clamp and jnp.clip do), and the
// NaN then fails the validity test.

#include <cuda_runtime.h>
#include <stdint.h>

#include "path_common.cuh"
#include "persistent.cuh"

// The CTA's dynamic shared memory (smem_tables, persistent.cuh) holds the
// staged tables as one block: the [L, 16] f32 leaf table, then the int32
// leaf types, cluster ops, cluster leaf ids, [C, 4] cluster table, lamp ids,
// (audit) list ops, and (tree) the [M, 8] tree nodes and the unbounded
// clusters' ids, each at the byte offset the packer gave it.

namespace {

constexpr int kMaxLeaves = 256;  // leaves of a tape: the largest interval-array cap
constexpr int kMaxStack = 64;    // bits of one membership stack; lists on the audit stack
constexpr int kMaxK = 16;        // audit mode: slots of one interval list (the tape's k)
constexpr int kLeafRow = 16;     // rot(4) pos(3) params(4) kind param albedo(3)
constexpr float kTFar = 1e9f;    // "no boundary"
constexpr float kCut = 5e8f;     // boundaries at or past this are not surfaces
constexpr float kEps = 1e-3f;    // hit epsilon along t
constexpr int kThreads = 128;    // a CTA: four warps
constexpr int kTreeStack = 16;   // the tree walks' stacks: the packer's trees are shallower
constexpr float kFlatDir = 1e-20f;  // |d| below this: the ray runs along a box's slab
// CTAs per SM the register budget allows, per mode (measured, PERF.md):
// the event flip 80 registers, with NEE 64, the audit 64, the audit with
// NEE 64, the event flip through the cluster tree 64 (at 80, 4% slower).
constexpr int kFlipMinCtas = 6, kFlipNeeMinCtas = 8, kAuditMinCtas = 8, kAuditNeeMinCtas = 8;
constexpr int kTreeMinCtas = 8;

template <bool kNee, bool kLists>
constexpr int kMinCtas = kLists ? (kNee ? kAuditNeeMinCtas : kAuditMinCtas)
                                : (kNee ? kFlipNeeMinCtas : kFlipMinCtas);

enum LeafType { kSphere = 0, kPlane = 1, kBox = 2, kCylinder = 3 };
enum OpCode { kPush = 0, kUnion = 1, kIntersect = 2, kDiff = 3 };

struct Params {
  const float* cam;        // [24]
  const unsigned char* tables;  // the staged block in global memory (layout above)
  int table_bytes;
  int type_at, ops_at, ids_at, cl_at, lamp_at, list_at;  // byte offsets in the tables
  int n_leaves;            // leaf table [L, 16] f32, the JAX leaf-table layout; types [L]
  int n_ops;               // cluster ops [n_ops]: opcode | (cluster-local leaf slot << 2)
  int n_clusters;          // [C, 4]: op offset, op count, leaf offset, leaf count
  int n_lamps;             // lamp ids [n_lamps]: the emissive sphere leaves (NEE)
  int n_list_ops;          // audit mode: [n_list_ops] the whole tape, opcode | (leaf << 2)
  int k;                   // audit mode: the tape's interval-list capacity
  int width, height, spp, max_bounces;
  int rows, row_offset;  // the slab rendered: rows [row_offset, row_offset + rows)
  uint32_t seed, sample_offset;
  int lens, sky;           // sky: 0 rtiow, 1 wololo, 2 black
  float* out_rgb;          // [rows, W, 3]
  int* out_rays;           // [rows, W]
  int* out_over;           // audit mode: [rows, W] dropped spans over the pixel's segments
  int* work;               // the work-unit counter, zeroed before each launch
  unsigned long long* out_tests;  // [2]: the launch's path-segment leaf intervals and (tree)
                                  // the attribution's leaf scores, zeroed before it
};

// The tree kernel's parameters: the others' and the cluster tree's (the
// others take Params alone, so their code stays as it was).
struct TreeParams : Params {
  int node_at, free_at;  // byte offsets of the nodes and the unbounded clusters' ids
  int n_free;            // the clusters holding an unbounded leaf
  float score_bound;     // half the boxes' pad: a best score below it stands
};

// v rotated by unit quaternion q: v + w t + u x t, t = 2 u x v
// (tape_kernel._rotate_scal, math/quaternion.rotate).
__device__ __forceinline__ void rotate(float qw, float qx, float qy, float qz, float vx,
                                       float vy, float vz, float& rx, float& ry, float& rz) {
  const float tx = 2.0f * (qy * vz - qz * vy);
  const float ty = 2.0f * (qz * vx - qx * vz);
  const float tz = 2.0f * (qx * vy - qy * vx);
  rx = vx + qw * tx + (qy * tz - qz * ty);
  ry = vy + qw * ty + (qz * tx - qx * tz);
  rz = vz + qw * tz + (qx * ty - qy * tx);
}

// One slab of the box or the cylinder's y extent, with the zero-direction
// case selected (never computed from inf).
__device__ __forceinline__ void slab(float lo, float ld, float he, bool divide, float& t_lo,
                                     float& t_hi) {
  const bool flat = ld == 0.0f;
  const float safe = flat ? 1.0f : ld;
  float ta, tb;
  if (divide) {  // the cylinder's cap slab divides
    ta = (-he - lo) / safe;
    tb = (he - lo) / safe;
  } else {  // the box's slabs multiply by the reciprocal
    const float inv = 1.0f / safe;
    ta = (-he - lo) * inv;
    tb = (he - lo) * inv;
  }
  t_lo = fminf(ta, tb);
  t_hi = fmaxf(ta, tb);
  if (flat) {
    const bool inside = fabsf(lo) <= he;
    t_lo = inside ? -kTFar : kTFar;
    t_hi = inside ? kTFar : -kTFar;
  }
}

// (enter, exit) of one leaf along the world ray; empty when enter > exit
// (tape_kernel._leaf_interval, render/intersect.py interval functions).
__device__ __forceinline__ void leaf_interval(const float* c, int type, float ox, float oy,
                                              float oz, float dx, float dy, float dz,
                                              float& enter, float& exit_) {
  const float qw = c[0], qx = c[1], qy = c[2], qz = c[3];
  float lox, loy, loz, ldx, ldy, ldz;
  rotate(qw, qx, qy, qz, ox - c[4], oy - c[5], oz - c[6], lox, loy, loz);
  rotate(qw, qx, qy, qz, dx, dy, dz, ldx, ldy, ldz);
  const float p0 = c[7], p1 = c[8], p2 = c[9];
  if (type == kSphere) {
    const float a = ldx * ldx + ldy * ldy + ldz * ldz;
    const float hb = lox * ldx + loy * ldy + loz * ldz;
    const float cc = (lox * lox + loy * loy + loz * loz) - p0 * p0;
    const float disc = hb * hb - a * cc;
    const bool ok = disc >= 0.0f;
    const float sq = sqrtf(fmaxf(disc, 0.0f));
    const float inv_a = 1.0f / a;
    enter = ok ? (-hb - sq) * inv_a : kTFar;
    exit_ = ok ? (-hb + sq) * inv_a : -kTFar;
  } else if (type == kPlane) {
    const float dn = ldx * p0 + ldy * p1 + ldz * p2;
    const float on = lox * p0 + loy * p1 + loz * p2;
    const float t0 = -on / dn;  // inf or NaN when parallel: selected away below
    const bool entering = dn < 0.0f;
    enter = entering ? t0 : -kTFar;
    exit_ = entering ? kTFar : t0;
    if (dn == 0.0f) {
      const bool inside = on <= 0.0f;
      enter = inside ? -kTFar : kTFar;
      exit_ = inside ? kTFar : -kTFar;
    }
  } else if (type == kBox) {
    float lo, hi;
    slab(lox, ldx, p0, false, enter, exit_);
    slab(loy, ldy, p1, false, lo, hi);
    enter = fmaxf(enter, lo);
    exit_ = fminf(exit_, hi);
    slab(loz, ldz, p2, false, lo, hi);
    enter = fmaxf(enter, lo);
    exit_ = fminf(exit_, hi);
  } else {  // kCylinder around local +y: radius p0, half height p1
    const float a = ldx * ldx + ldz * ldz;
    const float hb = lox * ldx + loz * ldz;
    const float cc = lox * lox + loz * loz - p0 * p0;
    const float disc = hb * hb - a * cc;
    const bool ok = disc >= 0.0f;
    const float sq = sqrtf(fmaxf(disc, 0.0f));
    const bool degen = a == 0.0f;  // parallel to the axis
    const float inv_a = 1.0f / (degen ? 1.0f : a);
    float s_enter = ok ? (-hb - sq) * inv_a : kTFar;
    float s_exit = ok ? (-hb + sq) * inv_a : -kTFar;
    if (degen) {
      const bool in_tube = cc <= 0.0f;
      s_enter = in_tube ? -kTFar : kTFar;
      s_exit = in_tube ? kTFar : -kTFar;
    }
    float c_lo, c_hi;
    slab(loy, ldy, p1, true, c_lo, c_hi);
    enter = fmaxf(s_enter, c_lo);
    exit_ = fminf(s_exit, c_hi);
  }
}

// Distance score and local outward normal of one leaf at local point l
// (the attribution of tape_kernel.tape_hit).
__device__ __forceinline__ float leaf_score(const float* c, int type, float lx, float ly,
                                            float lz, float& nx, float& ny, float& nz) {
  const float p0 = c[7], p1 = c[8], p2 = c[9];
  if (type == kSphere) {
    const float rad = sqrtf(lx * lx + ly * ly + lz * lz);
    const float inv = 1.0f / fmaxf(rad, 1e-12f);
    nx = lx * inv; ny = ly * inv; nz = lz * inv;
    return fabsf(rad - p0);
  }
  if (type == kPlane) {
    nx = p0; ny = p1; nz = p2;
    return fabsf(lx * p0 + ly * p1 + lz * p2);
  }
  if (type == kBox) {
    const float gx = p0 - fabsf(lx), gy = p1 - fabsf(ly), gz = p2 - fabsf(lz);
    const float mx = fmaxf(-gx, 0.0f), my = fmaxf(-gy, 0.0f), mz = fmaxf(-gz, 0.0f);
    const float outside = sqrtf(mx * mx + my * my + mz * mz);
    const float inside = fminf(fmaxf(-gx, fmaxf(-gy, -gz)), 0.0f);
    // outward normal: the axis with the smallest gap
    const bool is_x = fabsf(gx) <= fabsf(gy) && fabsf(gx) <= fabsf(gz);
    const bool is_y = !is_x && fabsf(gy) <= fabsf(gz);
    nx = is_x ? (lx >= 0.0f ? 1.0f : -1.0f) : 0.0f;
    ny = is_y ? (ly >= 0.0f ? 1.0f : -1.0f) : 0.0f;
    nz = (is_x || is_y) ? 0.0f : (lz >= 0.0f ? 1.0f : -1.0f);
    return outside - inside;
  }
  // cylinder
  const float srad = sqrtf(lx * lx + lz * lz);
  const float side = fabsf(srad - p0);
  const float cap = fabsf(fabsf(ly) - p1);
  const float sqr = srad - p0;
  const float sqy = fabsf(ly) - p1;
  const float mr = fmaxf(sqr, 0.0f), mh = fmaxf(sqy, 0.0f);
  const float outside = sqrtf(mr * mr + mh * mh);
  const float inside = fminf(fmaxf(sqr, sqy), 0.0f);
  const float inv = 1.0f / fmaxf(srad, 1e-12f);
  const bool use_side = side < cap;
  nx = use_side ? lx * inv : 0.0f;
  ny = use_side ? 0.0f : (ly >= 0.0f ? 1.0f : -1.0f);
  nz = use_side ? lz * inv : 0.0f;
  return outside - inside;
}

// x clipped to [0, kTFar], a NaN kept (torch.clamp, jnp.clip).
__device__ __forceinline__ float clip_t(float x) {
  return x < 0.0f ? 0.0f : (x > kTFar ? kTFar : x);
}

// Inside the interval list (in, out)[0, k) at m: (in <= m) & (m < out) over the slots.
__device__ __forceinline__ bool list_inside(const float* in, const float* out, int k, float m) {
  bool inside = false;
  for (int s = 0; s < k; ++s) inside |= in[s] <= m && m < out[s];
  return inside;
}

// One combine of two interval lists a (width ka) and b (width kb) into
// r (width k_out = min(ka + kb, k)); returns the spans it dropped
// (tape_kernel._combine with count_dropped). ev holds 2 (ka + kb) + 1 floats.
__device__ int combine_lists(const float* a_in, const float* a_out, int ka, const float* b_in,
                             const float* b_out, int kb, int opc, int k_out, float* r_in,
                             float* r_out, float* ev) {
  // events: 0, then the interleaved endpoints of a and b (each sorted) merged
  const int na = 2 * ka, nb = 2 * kb, n = na + nb + 1;
  ev[0] = 0.0f;
  for (int i = 0, j = 0, e = 1; e < n; ++e) {
    const float va = i < na ? ((i & 1) ? a_out[i >> 1] : a_in[i >> 1]) : 0.0f;
    const float vb = j < nb ? ((j & 1) ? b_out[j >> 1] : b_in[j >> 1]) : 0.0f;
    if (j >= nb || (i < na && va <= vb)) {
      ev[e] = va;
      ++i;
    } else {
      ev[e] = vb;
      ++j;
    }
  }
  bool prev = false;
  int n_start = 0, n_end = 0, n_real = 0;
  for (int j = 0; j < n; ++j) {
    const float m = j < n - 1 ? 0.5f * (ev[j] + ev[j + 1]) : ev[j] + 1.0f;
    const bool ia = list_inside(a_in, a_out, ka, m);
    const bool ib = list_inside(b_in, b_out, kb, m);
    const bool res = opc == kUnion ? (ia || ib) : (opc == kIntersect ? (ia && ib) : (ia && !ib));
    if (res && !prev) {  // a start: compacted by rank
      n_real += ev[j] < kCut;
      if (n_start < k_out) r_in[n_start] = ev[j];
      ++n_start;
    } else if (!res && prev) {  // an end
      if (n_end < k_out) r_out[n_end] = ev[j];
      ++n_end;
    }
    prev = res;
  }
  for (int s = n_start; s < k_out; ++s) r_in[s] = kTFar;
  for (int s = n_end; s < k_out; ++s) r_out[s] = kTFar;
  return ka + kb > k_out ? max(n_real - k_out, 0) : 0;
}

// The tables staged in shared memory.
struct Tables {
  const float* leaf;
  const int* type;
  const int* ops;
  const int* ids;
  const int* cl;
  const int* lamp;      // NEE
  const int* list_ops;  // audit mode
};

__device__ __forceinline__ Tables staged_tables(const Params& p) {
  const unsigned char* b = smem_tables;
  return Tables{reinterpret_cast<const float*>(b), reinterpret_cast<const int*>(b + p.type_at),
                reinterpret_cast<const int*>(b + p.ops_at),
                reinterpret_cast<const int*>(b + p.ids_at),
                reinterpret_cast<const int*>(b + p.cl_at),
                reinterpret_cast<const int*>(b + p.lamp_at),
                reinterpret_cast<const int*>(b + p.list_at)};
}

// One postfix op of a cluster, walked for membership just below and just
// above a candidate boundary tj: two bit stacks, top at bit 0. A PUSH's
// leaf is inside below tj iff enter < tj <= exit, above iff enter <= tj < exit.
__device__ __forceinline__ void op_step(int code, const float* enter, const float* exit_,
                                        float tj, uint64_t& below, uint64_t& above) {
  const int opc = code & 3;
  if (opc == kPush) {
    const float e = enter[code >> 2], xt = exit_[code >> 2];
    below = (below << 1) | static_cast<uint64_t>(e < tj && xt >= tj);
    above = (above << 1) | static_cast<uint64_t>(e <= tj && xt > tj);
  } else {
    const uint64_t rb = below & 1ull, ra = above & 1ull;
    below >>= 1;
    above >>= 1;
    const uint64_t lb = below & 1ull, la = above & 1ull;
    uint64_t vb, va;
    if (opc == kUnion) {
      vb = lb | rb; va = la | ra;
    } else if (opc == kIntersect) {
      vb = lb & rb; va = la & ra;
    } else {  // kDiff
      vb = lb & (rb ^ 1ull); va = la & (ra ^ 1ull);
    }
    below = (below & ~1ull) | vb;
    above = (above & ~1ull) | va;
  }
}

// Candidate boundary tj of a cluster (ops [op_off, op_off + op_n)): if the
// root flips there and tj is nearer than t (strict <), t becomes tj and
// `entering` the root's membership just above it; returns whether it did.
template <bool kRolled>
__device__ __forceinline__ bool candidate(const Tables& tb, int op_off, int op_n,
                                          const float* enter, const float* exit_, float tj,
                                          float& t, bool& entering) {
  // only a flip nearer than the best so far can be taken (strict <)
  if (!(tj > kEps && tj < kCut && tj < t)) return false;
  uint64_t below = 0, above = 0;
  if constexpr (kRolled) {
#pragma unroll 1
    for (int i = 0; i < op_n; ++i) op_step(tb.ops[op_off + i], enter, exit_, tj, below, above);
  } else {
    for (int i = 0; i < op_n; ++i) op_step(tb.ops[op_off + i], enter, exit_, tj, below, above);
  }
  if (!((below ^ above) & 1ull)) return false;
  t = tj;
  entering = (above & 1ull) != 0;
  return true;
}

// The nearest flip of the root's membership along (o, d), cluster by
// cluster: the smallest candidate boundary tj with kEps < tj < kCut and
// tj < t (t comes in as the bound: kTFar for a path ray), and `entering`,
// the root's membership just above it. kAnyHit returns at the first flip
// below the bound (a shadow ray needs no nearest one, nor attribution);
// else the intervals it computes (each cluster's leaves) are added to
// ``tests``. enter / exit_ are the caller's per-thread interval arrays.
// kRolled runs the loops rolled, as the NEE kernels do (they hold two
// searches, the path's and the shadow ray's; unrolled they ran 26-28%
// slower), else as the compiler unrolls them (rolled, the event flip's
// deepcsg frame ran 3-8% slower; unrolled four times, 10-15%).
template <bool kAnyHit, bool kRolled>
__device__ __forceinline__ float nearest_flip(const Params& p, const Tables& tb, float ox,
                                              float oy, float oz, float dx, float dy, float dz,
                                              float t, bool& entering, float* enter,
                                              float* exit_, unsigned& tests) {
  for (int c = 0; c < p.n_clusters; ++c) {
    const int op_off = tb.cl[4 * c], op_n = tb.cl[4 * c + 1];
    const int id_off = tb.cl[4 * c + 2], id_n = tb.cl[4 * c + 3];
    if constexpr (!kAnyHit) tests += static_cast<unsigned>(id_n);
    const auto interval = [&](int j) {
      const int leaf = tb.ids[id_off + j];
      leaf_interval(tb.leaf + kLeafRow * leaf, tb.type[leaf], ox, oy, oz, dx, dy, dz, enter[j],
                    exit_[j]);
    };
    const auto flip = [&](int cand) {
      const float tj = (cand & 1) ? exit_[cand >> 1] : enter[cand >> 1];
      return candidate<kRolled>(tb, op_off, op_n, enter, exit_, tj, t, entering);
    };
    if constexpr (kRolled) {
#pragma unroll 1
      for (int j = 0; j < id_n; ++j) interval(j);
#pragma unroll 1
      for (int cand = 0; cand < 2 * id_n; ++cand) {
        if (flip(cand) && kAnyHit) return t;
      }
    } else {
      for (int j = 0; j < id_n; ++j) interval(j);
      for (int cand = 0; cand < 2 * id_n; ++cand) {
        if (flip(cand) && kAnyHit) return t;
      }
    }
  }
  return t;
}

// The audit mode's nearest surface along (o, d): the whole tape's postfix
// ops over interval lists (tape_kernel.tape_hit_lists). Returns t (kTFar
// where there is none) and sets `entering` and `dropped`, the spans the
// k-slot capacity cut away; the leaf intervals it computes (one a PUSH)
// are added to ``tests``.
__device__ float list_hit(const Params& p, const Tables& tb, float ox, float oy, float oz,
                          float dx, float dy, float dz, bool& entering, int& dropped,
                          unsigned& tests) {
  float l_in[kMaxStack * kMaxK], l_out[kMaxStack * kMaxK];  // the stack of lists
  int width[kMaxStack];
  float r_in[kMaxK], r_out[kMaxK], ev[4 * kMaxK + 1];
  int sp = 0;
  dropped = 0;
  for (int i = 0; i < p.n_list_ops; ++i) {
    const int code = tb.list_ops[i];
    const int opc = code & 3;
    if (opc == kPush) {
      const int leaf = code >> 2;
      float enter, exit_;
      ++tests;
      leaf_interval(tb.leaf + kLeafRow * leaf, tb.type[leaf], ox, oy, oz, dx, dy, dz, enter,
                    exit_);
      const float enter_c = clip_t(enter), exit_c = clip_t(exit_);
      const bool valid = enter_c < exit_c;
      l_in[sp * kMaxK] = valid ? enter_c : kTFar;
      l_out[sp * kMaxK] = valid ? exit_c : kTFar;
      width[sp] = 1;
      ++sp;
      continue;
    }
    float* a_in = l_in + (sp - 2) * kMaxK;
    float* a_out = l_out + (sp - 2) * kMaxK;
    const int ka = width[sp - 2], kb = width[sp - 1];
    const int k_out = min(ka + kb, p.k);
    dropped += combine_lists(a_in, a_out, ka, l_in + (sp - 1) * kMaxK, l_out + (sp - 1) * kMaxK,
                             kb, opc, k_out, r_in, r_out, ev);
    for (int s = 0; s < k_out; ++s) {
      a_in[s] = r_in[s];
      a_out[s] = r_out[s];
    }
    width[sp - 2] = k_out;
    --sp;
  }
  float t_enter = kTFar, t_exit = kTFar;
  for (int s = 0; s < width[0]; ++s) {
    const float tin = l_in[s], tout = l_out[s];
    t_enter = fminf(t_enter, (tin > kEps && tin < kCut) ? tin : kTFar);
    t_exit = fminf(t_exit, (tout > kEps && tout < kCut) ? tout : kTFar);
  }
  entering = t_enter <= t_exit;
  return fminf(t_enter, t_exit);
}

// The cluster tree in shared memory: node i is two float4, (lo, link0)
// and (hi, link1), the link words' int32 bits. An inner node's link0 is its
// left child and link1 its right child << 2 | the split axis; a leaf's
// link0 is ~cluster. Node 0 is the root.
struct Tree {
  const float4* nodes;
  const int* free;  // the clusters holding an unbounded leaf, in cluster order
};

__device__ __forceinline__ Tree staged_tree(const TreeParams& p) {
  return Tree{reinterpret_cast<const float4*>(smem_tables + p.node_at),
              reinterpret_cast<const int*>(smem_tables + p.free_at)};
}

// One slab of a node's box along the ray: [lo, hi] against o + t d, with
// inv = 1/d, or a flat axis (|d| < kFlatDir) inside or outside the slab.
__device__ __forceinline__ void box_slab(float lo, float hi, float o, float inv, bool flat,
                                         float& tn, float& tf) {
  const float ta = (lo - o) * inv, tb = (hi - o) * inv;
  float n = fminf(ta, tb), f = fmaxf(ta, tb);
  if (flat) {
    const bool inside = lo <= o && o <= hi;
    n = inside ? -kTFar : kTFar;
    f = inside ? kTFar : -kTFar;
  }
  tn = fmaxf(tn, n);
  tf = fminf(tf, f);
}

// Cluster c's candidates against the best flip so far, t from cluster tc:
// a candidate is taken if nearer, or as near and from an earlier cluster
// (within one cluster strict <, as candidate()), so the walk's flip is the
// flat loop's in whatever order the clusters come. The cluster's leaf
// intervals are added to ``tests``.
__device__ __forceinline__ void tree_cluster(const Tables& tb, int c, float ox, float oy,
                                             float oz, float dx, float dy, float dz, float& t,
                                             int& tc, bool& entering, float* enter, float* exit_,
                                             unsigned& tests) {
  const int op_off = tb.cl[4 * c], op_n = tb.cl[4 * c + 1];
  const int id_off = tb.cl[4 * c + 2], id_n = tb.cl[4 * c + 3];
  tests += static_cast<unsigned>(id_n);
  for (int j = 0; j < id_n; ++j) {
    const int leaf = tb.ids[id_off + j];
    leaf_interval(tb.leaf + kLeafRow * leaf, tb.type[leaf], ox, oy, oz, dx, dy, dz, enter[j],
                  exit_[j]);
  }
  for (int cand = 0; cand < 2 * id_n; ++cand) {
    const float tj = (cand & 1) ? exit_[cand >> 1] : enter[cand >> 1];
    if (!(tj > kEps && tj < kCut && (tj < t || (tj == t && c < tc)))) continue;
    uint64_t below = 0, above = 0;
    for (int i = 0; i < op_n; ++i) op_step(tb.ops[op_off + i], enter, exit_, tj, below, above);
    if (!((below ^ above) & 1ull)) continue;
    t = tj;
    tc = c;
    entering = (above & 1ull) != 0;
  }
}

// The nearest flip of a path ray through the cluster tree: the unbounded
// clusters, then the tree front to back (the child on the ray's side of
// the split first), a node entered only if its box's slab entry lies below
// the best flip so far and its exit at or past kEps. The same t and
// `entering` as nearest_flip<false, false> over every cluster. A stats
// instantiation passes its lane's Stats, in which each node visit's turn is
// counted (csgr::walk_turn); the others pass none.
template <class... Stats>
__device__ __forceinline__ float tree_flip(const TreeParams& p, const Tables& tb, float ox,
                                           float oy, float oz, float dx, float dy, float dz,
                                           bool& entering, float* enter, float* exit_,
                                           unsigned& tests, Stats&... st) {
  const Tree tr = staged_tree(p);
  float t = kTFar;
  int tc = p.n_clusters;
  for (int u = 0; u < p.n_free; ++u) {
    tree_cluster(tb, tr.free[u], ox, oy, oz, dx, dy, dz, t, tc, entering, enter, exit_, tests);
  }
  const bool fx = fabsf(dx) < kFlatDir, fy = fabsf(dy) < kFlatDir, fz = fabsf(dz) < kFlatDir;
  const float ix = 1.0f / (fx ? 1.0f : dx), iy = 1.0f / (fy ? 1.0f : dy),
              iz = 1.0f / (fz ? 1.0f : dz);
  int stack[kTreeStack];
  int sp = 0;
  stack[sp++] = 0;
  for (;;) {
    // the walk to this lane's next cluster, then the cluster: the lanes of
    // a warp evaluate their clusters together, not each at its own step
    int c = -1;
    while (sp > 0) {
      if constexpr (sizeof...(Stats) > 0) csgr::walk_turn(st...);
      const int i = stack[--sp];
      const float4 lo = tr.nodes[2 * i], hi = tr.nodes[2 * i + 1];
      float tn = -kTFar, tf = kTFar;
      box_slab(lo.x, hi.x, ox, ix, fx, tn, tf);
      box_slab(lo.y, hi.y, oy, iy, fy, tn, tf);
      box_slab(lo.z, hi.z, oz, iz, fz, tn, tf);
      if (!(tn <= tf && tf >= kEps && tn < t)) continue;
      const int link0 = __float_as_int(lo.w), link1 = __float_as_int(hi.w);
      if (link0 < 0) {
        c = ~link0;
        break;
      }
      const int axis = link1 & 3;
      const bool back = (axis == 0 ? dx : (axis == 1 ? dy : dz)) < 0.0f;
      stack[sp++] = back ? link0 : link1 >> 2;  // the far child, taken after the near one
      stack[sp++] = back ? link1 >> 2 : link0;
    }
    if (c < 0) return t;
    tree_cluster(tb, c, ox, oy, oz, dx, dy, dz, t, tc, entering, enter, exit_, tests);
  }
}

// Leaf l's score at the hit point h and its outward normal in the world,
// taken if the score is below best, or equal with a lower leaf index: the
// first minimum in leaf order, in whatever order the leaves come.
__device__ __forceinline__ void score_leaf(const Tables& tb, int l, float hx, float hy,
                                           float hz, float& best, int& owner, float& nwx,
                                           float& nwy, float& nwz) {
  const float* c = tb.leaf + kLeafRow * l;
  const float qw = c[0], qx = c[1], qy = c[2], qz = c[3];
  float lx, ly, lz, nlx, nly, nlz;
  rotate(qw, qx, qy, qz, hx - c[4], hy - c[5], hz - c[6], lx, ly, lz);
  const float score = leaf_score(c, tb.type[l], lx, ly, lz, nlx, nly, nlz);
  if (score < best || (score == best && l < owner)) {
    best = score;
    owner = l;
    rotate(qw, -qx, -qy, -qz, nlx, nly, nlz, nwx, nwy, nwz);  // local -> world
  }
}

// The attribution through the cluster tree: the leaves of the unbounded
// clusters and of every cluster whose box holds h. A leaf left out lies
// more than the pad from h, and scores so; if the best score is not below
// half the pad, every leaf is scored. Sets the owner and its world normal
// (those of the loop over every leaf) and returns the leaves scored.
__device__ __forceinline__ unsigned tree_owner(const TreeParams& p, const Tables& tb, float hx,
                                               float hy, float hz, int& owner, float& nwx,
                                               float& nwy, float& nwz) {
  const Tree tr = staged_tree(p);
  float best = INFINITY;
  unsigned scores = 0;
  const auto cluster = [&](int c) {
    const int id_off = tb.cl[4 * c + 2], id_n = tb.cl[4 * c + 3];
    scores += static_cast<unsigned>(id_n);
    for (int j = 0; j < id_n; ++j) {
      score_leaf(tb, tb.ids[id_off + j], hx, hy, hz, best, owner, nwx, nwy, nwz);
    }
  };
  for (int u = 0; u < p.n_free; ++u) cluster(tr.free[u]);
  int stack[kTreeStack];
  int sp = 0;
  stack[sp++] = 0;
  while (sp > 0) {
    const int i = stack[--sp];
    const float4 lo = tr.nodes[2 * i], hi = tr.nodes[2 * i + 1];
    if (!(lo.x <= hx && hx <= hi.x && lo.y <= hy && hy <= hi.y && lo.z <= hz && hz <= hi.z)) {
      continue;
    }
    const int link0 = __float_as_int(lo.w), link1 = __float_as_int(hi.w);
    if (link0 < 0) {
      cluster(~link0);
      continue;
    }
    stack[sp++] = link1 >> 2;
    stack[sp++] = link0;
  }
  if (!(best < p.score_bound)) {  // no leaf near enough: score them all
    best = INFINITY;
    scores += static_cast<unsigned>(p.n_leaves);
    for (int l = 0; l < p.n_leaves; ++l) score_leaf(tb, l, hx, hy, hz, best, owner, nwx, nwy, nwz);
  }
  return scores;
}

// One pixel's spp paths, one after another, each up to max_bounces
// segments; the radiance is summed in sample order. kCap: slots of the
// per-thread interval arrays (at least the largest cluster's leaves).
// Returns the leaf intervals of the pixel's path segments. ``st``: none,
// or a stats instantiation's lane Stats, which counts the segment loop's
// turns.
template <bool kNee, bool kLists, int kCap, class... Stats>
__device__ __forceinline__ unsigned render_pixel(const Params& p, const Tables& tb,
                                                 const float* cam, int x, int row,
                                                 Stats&... st) {
  const float* s_leaf = tb.leaf;
  const int* s_type = tb.type;
  const int* s_lamp = tb.lamp;
  const int y = row + p.row_offset;  // in the frame: camera and RNG keys are global
  const uint32_t pix = static_cast<uint32_t>(y) * static_cast<uint32_t>(p.width) + x;
  const size_t out_pix = static_cast<size_t>(row) * p.width + x;

  float enter[kCap], exit_[kCap];  // one cluster's leaves, by slot
  csgr::Path path;
  float acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f;
  int rays = 0, over = 0;
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

      bool entering = false;
      float t;
      if (kLists) {
        int dropped;
        t = list_hit(p, tb, ox, oy, oz, dx, dy, dz, entering, dropped, tests);
        over += dropped;
      } else {
        t = nearest_flip<false, kNee>(p, tb, ox, oy, oz, dx, dy, dz, kTFar, entering, enter,
                                      exit_, tests);
      }

      const float inv_len = csgr::inv_length(path);
      const float udx = dx * inv_len, udy = dy * inv_len, udz = dz * inv_len;
      if (!(t < kCut)) {  // miss: sky, path ends
        csgr::add_sky(path, p.sky, udy);
        break;
      }

      // attribution: the leaf whose surface is nearest the hit point
      const float hx = ox + t * dx, hy = oy + t * dy, hz = oz + t * dz;
      float best = 0.0f, nwx = 0.0f, nwy = 0.0f, nwz = 0.0f;
      int owner = 0;
      for (int l = 0; l < p.n_leaves; ++l) {
        const float* c = s_leaf + kLeafRow * l;
        const float qw = c[0], qx = c[1], qy = c[2], qz = c[3];
        float lx, ly, lz, nlx, nly, nlz;
        rotate(qw, qx, qy, qz, hx - c[4], hy - c[5], hz - c[6], lx, ly, lz);
        const float score = leaf_score(c, s_type[l], lx, ly, lz, nlx, nly, nlz);
        if (l == 0 || score < best) {
          best = score;
          owner = l;
          rotate(qw, -qx, -qy, -qz, nlx, nly, nlz, nwx, nwy, nwz);  // local -> world
        }
      }
      const float* w = s_leaf + kLeafRow * owner;
      // face-forward the leaf normal against the ray
      const float sgn = dx * nwx + dy * nwy + dz * nwz > 0.0f ? -1.0f : 1.0f;
      if (!kNee) {
        if (!csgr::shade(path, hx, hy, hz, nwx * sgn, nwy * sgn, nwz * sgn, entering,
                         static_cast<int>(w[11]), w[12], w[13], w[14], w[15], udx, udy, udz,
                         pix, s, static_cast<uint32_t>(bounce), p.seed)) {
          break;
        }
        continue;
      }

      const float nx = nwx * sgn, ny = nwy * sgn, nz = nwz * sgn;
      const int kind = static_cast<int>(w[11]);
      const float param = w[12];
      float emit_scale = 1.0f;
      if (kind == 4 && prev_pdf > 0.0f) {
        // the lamp holding the hit point: argmin |dist - r| (first minimum)
        const float* lamp = nullptr;
        float best_l = 0.0f;
        for (int l = 0; l < p.n_lamps; ++l) {
          const float* c = s_leaf + kLeafRow * s_lamp[l];
          const float ex = hx - c[4], ey = hy - c[5], ez = hz - c[6];
          const float score = fabsf(sqrtf(ex * ex + ey * ey + ez * ez) - fabsf(c[7]));
          if (l == 0 || score < best_l) {
            best_l = score;
            lamp = c;
          }
        }
        emit_scale = csgr::partner_weight(lamp[4], lamp[5], lamp[6], fabsf(lamp[7]), ox, oy, oz,
                                          prev_pdf, p.n_lamps);
      }
      const bool lambertian = kind == 1;
      const bool glossy = kind == 2 && param > csgr::kGlossyFuzz;
      if (lambertian || glossy) {
        float u1, u2;
        const int li = csgr::nee_pick(pix, s, static_cast<uint32_t>(bounce), p.seed, p.n_lamps,
                                      u1, u2);
        const float* c = s_leaf + kLeafRow * s_lamp[li];
        csgr::LampSample ls;
        if (csgr::nee_sample(hx, hy, hz, nx, ny, nz, lambertian, param, udx, udy, udz, w[13],
                             w[14], w[15], c[4], c[5], c[6], fabsf(c[7]), c[13], c[14], c[15],
                             p.n_lamps, u1, u2, ls)) {
          const float t_max = ls.tl * csgr::kShadowScale;
          bool unused;
          unsigned uncounted = 0;
          if (!(nearest_flip<true, kNee>(p, tb, hx, hy, hz, ls.dx, ls.dy, ls.dz, t_max, unused,
                                         enter, exit_, uncounted) < t_max)) {
            path.sr += path.tr * ls.wr;
            path.sg += path.tg * ls.wg;
            path.sb += path.tb * ls.wb;
          }
        }
      }
      if (!csgr::shade<true>(path, hx, hy, hz, nx, ny, nz, entering, kind, param, w[13], w[14],
                             w[15], udx, udy, udz, pix, s, static_cast<uint32_t>(bounce), p.seed,
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
  if (kLists) p.out_over[out_pix] = over;
  return tests;
}

// One pixel's spp paths through the cluster tree (the event flip without
// NEE): render_pixel's loop with tree_flip and tree_owner in place of the
// loops over every cluster and every leaf, the same operations otherwise.
// Returns the leaf intervals of the pixel's path segments and adds their
// leaf scores to ``scores``. ``st``: as tree_flip's, where a stats
// instantiation also counts the segment loop's turns.
template <int kCap, class... Stats>
__device__ __forceinline__ unsigned render_pixel_tree(const TreeParams& p, const Tables& tb,
                                                      const float* cam, int x, int row,
                                                      unsigned& scores, Stats&... st) {
  const int y = row + p.row_offset;  // in the frame: camera and RNG keys are global
  const uint32_t pix = static_cast<uint32_t>(y) * static_cast<uint32_t>(p.width) + x;
  const size_t out_pix = static_cast<size_t>(row) * p.width + x;

  float enter[kCap], exit_[kCap];  // one cluster's leaves, by slot
  csgr::Path path;
  float acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f;
  int rays = 0;
  unsigned tests = 0;
  for (int k = 0; k < p.spp; ++k) {
    const uint32_t s = static_cast<uint32_t>(k) + p.sample_offset;
    csgr::camera_ray(cam, x, y, pix, s, p.seed, p.width, p.height, p.lens, path);
    path.sr = 0.0f; path.sg = 0.0f; path.sb = 0.0f;
    for (int bounce = 0; bounce < p.max_bounces; ++bounce) {
      if constexpr (sizeof...(Stats) > 0) csgr::segment_turn(st...);
      ++rays;
      const float ox = path.ox, oy = path.oy, oz = path.oz;
      const float dx = path.dx, dy = path.dy, dz = path.dz;
      bool entering = false;
      const float t =
          tree_flip(p, tb, ox, oy, oz, dx, dy, dz, entering, enter, exit_, tests, st...);
      const float inv_len = csgr::inv_length(path);
      const float udx = dx * inv_len, udy = dy * inv_len, udz = dz * inv_len;
      if (!(t < kCut)) {  // miss: sky, path ends
        csgr::add_sky(path, p.sky, udy);
        break;
      }
      const float hx = ox + t * dx, hy = oy + t * dy, hz = oz + t * dz;
      float nwx = 0.0f, nwy = 0.0f, nwz = 0.0f;
      int owner = 0;
      scores += tree_owner(p, tb, hx, hy, hz, owner, nwx, nwy, nwz);
      const float* w = tb.leaf + kLeafRow * owner;
      // face-forward the leaf normal against the ray
      const float sgn = dx * nwx + dy * nwy + dz * nwz > 0.0f ? -1.0f : 1.0f;
      if (!csgr::shade(path, hx, hy, hz, nwx * sgn, nwy * sgn, nwz * sgn, entering,
                       static_cast<int>(w[11]), w[12], w[13], w[14], w[15], udx, udy, udz, pix,
                       s, static_cast<uint32_t>(bounce), p.seed)) {
        break;
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
  return tests;
}

// Persistent CTAs (persistent.cuh): a CTA stages the tables once, then each
// warp takes 16x2-pixel work units from the launch's counter and adds each
// pixel's leaf intervals to the launch's word; a stats launch (kStats: the
// event flip without NEE at cap 8) adds the unit's segment-loop turns to
// its block (it has no walk).
template <bool kNee, bool kLists, int kCap, bool kStats>
__global__ void __launch_bounds__(kThreads, (kMinCtas<kNee, kLists>))
    tape_kernel(const csgr::StatsParams<Params, kStats> p) {
  csgr::stage_tables<1>({p.tables}, {p.table_bytes});
  const Tables tb = staged_tables(p);
  float cam[csgr::kCamFloats];
#pragma unroll
  for (int i = 0; i < csgr::kCamFloats; ++i) cam[i] = __ldg(p.cam + i);
  csgr::for_each_pixel(p.work, p.width, p.rows, [&](int x, int row) {
    if constexpr (kStats) {
      csgr::Stats st;
      csgr::add_count(p.out_tests, render_pixel<kNee, kLists, kCap>(p, tb, cam, x, row, st));
      csgr::add_stats<1>(p.stats, st);
    } else {
      csgr::add_count(p.out_tests, render_pixel<kNee, kLists, kCap>(p, tb, cam, x, row));
    }
  });
}

// The event flip through the cluster tree: each pixel's leaf intervals to
// the launch's first word, its leaf scores to the second; a stats launch
// (kStats, at cap 8) adds the unit's stats to its block.
template <int kCap, bool kStats>
__global__ void __launch_bounds__(kThreads, kTreeMinCtas)
    tape_kernel_tree(const csgr::StatsParams<TreeParams, kStats> p) {
  csgr::stage_tables<1>({p.tables}, {p.table_bytes});
  const Tables tb = staged_tables(p);
  float cam[csgr::kCamFloats];
#pragma unroll
  for (int i = 0; i < csgr::kCamFloats; ++i) cam[i] = __ldg(p.cam + i);
  csgr::for_each_pixel(p.work, p.width, p.rows, [&](int x, int row) {
    unsigned scores = 0;
    if constexpr (kStats) {
      csgr::Stats st;
      csgr::add_count(p.out_tests, render_pixel_tree<kCap>(p, tb, cam, x, row, scores, st));
      csgr::add_count(p.out_tests + 1, scores);
      csgr::add_stats<3>(p.stats, st);
    } else {
      csgr::add_count(p.out_tests, render_pixel_tree<kCap>(p, tb, cam, x, row, scores));
      csgr::add_count(p.out_tests + 1, scores);
    }
  });
}

template <bool kNee, bool kLists, int kCap, bool kStats>
cudaError_t launch(const csgr::StatsParams<Params, kStats>& p, cudaStream_t st) {
  return csgr::launch_persistent(tape_kernel<kNee, kLists, kCap, kStats>, p, kThreads,
                                 p.table_bytes, p.width, p.rows, p.work, st);
}

cudaError_t launch_tree(const TreeParams& p, int cap, cudaStream_t st) {
  const auto kernel = cap == 8 ? tape_kernel_tree<8, false>
                               : (cap == 32 ? tape_kernel_tree<32, false>
                                            : tape_kernel_tree<kMaxLeaves, false>);
  return csgr::launch_persistent(kernel, p, kThreads, p.table_bytes, p.width, p.rows, p.work, st);
}

// The audit without NEE holds no cluster intervals: one small cap serves.
template <bool kNee, bool kLists>
cudaError_t launch_cap(const Params& p, int cap, cudaStream_t st) {
  if (kLists && !kNee) return launch<kNee, kLists, 8, false>(p, st);
  if (cap == 8) return launch<kNee, kLists, 8, false>(p, st);
  if (cap == 32) return launch<kNee, kLists, 32, false>(p, st);
  return launch<kNee, kLists, kMaxLeaves, false>(p, st);
}

}  // namespace

extern "C" int csgr_tape_max_leaves() { return kMaxLeaves; }

extern "C" int csgr_tape_max_stack() { return kMaxStack; }

extern "C" int csgr_tape_max_k() { return kMaxK; }

// tables: the leaf table [L, 16] f32, then int32 leaf types, cluster ops,
// cluster leaf ids, the [C, 4] cluster table, lamp ids, (audit) list ops,
// the [n_nodes, 8] tree nodes and the n_free unbounded clusters' ids at
// byte offsets type_at ... free_at; table_bytes long, 16-byte aligned, a
// multiple of 16. cap: the interval arrays' slots (8, 32 or 256), at least
// the largest cluster's leaves. list_at non-negative: the audit mode, which
// writes out_over. n_nodes positive: the tape has a cluster tree, which the
// event flip without NEE walks (score_bound: half the boxes' pad). out_rays
// holds rows x width int32 segment counts and one int32 more: the launch's
// work counter. out_tests is two uint64, which the launch zeroes and then
// fills with its path segments' leaf intervals and (tree) the
// attribution's leaf scores. out_stats: null, or (the event flip without
// NEE at cap 8, flat or through the tree) csgr::kStatsWords uint64 that the
// launch zeroes and fills through the stats instantiation (the segment word
// alone where it walks no tree).
extern "C" int csgr_tape_render(
    const void* cam, const void* tables, int table_bytes, int type_at, int ops_at, int ids_at,
    int cl_at, int lamp_at, int list_at, int node_at, int free_at, int n_leaves, int n_ops,
    int n_clusters, int n_lamps, int n_list_ops, int n_nodes, int n_free, int k, int cap,
    int width, int height, int rows, int row_offset, int spp, int max_bounces,
    unsigned int seed, unsigned int sample_offset, int lens, int sky, float score_bound,
    void* out_rgb, void* out_rays, void* out_over, void* out_tests, void* out_stats,
    void* stream) {
  const bool lists = list_at >= 0;
  const bool tree = n_nodes > 0 && !lists && n_lamps == 0;
  if (n_leaves < 1 || n_leaves > kMaxLeaves || n_clusters < 1 ||
      (n_nodes > 0 && (n_free < 0 || node_at % 16 != 0 || free_at < node_at + 32 * n_nodes)) ||
      (cap != 8 && cap != 32 && cap != kMaxLeaves) ||
      (lists && (k < 1 || k > kMaxK || n_list_ops < 1 || out_over == nullptr)) ||
      rows < 1 || row_offset < 0 || row_offset + rows > height || spp < 1 || max_bounces < 0 ||
      table_bytes % 16 != 0 || table_bytes < n_leaves * kLeafRow * 4 || out_tests == nullptr ||
      (out_stats != nullptr && (lists || n_lamps > 0 || cap != 8))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (reinterpret_cast<uintptr_t>(tables) % 16 != 0) {
    return static_cast<int>(cudaErrorMisalignedAddress);  // the bulk copy
  }
  csgr::WithStats<TreeParams> p;
  p.cam = static_cast<const float*>(cam);
  p.tables = static_cast<const unsigned char*>(tables);
  p.table_bytes = table_bytes;
  p.type_at = type_at; p.ops_at = ops_at; p.ids_at = ids_at; p.cl_at = cl_at;
  p.lamp_at = lamp_at; p.list_at = list_at;
  p.n_leaves = n_leaves;
  p.n_ops = n_ops;
  p.n_clusters = n_clusters;
  p.n_lamps = n_lamps;
  p.n_list_ops = lists ? n_list_ops : 0;
  p.k = k;
  p.width = width; p.height = height; p.spp = spp; p.max_bounces = max_bounces;
  p.rows = rows; p.row_offset = row_offset;
  p.seed = seed; p.sample_offset = sample_offset;
  p.lens = lens; p.sky = sky;
  p.out_rgb = static_cast<float*>(out_rgb);
  p.out_rays = static_cast<int*>(out_rays);
  p.out_over = static_cast<int*>(out_over);
  p.work = p.out_rays + static_cast<size_t>(rows) * width;
  p.out_tests = static_cast<unsigned long long*>(out_tests);
  p.node_at = node_at; p.free_at = free_at;
  p.n_free = n_free;
  p.score_bound = score_bound;
  p.stats = static_cast<unsigned long long*>(out_stats);

  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // in stream order, before the launch
  cudaError_t err = cudaMemsetAsync(out_tests, 0, 2 * sizeof(unsigned long long), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (out_stats != nullptr) {
    err = cudaMemsetAsync(out_stats, 0, csgr::kStatsWords * sizeof(unsigned long long), st);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (tree) {
      err = csgr::launch_persistent(tape_kernel_tree<8, true>, p, kThreads, p.table_bytes,
                                    p.width, p.rows, p.work, st);
    } else {
      csgr::WithStats<Params> flat;
      static_cast<Params&>(flat) = p;
      flat.stats = p.stats;
      err = launch<false, false, 8, true>(flat, st);
    }
  } else if (tree) {
    err = launch_tree(p, cap, st);
  } else if (n_lamps > 0) {
    err = lists ? launch_cap<true, true>(p, cap, st) : launch_cap<true, false>(p, cap, st);
  } else {
    err = lists ? launch_cap<false, true>(p, cap, st) : launch_cap<false, false>(p, cap, st);
  }
  return static_cast<int>(err);
}

extern "C" const char* csgr_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
