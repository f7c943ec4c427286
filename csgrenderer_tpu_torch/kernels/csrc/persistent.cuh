// The persistent-CTA machinery shared by the path-tracing kernels
// (sphere_megakernel.cu, trimesh_kernel.cu, tape_kernel.cu):
//   - stage_tables: a CTA copies its read-only tables into its dynamic
//     shared memory (smem_tables) with bulk (TMA 1D) copies that complete
//     on one mbarrier, which every thread waits on;
//   - for_each_pixel: each warp takes 16x2-pixel work units from a
//     per-launch counter until the slab is done. Unit u is the 16x2 strip
//     u % 4 of the 16x8 tile u / 4 (tiles row-major over the slab), the
//     strip a warp of a 16x8 block held in a one-thread-per-pixel launch,
//     so lanes keep their neighbours, and each pixel keeps its own sample
//     order: a pixel's image does not depend on which warp renders it.
//     Taking units per warp, not per CTA, keeps the warps of one CTA from
//     waiting for each other at a barrier; taking them from a counter
//     absorbs the cost gap between cheap and dear tiles (sky against
//     geometry) at the tail of a frame;
//   - launch_persistent: as many CTAs as the occupancy calculator fits on
//     the device at once (no more than the units need), the counter zeroed
//     by cudaMemsetAsync in stream order just before the launch;
//   - add_count: a launch's work counts (trimesh_kernel.cu's triangle
//     tests, tape_kernel.cu's leaf intervals), each pixel's in a register,
//     summed over the warp and added to one 64-bit word by one atomic;
//   - the stats mode (the kernels' kStats instantiations, which the
//     launchers run where the caller hands them a stats block): Stats, a
//     lane's counts of a work unit in registers (the warp turns of the
//     segment loop and of the walk loop, each counted by the lowest active
//     lane of the warp, count_warp_turn; the walk's turns of each lane, and
//     the part of them NEE's shadow rays take), added to the launch's
//     kStatsWords int64 words (WithStats::stats, zeroed before the launch)
//     by add_stats at the end of each work unit, one add_count a word. The
//     device functions that the plain and the stats instantiations share
//     take a pack ``Stats&... st``: empty in the plain ones, whose code is
//     then what it is without the hooks (each sits under ``if constexpr
//     (sizeof...(Stats) > 0)``, so their SASS does not change), and the
//     lane's one Stats in the stats ones.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

// A CTA's dynamic shared memory: the tables stage_tables copies, one after
// another in the order given (kernels that stage only).
extern __shared__ __align__(16) unsigned char smem_tables[];

namespace csgr {

constexpr int kTileW = 16, kTileH = 8;  // a tile: 16 x 8 pixels, four 16 x 2 strips
constexpr int kStrips = kTileH / 2;     // work units per tile, one warp's strip each

// Copies the n tables src[i] (bytes[i] each) one after another into this
// CTA's dynamic shared memory with one bulk (TMA 1D) copy each, completing
// on an mbarrier that every thread waits on. Sizes and global addresses
// are multiples of 16 (the launchers check); an empty table is skipped.
template <int N>
__device__ __forceinline__ void stage_tables(const void* const (&src)[N], const int (&bytes)[N]) {
  __shared__ __align__(8) uint64_t bar;
  const uint32_t bar_addr = static_cast<uint32_t>(__cvta_generic_to_shared(&bar));
  const bool leader = threadIdx.x == 0 && threadIdx.y == 0;
  if (leader) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar_addr) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (leader) {
    int total = 0;
#pragma unroll
    for (int i = 0; i < N; ++i) total += bytes[i];
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar_addr),
                 "r"(total)
                 : "memory");
    uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem_tables));
#pragma unroll
    for (int i = 0; i < N; ++i) {
      if (bytes[i] > 0) {
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
            "[%3];" ::"r"(dst),
            "l"(src[i]), "r"(bytes[i]), "r"(bar_addr)
            : "memory");
      }
      dst += bytes[i];
    }
  }
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{ .reg .pred P; mbarrier.try_wait.parity.shared::cta.b64 P, [%1], %2; "
        "selp.u32 %0, 1, 0, P; }"
        : "=r"(done)
        : "r"(bar_addr), "r"(0u)
        : "memory");
  }
}

// Work units of a slab of ``rows`` rows, ``width`` pixels wide.
__host__ __device__ __forceinline__ long long work_units(int width, int rows) {
  return static_cast<long long>((width + kTileW - 1) / kTileW) * ((rows + kTileH - 1) / kTileH) *
         kStrips;
}

// Calls render(x, row) for every pixel of the units this warp takes from
// *work (row counts within the slab). A CTA is one-dimensional, a whole
// number of warps.
template <class Render>
__device__ __forceinline__ void for_each_pixel(int* work, int width, int rows, Render&& render) {
  const int lane = threadIdx.x & 31;
  const int tiles_x = (width + kTileW - 1) / kTileW;
  const int n_units = static_cast<int>(work_units(width, rows));
  for (;;) {
    int unit = 0;
    if (lane == 0) unit = atomicAdd(work, 1);
    unit = __shfl_sync(0xffffffffu, unit, 0);
    if (unit >= n_units) break;
    const int tile = unit / kStrips;
    const int x = (tile % tiles_x) * kTileW + lane % kTileW;
    const int row = (tile / tiles_x) * kTileH + (unit % kStrips) * 2 + lane / kTileW;
    if (x < width && row < rows) render(x, row);
    __syncwarp();
  }
}

// Adds the counts of the lanes that call this together to the launch's
// word: their sum over the warp, added by the lowest of them.
__device__ __forceinline__ void add_count(unsigned long long* out, unsigned count) {
  const unsigned lanes = __activemask();
  const unsigned sum = __reduce_add_sync(lanes, count);
  if (static_cast<int>(threadIdx.x & 31) == __ffs(lanes) - 1) {
    atomicAdd(out, static_cast<unsigned long long>(sum));
  }
}

// The stats block's words, in order: the segment loop's warp turns, the walk
// loop's warp turns, the walk loop's lane turns, the shadow rays' part of
// those lane turns (kernels/build.py: STATS_WORDS).
constexpr int kStatsWords = 4;

// A stats launch's parameters: the kernel's own, then its stats block. The
// other launches take P alone, so their code stays as it is.
template <class P>
struct WithStats : P {
  unsigned long long* stats;  // [kStatsWords], zeroed before the launch
};

template <class P, bool kStats>
using StatsParams = std::conditional_t<kStats, WithStats<P>, P>;

// One lane's counts of a work unit in a stats launch.
struct Stats {
  unsigned segment_warp = 0;  // segment-loop turns this lane counted for its warp
  unsigned walk_warp = 0;     // walk-loop turns this lane counted for its warp
  unsigned walk_lane = 0;     // walk-loop turns this lane took
  unsigned shadow_lane = 0;   // of those, the turns of its shadow rays' walks
};

// Counts one turn of a loop for the lanes that take it together: the
// lowest of them adds it to its ``turns``, so the warp's turns add up once.
__device__ __forceinline__ void count_warp_turn(unsigned& turns) {
  const unsigned lanes = __activemask();
  if (static_cast<int>(threadIdx.x & 31) == __ffs(lanes) - 1) ++turns;
}

// The hooks: one turn of a segment loop, the warp's; one turn of a walk
// loop, the warp's and this lane's; the lane's Stats out of a pack of one.
__device__ __forceinline__ void segment_turn(Stats& st) { count_warp_turn(st.segment_warp); }

__device__ __forceinline__ void walk_turn(Stats& st) {
  count_warp_turn(st.walk_warp);
  ++st.walk_lane;
}

__device__ __forceinline__ Stats& lane_stats(Stats& st) { return st; }

// Adds the first kWords of the lanes' counts (segment_warp, walk_warp,
// walk_lane, shadow_lane) to the launch's stats words, one add_count each.
template <int kWords>
__device__ __forceinline__ void add_stats(unsigned long long* out, const Stats& st) {
  add_count(out, st.segment_warp);
  if constexpr (kWords > 1) add_count(out + 1, st.walk_warp);
  if constexpr (kWords > 2) add_count(out + 2, st.walk_lane);
  if constexpr (kWords > 3) add_count(out + 3, st.shadow_lane);
}

// Launches ``kernel`` (a persistent kernel over for_each_pixel) with
// ``threads`` a CTA and ``smem`` bytes of dynamic shared memory: as many
// CTAs as fit on the device at once, no more than the slab's units need.
// ``work`` (one int32) is zeroed in stream order before the launch.
template <class Params>
cudaError_t launch_persistent(void (*kernel)(const Params), const Params& p, int threads,
                              int smem, int width, int rows, int* work, cudaStream_t st) {
  if (smem > 48 * 1024) {  // above the default: opt in to the bytes this launch stages
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long warps = threads / 32;
  const long long ctas = std::min<long long>(static_cast<long long>(sms) * per_sm,
                                             (work_units(width, rows) + warps - 1) / warps);
  e = cudaMemsetAsync(work, 0, sizeof(int), st);  // in stream order, before the launch
  if (e != cudaSuccess) return e;
  kernel<<<static_cast<unsigned>(ctas), threads, smem, st>>>(p);
  return cudaGetLastError();
}

// The most dynamic shared memory a CTA of ``kernel`` can stage on
// ``device``: its opt-in shared memory per block less the kernel's static
// shared memory; a negative CUDA error code on failure.
template <class Params>
int table_limit(void (*kernel)(const Params), int device) {
  int optin = 0;
  cudaError_t e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (e != cudaSuccess) return -static_cast<int>(e);
  cudaFuncAttributes attr;
  e = cudaFuncGetAttributes(&attr, kernel);
  if (e != cudaSuccess) return -static_cast<int>(e);
  return optin - static_cast<int>(attr.sharedSizeBytes);
}

}  // namespace csgr
