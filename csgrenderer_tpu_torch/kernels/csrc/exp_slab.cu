// Micro-experiment kernel: dynamic page-slab extraction, strided rows
// (lane layout) against a contiguous block (sublane layout).
//
// Replaces tools/exp_slab.py::kernel (the Pallas TPU kernel that run()
// launches with pl.pallas_call). A table holds 28 pages of a [248, 128]
// f32 slab, either side by side (lane layout, tab [248, 3584], page p =
// columns p*128 .. p*128+127) or one under the other (sublane layout, tab
// [28*248, 128], page p = rows p*248 .. p*248+247). Over n_iter dependent
// iterations the kernel moves page p(i) out of the table and sums its
// column 7; every entry of the [8, 128] result is
//   sum_i sum_r slab_{p(i)}[r, 7]
// with p(i) = (idx0[0, 0] + i) mod 28 ("lane", "sublane") or i mod 28
// ("loopscalar"; "carryscalar" forms the same page from the accumulator,
// ((int)(acc * 0) + i) mod 28, so each iteration's loads wait for the
// previous iteration's sum). The TPU multiplied the slab by a one-hot
// selecting column 7; that product was a TPU artefact and is not repeated.
//
// Design: one CTA of 1024 threads runs the TPU kernel's dependent loop, so
// the slope over n_iter is the cost of one step. Each iteration copies the
// whole [248, 128] slab (126,976 bytes) from global memory into shared
// memory with 16-byte loads: 512-byte rows 14,336 bytes apart in the lane
// layout, one 126,976-byte block in the sublane layout. Warp 0 then sums
// column 7 in a fixed order (lane l: rows l, l + 32, ...; then a butterfly),
// so "lane" and "sublane" return the same bits, and so do "loopscalar" and
// "carryscalar" (same pages, same data, same order).
//
// What bounds it: one SM moves 127 KB per iteration from the L2 cache
// (the 3.5 MB table stays there), so the loop is bound by one SM's load
// bandwidth and latency, not the card's 3.35 TB/s; the two barriers per
// iteration keep the copy and the sum from overlapping.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 248;  // R of tools/exp_slab.py
constexpr int kLanes = 128;
constexpr int kPages = 28;  // W / 128
constexpr int kCol = 7;
constexpr int kThreads = 1024;
constexpr int kVec = kRows * kLanes / 4;  // float4 per slab

enum Mode { kLane = 0, kSublane = 1, kLoopScalar = 2, kCarryScalar = 3 };

template <int kMode>
__global__ void __launch_bounds__(kThreads) exp_slab(const float* __restrict__ tab,
                                                     const int* __restrict__ idx,
                                                     float* __restrict__ out, int n_iter) {
  extern __shared__ float4 s_slab[];  // [kRows, kLanes / 4]
  __shared__ float s_acc;
  const int tid = threadIdx.x;
  if (tid == 0) s_acc = 0.0f;
  const int start = idx[0];
  __syncthreads();
  for (int i = 0; i < n_iter; ++i) {
    int p;
    if (kMode == kCarryScalar) {
      p = (static_cast<int>(s_acc * 0.0f) + i) % kPages;
    } else if (kMode == kLoopScalar) {
      p = i % kPages;
    } else {
      p = (start + i) % kPages;
    }
    for (int e = tid; e < kVec; e += kThreads) {
      const int r = e >> 5, q = e & 31;
      const float4* src = kMode == kLane
          ? reinterpret_cast<const float4*>(tab + static_cast<size_t>(r) * kPages * kLanes +
                                            p * kLanes) + q
          : reinterpret_cast<const float4*>(tab + (static_cast<size_t>(p) * kRows + r) * kLanes) +
                q;
      s_slab[e] = *src;
    }
    __syncthreads();
    if (tid < 32) {
      float s = 0.0f;
      for (int r = tid; r < kRows; r += 32) {
        s += reinterpret_cast<const float*>(s_slab)[r * kLanes + kCol];
      }
      for (int m = 16; m > 0; m >>= 1) s += __shfl_xor_sync(0xffffffffu, s, m);
      if (tid == 0) s_acc += s;
    }
    __syncthreads();
  }
  out[tid] = s_acc;
}

template <int kMode>
cudaError_t launch(const float* tab, const int* idx, float* out, int n_iter, cudaStream_t st) {
  const int smem = kRows * kLanes * static_cast<int>(sizeof(float));
  const cudaError_t err = cudaFuncSetAttribute(
      exp_slab<kMode>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  exp_slab<kMode><<<1, kThreads, smem, st>>>(tab, idx, out, n_iter);
  return cudaGetLastError();
}

}  // namespace

// mode: 0 lane (tab [248, 3584]), 1 sublane, 2 loopscalar, 3 carryscalar
// (tab [6944, 128]); idx [8, 128] i32 (idx[0] >= 0 read), out [8, 128]
// f32, all contiguous on the device.
extern "C" int csgr_exp_slab(const void* tab, const void* idx, void* out, int n_iter, int mode,
                             void* stream) {
  const float* t = static_cast<const float*>(tab);
  const int* x = static_cast<const int*>(idx);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_iter < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  switch (mode) {
    case kLane: err = launch<kLane>(t, x, o, n_iter, st); break;
    case kSublane: err = launch<kSublane>(t, x, o, n_iter, st); break;
    case kLoopScalar: err = launch<kLoopScalar>(t, x, o, n_iter, st); break;
    case kCarryScalar: err = launch<kCarryScalar>(t, x, o, n_iter, st); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" const char* csgr_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
