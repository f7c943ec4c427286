// Micro-experiment kernel: a per-lane column gather out of a small table,
// as a shared-memory gather or as a product by a one-hot matrix.
//
// Replaces tools/exp_gather.py::kernel_gather (the Pallas TPU kernel that
// run() launches with pl.pallas_call). For a table tab [115, 128] f32 and
// start indices idx0 [8, 128] i32 it computes, over n_iter dependent
// iterations,
//   out[g, j] = sum_i sum_r tab[r, (idx0[g, j] + i) & 127]
// The TPU asked whether jnp.take_along_axis (a lane shuffle) beats the
// one-hot MXU product; this kernel asks the same question of an H100.
//
// Design: one CTA of 1024 threads, thread (g, j) = (tid / 128, tid % 128),
// runs the same dependent loop the TPU kernel's fori_loop runs, so the
// slope over n_iter is the cost of one step inside a hot loop. The table
// (58,880 bytes) is staged once into shared memory.
//   - kOneHot = false ("shuffle"): each thread reads its column, one gather
//     per thread per row: 115 shared loads at lane-random columns (bank
//     conflicts included) and 115 adds per iteration.
//   - kOneHot = true ("onehot"): each thread forms column j of tab x onehot
//     on the CUDA cores: for every row, 128 products by (a == c ? 1 : 0)
//     summed in order, then the row sum. It is an f32 product, not TF32,
//     which would round the table. A product by 0 or 1 is exact and adding
//     zeros changes nothing, so the product's column is tab[r, c] to the
//     bit, and the two modes return the same bits.
// Rows are summed in order r = 0..114 in both modes, then added to the
// accumulator, as the TPU kernel sums got over its rows before adding.
//
// What bounds it: one SM does all the work (a latency-bound dependent loop
// by design; the card's other 131 SMs idle). "shuffle" is bound by shared
// memory issue (115 conflicted loads per thread per iteration); "onehot" by
// FP32 issue: 8 x 115 x 128 x 128 = 15.1 M multiply-adds per iteration,
// which one SM's 128 lanes take at least 118 k cycles for without FMA
// (the build uses -fmad=false).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 115;   // R of tools/exp_gather.py
constexpr int kLanes = 128;
constexpr int kGroups = 8;
constexpr int kThreads = kGroups * kLanes;

template <bool kOneHot>
__global__ void __launch_bounds__(kThreads) exp_gather(const float* __restrict__ tab,
                                                       const int* __restrict__ idx,
                                                       float* __restrict__ out, int n_iter) {
  extern __shared__ float s_tab[];  // [kRows, kLanes]
  const int tid = threadIdx.x;
  for (int e = tid; e < kRows * kLanes / 4; e += kThreads) {
    reinterpret_cast<float4*>(s_tab)[e] = reinterpret_cast<const float4*>(tab)[e];
  }
  __syncthreads();
  const int i0 = idx[tid];  // thread (g, j) = tid: idx0[g, j]
  float acc = 0.0f;
  for (int i = 0; i < n_iter; ++i) {
    const int c = (i0 + i) & (kLanes - 1);
    float s = 0.0f;
    for (int r = 0; r < kRows; ++r) {
      const float* row = s_tab + r * kLanes;
      float got;
      if (kOneHot) {
        got = 0.0f;
        for (int a = 0; a < kLanes; a += 4) {
          const float4 v = *reinterpret_cast<const float4*>(row + a);
          got += v.x * (a == c ? 1.0f : 0.0f);
          got += v.y * (a + 1 == c ? 1.0f : 0.0f);
          got += v.z * (a + 2 == c ? 1.0f : 0.0f);
          got += v.w * (a + 3 == c ? 1.0f : 0.0f);
        }
      } else {
        got = row[c];
      }
      s += got;
    }
    acc += s;
  }
  out[tid] = acc;
}

template <bool kOneHot>
cudaError_t launch(const float* tab, const int* idx, float* out, int n_iter, cudaStream_t st) {
  const int smem = kRows * kLanes * static_cast<int>(sizeof(float));
  const cudaError_t err = cudaFuncSetAttribute(
      exp_gather<kOneHot>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  exp_gather<kOneHot><<<1, kThreads, smem, st>>>(tab, idx, out, n_iter);
  return cudaGetLastError();
}

}  // namespace

// mode: 0 onehot, 1 shuffle. tab [115, 128] f32, idx [8, 128] i32 in
// [0, 128), out [8, 128] f32, all contiguous on the device.
extern "C" int csgr_exp_gather(const void* tab, const void* idx, void* out, int n_iter,
                               int mode, void* stream) {
  if (n_iter < 0 || (mode != 0 && mode != 1)) return static_cast<int>(cudaErrorInvalidValue);
  const float* t = static_cast<const float*>(tab);
  const int* x = static_cast<const int*>(idx);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = mode == 0 ? launch<true>(t, x, o, n_iter, st)
                                    : launch<false>(t, x, o, n_iter, st);
  return static_cast<int>(err);
}

extern "C" const char* csgr_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
