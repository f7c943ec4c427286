// Micro-experiment kernel: the cost of a narrow-page "serve", k page slabs
// multiplied by a one-hot on the tensor cores, against reading the same
// columns with plain loads.
//
// Replaces tools/exp_dot_k.py::kernel (the Pallas TPU kernel that run()
// launches with pl.pallas_call). A bf16 table tab [32 * rr_pad, 128] holds
// 32 pages of rr_pad rows. Each of n_iter dependent iterations takes k
// slabs [rr_pad, pw] (page p, columns 0 .. pw-1), concatenates them to
// A [rr_pad, k*pw], multiplies by the one-hot B [k*pw, 128] whose row
// j*pw + q is 1 where q == j (so column c of A x B is sum_j slab_j[r, j]),
// sums the product over its rows and accumulates. Every entry of the
// [8, 128] result is
//   sum_i sum_{j<k} sum_{r<rr_pad} tab[p(i, j) * rr_pad + r, j]
// with p = ((int)(acc * 0) + i*k + j) mod 32 (the page read through the
// accumulator, as the TPU service reads it), or p = j mod 32 in
// "static_slab". Modes, as the TPU script's variants:
//   - base: B built in shared memory every iteration, one product of depth
//     k*pw (bf16 in, f32 accumulate), mma.sync through nvcuda::wmma
//     m8n32k16 tiles, A's fragments loaded straight from the table rows (a
//     concatenation is only addressing here);
//   - kdots: k products of depth pw, each in its own accumulator, summed;
//   - hoist_onehot: base with B built once, before the loop;
//   - static_slab: base with the pages compile-time constants (j mod 32);
//   - vote: base plus the block-form page vote, k row-wise minima over the
//     [8, 128] page tile (warp min-reductions, one warp per row), whose
//     row 0 is added to the accumulator times 1e-20 before the product;
//   - direct (this port's answer to the TPU's question): no product; thread
//     r reads tab[p * rr_pad + r, j] for j < k, and the rows are summed.
// The modes compute the same function (direct that of base) and differ in
// accumulation order only.
//
// Design: one CTA of 256 threads (8 warps) runs the TPU kernel's dependent
// loop, so the slope over n_iter is the cost of one serve inside a hot
// loop. Warp w takes the product's 32-column tile w mod 4 and every other
// 8-row tile; each tile's 8 x 32 f32 result goes through a per-warp
// scratch where lane c sums its column's rows in order, and the two warps
// of a column tile are added in a fixed order, so every column gets the
// same bits.
//
// What bounds it: the question is latency inside a one-SM loop, not the
// card's throughput: per iteration rr_pad x k*pw x 128 multiply-adds on one
// SM's tensor cores (the m8n32 shape leaves part of each mma idle), the
// one-hot build's shared-memory stores, the A fragments' loads from the L2
// cache, and three barriers. The products by 0 and 1 are exact, so only
// the f32 sums round.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

constexpr int kPages = 32;
constexpr int kLanes = 128;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRows = 256;  // rr_pad <= 256, a multiple of 8

enum Mode { kBase = 0, kKdots = 1, kHoist = 2, kStatic = 3, kVote = 4, kDirect = 5 };

__device__ __forceinline__ void build_onehot(__nv_bfloat16* s_b, int n_rows, int pw, int tid) {
  const __nv_bfloat16 one = __float2bfloat16(1.0f), zero = __float2bfloat16(0.0f);
  for (int e = tid; e < n_rows * kLanes; e += kThreads) {
    const int a = e / kLanes;
    s_b[e] = (a % pw) == (a / pw) ? one : zero;
  }
}

// Row g's block vote over the page tile pg (4 columns per lane), k passes:
// the row minimum, its entries marked 0 and the rest -1, summed.
template <int K>
__device__ __forceinline__ void vote_row(const int* __restrict__ idx, int g, int lane, float carry,
                                         float (&extra)[4]) {
  float pg[4], rem[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    pg[q] = static_cast<float>(idx[g * kLanes + lane + 32 * q]) + carry;
    rem[q] = pg[q];
    extra[q] = 0.0f;
  }
#pragma unroll
  for (int pass = 0; pass < K; ++pass) {
    float m = fminf(fminf(rem[0], rem[1]), fminf(rem[2], rem[3]));
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) m = fminf(m, __shfl_xor_sync(0xffffffffu, m, s));
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const bool sel = pg[q] == m;
      rem[q] = sel ? 1e9f : rem[q];
      extra[q] += sel ? pg[q] - m : -1.0f;
    }
  }
}

template <int PW, int K, int kMode>
__global__ void __launch_bounds__(kThreads) exp_dot_k(const __nv_bfloat16* __restrict__ tab,
                                                      const int* __restrict__ idx,
                                                      float* __restrict__ out, int rr_pad,
                                                      int n_iter) {
  constexpr int kDepth = K * PW;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* s_b = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [kDepth, 128]
  __shared__ __align__(32) float s_scratch[kWarps][8 * 32];
  __shared__ float s_part[2][kLanes];
  __shared__ float s_acc[kLanes];
  __shared__ float s_extra[kLanes];
  __shared__ float s_rows[kMaxRows];
  __shared__ float s_total;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid < kLanes) s_acc[tid] = 0.0f;
  if (kMode == kHoist) build_onehot(s_b, kDepth, PW, tid);
  __syncthreads();
  const int m_tiles = rr_pad / 8;

  for (int i = 0; i < n_iter; ++i) {
    // the pages, read through the accumulator (carry-scalar)
    const float carry = s_acc[0] * 0.0f;
    int page[K];
#pragma unroll
    for (int j = 0; j < K; ++j) {
      page[j] = kMode == kStatic ? j % kPages : (static_cast<int>(carry) + i * K + j) % kPages;
    }
    if (kMode != kHoist && kMode != kDirect) build_onehot(s_b, kDepth, PW, tid);
    if (kMode == kVote) {
      float extra[4];
      vote_row<K>(idx, warp, lane, carry, extra);
      if (warp == 0) {
#pragma unroll
        for (int q = 0; q < 4; ++q) s_extra[lane + 32 * q] = extra[q];
      }
    }
    __syncthreads();

    if (kMode == kDirect) {
      if (tid < rr_pad) {
        float v = 0.0f;
#pragma unroll
        for (int j = 0; j < K; ++j) {
          v += __bfloat162float(tab[(static_cast<size_t>(page[j]) * rr_pad + tid) * kLanes + j]);
        }
        s_rows[tid] = v;
      }
      __syncthreads();
      if (warp == 0) {
        float s = 0.0f;
        for (int r = lane; r < rr_pad; r += 32) s += s_rows[r];
#pragma unroll
        for (int m = 16; m > 0; m >>= 1) s += __shfl_xor_sync(0xffffffffu, s, m);
        if (lane == 0) s_total = s;
      }
    } else {
      const int n = warp & 3;
      float colsum = 0.0f;
      for (int m = warp >> 2; m < m_tiles; m += 2) {
        wmma::fragment<wmma::accumulator, 8, 32, 16, float> c;
        wmma::fill_fragment(c, 0.0f);
#pragma unroll
        for (int j = 0; j < K; ++j) {
          const __nv_bfloat16* a_rows =
              tab + (static_cast<size_t>(page[j]) * rr_pad + m * 8) * kLanes;
          wmma::fragment<wmma::accumulator, 8, 32, 16, float> cj;
          if (kMode == kKdots) wmma::fill_fragment(cj, 0.0f);
#pragma unroll
          for (int kk = 0; kk < PW / 16; ++kk) {
            wmma::fragment<wmma::matrix_a, 8, 32, 16, __nv_bfloat16, wmma::row_major> a;
            wmma::fragment<wmma::matrix_b, 8, 32, 16, __nv_bfloat16, wmma::row_major> b;
            wmma::load_matrix_sync(a, a_rows + kk * 16, kLanes);
            wmma::load_matrix_sync(b, s_b + (j * PW + kk * 16) * kLanes + n * 32, kLanes);
            if (kMode == kKdots) {
              wmma::mma_sync(cj, a, b, cj);
            } else {
              wmma::mma_sync(c, a, b, c);
            }
          }
          if (kMode == kKdots) {
#pragma unroll
            for (int e = 0; e < c.num_elements; ++e) c.x[e] = j == 0 ? cj.x[e] : c.x[e] + cj.x[e];
          }
        }
        wmma::store_matrix_sync(s_scratch[warp], c, 32, wmma::mem_row_major);
        __syncwarp();
#pragma unroll
        for (int r = 0; r < 8; ++r) colsum += s_scratch[warp][r * 32 + lane];
        __syncwarp();
      }
      s_part[warp >> 2][n * 32 + lane] = colsum;
    }
    __syncthreads();
    if (tid < kLanes) {
      float acc = s_acc[tid];
      if (kMode == kVote) acc = acc + s_extra[tid] * 1e-20f;
      acc = acc + (kMode == kDirect ? s_total : s_part[0][tid] + s_part[1][tid]);
      s_acc[tid] = acc;
    }
    __syncthreads();
  }
  for (int e = tid; e < 8 * kLanes; e += kThreads) out[e] = s_acc[e % kLanes];
}

template <int PW, int K, int kMode>
cudaError_t launch(const void* tab, const void* idx, void* out, int rr_pad, int n_iter,
                   cudaStream_t st) {
  const int smem = kMode == kDirect ? 0 : K * PW * kLanes * static_cast<int>(sizeof(__nv_bfloat16));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        exp_dot_k<PW, K, kMode>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  exp_dot_k<PW, K, kMode><<<1, kThreads, smem, st>>>(
      static_cast<const __nv_bfloat16*>(tab), static_cast<const int*>(idx),
      static_cast<float*>(out), rr_pad, n_iter);
  return cudaGetLastError();
}

template <int PW, int K>
cudaError_t launch_mode(int mode, const void* tab, const void* idx, void* out, int rr_pad,
                        int n_iter, cudaStream_t st) {
  switch (mode) {
    case kBase: return launch<PW, K, kBase>(tab, idx, out, rr_pad, n_iter, st);
    case kKdots: return launch<PW, K, kKdots>(tab, idx, out, rr_pad, n_iter, st);
    case kHoist: return launch<PW, K, kHoist>(tab, idx, out, rr_pad, n_iter, st);
    case kStatic: return launch<PW, K, kStatic>(tab, idx, out, rr_pad, n_iter, st);
    case kVote: return launch<PW, K, kVote>(tab, idx, out, rr_pad, n_iter, st);
    case kDirect: return launch<PW, K, kDirect>(tab, idx, out, rr_pad, n_iter, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// mode: 0 base, 1 kdots, 2 hoist_onehot, 3 static_slab, 4 vote, 5 direct.
// (pw, k) in {32, 64} x {4, 8}; rr_pad a multiple of 8 up to 256; tab
// [32 * rr_pad, 128] bf16, idx [8, 128] i32 (vote reads it), out [8, 128]
// f32, all contiguous on the device.
extern "C" int csgr_exp_dot_k(const void* tab, const void* idx, void* out, int rr_pad, int pw,
                              int k, int n_iter, int mode, void* stream) {
  if (rr_pad < 8 || rr_pad > kMaxRows || rr_pad % 8 != 0 || n_iter < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (pw == 32 && k == 4) err = launch_mode<32, 4>(mode, tab, idx, out, rr_pad, n_iter, st);
  if (pw == 32 && k == 8) err = launch_mode<32, 8>(mode, tab, idx, out, rr_pad, n_iter, st);
  if (pw == 64 && k == 4) err = launch_mode<64, 4>(mode, tab, idx, out, rr_pad, n_iter, st);
  if (pw == 64 && k == 8) err = launch_mode<64, 8>(mode, tab, idx, out, rr_pad, n_iter, st);
  return static_cast<int>(err);
}

extern "C" const char* csgr_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
