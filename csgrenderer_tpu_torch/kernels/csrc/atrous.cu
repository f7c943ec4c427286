// One pass of the edge-aware a-trous filter: a 5x5 B3-spline stencil whose
// taps lie `step` pixels apart, each weighted by how alike its normal,
// depth, luminance and hit flag are to the centre pixel's.
//
// Replaces no Pallas kernel: in the JAX package the filter is an XLA
// program (csgrenderer_tpu/render/denoise.py::atrous_denoise, 25 static
// slices of an edge-padded plane a pass, which XLA fuses into a handful of
// kernels). Run eagerly in torch ops a pass is about 500 launches, so the
// port's counterpart of that fusion is this kernel, one launch a pass; its
// plain version is render/denoise.py::atrous_pass_plain, which it repeats
// operation for operation (built with -fmad=false, no fast math).
//
// Design: one thread a pixel in 32x8 blocks; the taps are read through L1
// (__ldg), and clamped coordinates reproduce jnp.pad(mode="edge"). The
// AOVs are read as the AOV pass wrote them: a non-finite depth (a miss)
// is taken as 0 and the hit mask is one byte a pixel. Albedo demodulation
// and remodulation are the caller's two elementwise ops, outside the passes.
//
// What bounds it: the kernel recomputes each tap's luminance, and each
// tap's normal dot whatever its hit flags; the function needs per pixel and
// pass one luminance (5 FP32 operations), 23 per tap, 8 more (normal dot,
// max, powf, the product) per tap where both pixels hit, and 4 to
// normalise (expf and powf count one each), against 41 bytes moved (work,
// normal, depth, hit in; work out). At 132 SMs x 128 lanes and about
// 1.98 GHz that is operations (chip_smoke.py's atrous_bound counts them on
// the frame). A shared-memory tile with its 2*step halo, and luminances
// computed once a pixel, are left for later.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockX = 32;
constexpr int kBlockY = 8;

// B3-spline mass [1, 4, 6, 4, 1] / 16 of tap i; the 5x5 weight is a product
// of two, exact in f32
__device__ __forceinline__ float b3(int i) {
  return i == 2 ? 6.0f / 16.0f : (i == 1 || i == 3) ? 4.0f / 16.0f : 1.0f / 16.0f;
}

__device__ __forceinline__ float luminance(float r, float g, float b) {
  return r * 0.2126f + g * 0.7152f + b * 0.0722f;
}

__device__ __forceinline__ float3 load_work(const float* __restrict__ src, int p) {
  return make_float3(__ldg(src + 3 * p), __ldg(src + 3 * p + 1), __ldg(src + 3 * p + 2));
}

__device__ __forceinline__ float aov_depth(const float* __restrict__ depth, int p) {
  const float z = __ldg(depth + p);
  return isfinite(z) ? z : 0.0f;
}

__global__ void __launch_bounds__(kBlockX* kBlockY)
    atrous_pass(const float* __restrict__ src, const float* __restrict__ normal,
                const float* __restrict__ depth, const uint8_t* __restrict__ hit,
                float* __restrict__ out, int h, int w, int step, float inv_sig_c2,
                float inv_sig_z2, float sigma_normal) {
  const int x = blockIdx.x * kBlockX + threadIdx.x;
  const int y = blockIdx.y * kBlockY + threadIdx.y;
  if (x >= w || y >= h) return;
  const int p = y * w + x;
  const float3 c = load_work(src, p);
  const float nx = __ldg(normal + 3 * p), ny = __ldg(normal + 3 * p + 1),
              nz = __ldg(normal + 3 * p + 2);
  const float z = aov_depth(depth, p);
  const bool hc = __ldg(hit + p) != 0;
  const float lum_c = luminance(c.x, c.y, c.z);
  float ax = 0.0f, ay = 0.0f, az = 0.0f, wsum = 0.0f;
#pragma unroll
  for (int iy = 0; iy < 5; ++iy) {
    const int ty = min(max(y + (iy - 2) * step, 0), h - 1);
#pragma unroll
    for (int ix = 0; ix < 5; ++ix) {
      const int tx = min(max(x + (ix - 2) * step, 0), w - 1);
      const int q = ty * w + tx;
      const float3 ct = load_work(src, q);
      const float n_dot = nx * __ldg(normal + 3 * q) + ny * __ldg(normal + 3 * q + 1) +
                          nz * __ldg(normal + 3 * q + 2);
      const float zt = aov_depth(depth, q);
      const bool ht = __ldg(hit + q) != 0;
      // sky pixels (normal 0) zero w_n; the hit gate decides for them
      const float w_n = (hc && ht) ? powf(fmaxf(n_dot, 0.0f), sigma_normal) : 1.0f;
      const float dz = fabsf(z - zt) / (0.5f * (z + zt) + 1e-3f);
      const float w_z = expf(-dz * dz * inv_sig_z2);
      const float dl = lum_c - luminance(ct.x, ct.y, ct.z);
      const float w_c = expf(-dl * dl * inv_sig_c2);
      const float w_h = hc == ht ? 1.0f : 0.0f;
      const float wt = b3(iy) * b3(ix) * w_n * w_z * w_c * w_h;
      ax = ax + wt * ct.x;
      ay = ay + wt * ct.y;
      az = az + wt * ct.z;
      wsum = wsum + wt;
    }
  }
  const float ws = fmaxf(wsum, 1e-8f);
  out[3 * p] = ax / ws;
  out[3 * p + 1] = ay / ws;
  out[3 * p + 2] = az / ws;
}

}  // namespace

// src, normal, out: [h, w, 3] f32; depth: [h, w] f32; hit: [h, w] u8; all
// contiguous on the device, out apart from src.
extern "C" int csgr_atrous_pass(const void* src, const void* normal, const void* depth,
                                const void* hit, void* out, int h, int w, int step,
                                float inv_sig_c2, float inv_sig_z2, float sigma_normal,
                                void* stream) {
  const dim3 block(kBlockX, kBlockY);
  const dim3 grid((w + kBlockX - 1) / kBlockX, (h + kBlockY - 1) / kBlockY);
  atrous_pass<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(src), static_cast<const float*>(normal),
      static_cast<const float*>(depth), static_cast<const uint8_t*>(hit),
      static_cast<float*>(out), h, w, step, inv_sig_c2, inv_sig_z2, sigma_normal);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* csgr_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
