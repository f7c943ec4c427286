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
// What bounds it on an H100: FP32 operations, about 45 a tap and 25 taps a
// pixel, where the data a pass reads is a few bytes a tap. What the design
// does about it:
//   - the first pass packs what the later ones read: the (demodulated)
//     colour with its luminance as one float4 (r, g, b, luminance), and the
//     normal with the depth (a miss's at 0) as another (nx, ny, nz, z); the
//     hit mask stays one byte a pixel. Every later pass writes its colour
//     the same way, so a pixel's luminance is computed once a pass, in the
//     operations of denoise.luminance, not once a tap;
//   - a CTA covers a 16x16 block of one step-interleaved sub-lattice
//     (pixels x = rx + step * i, y = ry + step * j), whose taps are the
//     lattice's own neighbours: it stages the block and 2 lattice pixels a
//     side (20x20) in shared memory, so each staged pixel serves about 16
//     taps at every step, and a tap is two 16-byte shared loads and a byte.
//     A staged pixel's coordinates are clamped to the frame, which is
//     jnp.pad(mode="edge");
//   - the normal weight max(n.n', 0)^sigma is a chain of squarings where
//     sigma is a power of two (32 by default: five multiplies, not a powf);
//     the plain version computes it so, and the JAX package's pow differs
//     from it in the last bits only. At sigma 32 the squarings are unrolled
//     and the hit gate is a select after them, so the 25 taps are one
//     branch-free block the compiler interleaves (the same squarings in a
//     loop under the gate's branch took 46% longer). The depth and colour
//     weights stay two
//     expf: one expf of their summed exponents moved the filter 1.7e-5 from
//     the JAX package's, past the parity the CPU tests hold (1e-5).
// The last pass writes the [H, W, 3] image, remodulated by the clamped
// albedo where the filter demodulates.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 16;             // a CTA: 16 x 16 pixels of one sub-lattice
constexpr int kTile = kBlock + 4;      // staged: the block and 2 lattice pixels a side
constexpr int kStaged = kTile * kTile;

struct PassArgs {
  // the first pass reads the filter's inputs as the AOV pass wrote them
  const float* color;   // [h, w, 3]
  const float* albedo;  // [h, w, 3] (also read by the last pass when it remodulates)
  const float* normal;  // [h, w, 3]
  const float* depth;   // [h, w], +inf on a miss
  // every later pass reads what the pass before wrote
  const float4* work;   // [h, w]: (r, g, b, luminance)
  const float4* guide;  // [h, w]: (nx, ny, nz, depth with misses at 0)
  const uint8_t* hit;   // [h, w]
  float4* work_out;     // not the last pass
  float4* guide_out;    // the first pass
  float* image_out;     // the last pass: [h, w, 3]
  int h, w, step, squarings;  // squarings < 0: sigma_normal is not a power of two
  float inv_sig_c2, inv_sig_z2, sigma_normal;
  int demodulate;
};

// B3-spline mass [1, 4, 6, 4, 1] / 16 of tap i; the 5x5 weight is a product
// of two, exact in f32
__device__ __forceinline__ float b3(int i) {
  return i == 2 ? 6.0f / 16.0f : (i == 1 || i == 3) ? 4.0f / 16.0f : 1.0f / 16.0f;
}

__device__ __forceinline__ float luminance(float r, float g, float b) {
  return r * 0.2126f + g * 0.7152f + b * 0.0722f;
}

__device__ __forceinline__ float clamped_albedo(const float* albedo, int i) {
  return fmaxf(__ldg(albedo + i), 1e-4f);
}

// Pixel p's colour (divided by its clamped albedo where the filter
// demodulates) with its luminance, and its normal with its depth (a
// non-finite one, a miss, at 0): denoise.filter_inputs and the first pass.
__device__ __forceinline__ float4 first_work(const PassArgs& a, int p) {
  float r = __ldg(a.color + 3 * p), g = __ldg(a.color + 3 * p + 1), b = __ldg(a.color + 3 * p + 2);
  if (a.demodulate) {
    r = r / clamped_albedo(a.albedo, 3 * p);
    g = g / clamped_albedo(a.albedo, 3 * p + 1);
    b = b / clamped_albedo(a.albedo, 3 * p + 2);
  }
  return make_float4(r, g, b, luminance(r, g, b));
}

__device__ __forceinline__ float4 first_guide(const PassArgs& a, int p) {
  const float z = __ldg(a.depth + p);
  return make_float4(__ldg(a.normal + 3 * p), __ldg(a.normal + 3 * p + 1),
                     __ldg(a.normal + 3 * p + 2), isfinite(z) ? z : 0.0f);
}

// kSigma32: sigma_normal is 32 (the filter's default), so the normal
// weight is five squarings, unrolled and branch-free; otherwise
// a.squarings of them, or a powf where sigma is no power of two.
template <bool kFirst, bool kLast, bool kSigma32>
__global__ void __launch_bounds__(kBlock* kBlock) atrous_pass(const PassArgs a) {
  __shared__ float4 s_work[kStaged];
  __shared__ float4 s_guide[kStaged];
  __shared__ uint8_t s_hit[kStaged];
  const int step = a.step;
  const int rx = blockIdx.x % step, ry = blockIdx.y % step;  // the CTA's sub-lattice
  const int lx0 = static_cast<int>(blockIdx.x / step) * kBlock;  // its block, in lattice pixels
  const int ly0 = static_cast<int>(blockIdx.y / step) * kBlock;
  for (int i = threadIdx.y * kBlock + threadIdx.x; i < kStaged; i += kBlock * kBlock) {
    const int px = min(max(rx + step * (lx0 - 2 + i % kTile), 0), a.w - 1);
    const int py = min(max(ry + step * (ly0 - 2 + i / kTile), 0), a.h - 1);
    const int p = py * a.w + px;
    if constexpr (kFirst) {
      s_work[i] = first_work(a, p);
      s_guide[i] = first_guide(a, p);
    } else {
      s_work[i] = __ldg(a.work + p);
      s_guide[i] = __ldg(a.guide + p);
    }
    s_hit[i] = __ldg(a.hit + p);
  }
  __syncthreads();

  const int x = rx + step * (lx0 + static_cast<int>(threadIdx.x));
  const int y = ry + step * (ly0 + static_cast<int>(threadIdx.y));
  if (x >= a.w || y >= a.h) return;
  const int p = y * a.w + x;
  const int centre = (threadIdx.y + 2) * kTile + threadIdx.x + 2;
  const float lum_c = s_work[centre].w;
  const float4 gc = s_guide[centre];
  const bool hc = s_hit[centre] != 0;
  if constexpr (kFirst) {
    if (!kLast) a.guide_out[p] = gc;
  }
  float ax = 0.0f, ay = 0.0f, az = 0.0f, wsum = 0.0f;
#pragma unroll
  for (int iy = 0; iy < 5; ++iy) {
#pragma unroll
    for (int ix = 0; ix < 5; ++ix) {
      const int q = (threadIdx.y + iy) * kTile + threadIdx.x + ix;
      const float4 ct = s_work[q];
      const float4 gt = s_guide[q];
      const bool ht = s_hit[q] != 0;
      float w_n = fmaxf(gc.x * gt.x + gc.y * gt.y + gc.z * gt.z, 0.0f);
      if constexpr (kSigma32) {
#pragma unroll
        for (int k = 0; k < 5; ++k) w_n = w_n * w_n;
      } else if (a.squarings >= 0) {
        for (int k = 0; k < a.squarings; ++k) w_n = w_n * w_n;
      } else {
        w_n = powf(w_n, a.sigma_normal);
      }
      // sky pixels (normal 0) zero w_n; the hit gate decides for them
      w_n = hc && ht ? w_n : 1.0f;
      const float dz = fabsf(gc.w - gt.w) / (0.5f * (gc.w + gt.w) + 1e-3f);
      const float w_z = expf(-dz * dz * a.inv_sig_z2);
      const float dl = lum_c - ct.w;
      const float w_c = expf(-dl * dl * a.inv_sig_c2);
      const float w_h = hc == ht ? 1.0f : 0.0f;
      const float wt = b3(iy) * b3(ix) * w_n * w_z * w_c * w_h;
      ax = ax + wt * ct.x;
      ay = ay + wt * ct.y;
      az = az + wt * ct.z;
      wsum = wsum + wt;
    }
  }
  const float ws = fmaxf(wsum, 1e-8f);
  const float r = ax / ws, g = ay / ws, b = az / ws;
  if constexpr (kLast) {
    float* out = a.image_out + 3 * p;
    if (a.demodulate) {
      out[0] = r * clamped_albedo(a.albedo, 3 * p);
      out[1] = g * clamped_albedo(a.albedo, 3 * p + 1);
      out[2] = b * clamped_albedo(a.albedo, 3 * p + 2);
    } else {
      out[0] = r;
      out[1] = g;
      out[2] = b;
    }
  } else {
    a.work_out[p] = make_float4(r, g, b, luminance(r, g, b));
  }
}

template <bool kFirst, bool kLast>
cudaError_t launch(const PassArgs& a, cudaStream_t st) {
  // the sub-lattices of residue (rx, ry) tile the frame; residue 0 is the widest
  const int lat_w = (a.w + a.step - 1) / a.step, lat_h = (a.h + a.step - 1) / a.step;
  const dim3 grid(((lat_w + kBlock - 1) / kBlock) * a.step, ((lat_h + kBlock - 1) / kBlock) * a.step);
  if (a.squarings == 5) {
    atrous_pass<kFirst, kLast, true><<<grid, dim3(kBlock, kBlock), 0, st>>>(a);
  } else {
    atrous_pass<kFirst, kLast, false><<<grid, dim3(kBlock, kBlock), 0, st>>>(a);
  }
  return cudaGetLastError();
}

}  // namespace

// One pass. color, albedo, normal: [h, w, 3] f32; depth: [h, w] f32; hit:
// [h, w] u8; work, guide, work_out, guide_out: [h, w] float4 (16-byte
// aligned); image_out: [h, w, 3] f32; all contiguous on the device. The
// first pass (first = 1) reads color, albedo, normal and depth and writes
// guide_out, the others read work and guide; every pass but the last
// (last = 1) writes work_out, the last image_out. albedo is read where
// demodulate is 1, by the first and the last pass.
extern "C" int csgr_atrous_pass(const void* color, const void* albedo, const void* normal,
                                const void* depth, const void* work, const void* guide,
                                const void* hit, void* work_out, void* guide_out, void* image_out,
                                int h, int w, int step, int first, int last, int demodulate,
                                int squarings, float inv_sig_c2, float inv_sig_z2,
                                float sigma_normal, void* stream) {
  if (h < 1 || w < 1 || step < 1) return static_cast<int>(cudaErrorInvalidValue);
  PassArgs a;
  a.color = static_cast<const float*>(color);
  a.albedo = static_cast<const float*>(albedo);
  a.normal = static_cast<const float*>(normal);
  a.depth = static_cast<const float*>(depth);
  a.work = static_cast<const float4*>(work);
  a.guide = static_cast<const float4*>(guide);
  a.hit = static_cast<const uint8_t*>(hit);
  a.work_out = static_cast<float4*>(work_out);
  a.guide_out = static_cast<float4*>(guide_out);
  a.image_out = static_cast<float*>(image_out);
  a.h = h; a.w = w; a.step = step; a.squarings = squarings;
  a.inv_sig_c2 = inv_sig_c2; a.inv_sig_z2 = inv_sig_z2; a.sigma_normal = sigma_normal;
  a.demodulate = demodulate;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (first) return static_cast<int>(last ? launch<true, true>(a, st) : launch<true, false>(a, st));
  return static_cast<int>(last ? launch<false, true>(a, st) : launch<false, false>(a, st));
}

extern "C" const char* csgr_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
