// The shard canary: o = 2 x on one [8, 128] f32 block.
//
// Replaces tests/test_parallel.py::test_pallas_vma_checker_still_unsupported's
// `kern` (the Pallas kernel that its pl.pallas_call launches inside
// shard_map(check_vma=True) on a 2x2 mesh). In JAX that canary shows that
// jax's varying-axes checker still cannot type a Pallas kernel inside a
// sharded region, which is why parallel/shard.py::render_scene_sharded
// needs check_vma=False. torch.distributed has no such checker: each rank
// launches its kernels as a single-device caller does. So the port's
// canary asserts the opposite: this kernel, launched in every rank of a
// 2x2 mesh on an input that varies with the tile index, returns 2 x on
// each rank, bit for bit.
//
// Design: one CTA of 1024 threads, one element each; a product by 2 is
// exact in f32, so the result equals torch.mul(x, 2.0) to the bit. What
// bounds it: 8,192 bytes moved (4 KB in, 4 KB out), far under the launch
// latency; the kernel is the simplest that runs a hand kernel per rank.

#include <cuda_runtime.h>

namespace {

constexpr int kElems = 8 * 128;

__global__ void __launch_bounds__(kElems) scale2(const float* __restrict__ x,
                                                 float* __restrict__ o) {
  const int i = threadIdx.x;
  o[i] = x[i] * 2.0f;
}

}  // namespace

// x, o: [8, 128] f32, contiguous, on the device.
extern "C" int csgr_scale2(const void* x, void* o, void* stream) {
  scale2<<<1, kElems, 0, static_cast<cudaStream_t>(stream)>>>(static_cast<const float*>(x),
                                                              static_cast<float*>(o));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* csgr_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
