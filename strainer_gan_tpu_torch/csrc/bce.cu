// K1: per-sample BCE scores from discriminator logits.
//
// Replaces the TPU kernel strainer_gan_tpu/kernels/bce.py:22
// bce_scores_pallas (pallas_call at :38), and is held to the function the
// JAX package actually runs, strainer_gan_tpu/ops/losses.py:22
// bce_from_logits:
//   out[i] = -( t * max(log p, -100) + (1 - t) * max(log1p(-p), -100) ),
//   p = 1 / (1 + exp(-x[i])) materialised in float32, t a scalar target,
//   a subnormal p flushed to 0 as XLA does (logits below about -87.3).
//
// Bound on the H100: pure streaming, 4 bytes read and 4 written per
// element (0.56 MB at the main path's N = 70,000), i.e. 0.17 us at
// 3.35 TB/s; the three transcendentals per element are far below the
// SFU's rate.  Design: one thread per element in a grid-stride loop, each
// element read once and written once, no shared memory.  At N = 70k the
// launch itself costs more than the traffic, which is why the scoring
// pass calls it ONCE per strain event over the whole (N,) logit buffer.
//
// Rounding: every multiply and add is an explicit round-to-nearest
// intrinsic, so nvcc cannot contract them into FMAs and the result
// matches the plain PyTorch version (ops/losses.py) operation for
// operation; expf/logf/log1pf are the same CUDA math library calls
// PyTorch's own elementwise kernels make.
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float clamp_log(float v) {
  // max(v, -100) that keeps a NaN, as torch.clamp_min does
  return v < -100.0f ? -100.0f : v;
}

__global__ void bce_scores_kernel(const float* __restrict__ x,
                                  float* __restrict__ out, int64_t n,
                                  float t, float one_minus_t) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    float p = __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-x[i])));
    if (p < FLT_MIN) p = 0.0f;
    const float log_p = clamp_log(logf(p));
    const float log_1mp = clamp_log(log1pf(-p));
    out[i] = -__fadd_rn(__fmul_rn(t, log_p), __fmul_rn(one_minus_t, log_1mp));
  }
}

}  // namespace

extern "C" int sg_bce_scores(int device, const float* x, float* out, int64_t n,
                             float target, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n > 0) {
    const int threads = 256;
    int64_t blocks = (n + threads - 1) / threads;
    if (blocks > 132 * 16) blocks = 132 * 16;
    bce_scores_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        x, out, n, target, 1.0f - target);
  }
  return (int)cudaGetLastError();
}
