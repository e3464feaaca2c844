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
// SFU's rate.  At that size the launch costs more than the traffic, so the
// design is about the launch: the scoring pass calls it ONCE per strain
// event over the whole (N,) logit buffer, writing the losses over the
// logits (out may equal x: each element is read before it is written, by
// the same thread, so the pointers carry no __restrict__); the C entry
// touches the device only when it is not already current; the kernel
// moves float4s where both buffers are 16-byte aligned, then a scalar
// tail, one thread per float4 in a grid-stride loop.
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

constexpr int kThreads = 256;

__device__ __forceinline__ float clamp_log(float v) {
  // max(v, -100) that keeps a NaN, as torch.clamp_min does
  return v < -100.0f ? -100.0f : v;
}

__device__ __forceinline__ float bce(float x, float t, float one_minus_t) {
  float p = __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-x)));
  if (p < FLT_MIN) p = 0.0f;
  const float log_p = clamp_log(logf(p));
  const float log_1mp = clamp_log(log1pf(-p));
  return -__fadd_rn(__fmul_rn(t, log_p), __fmul_rn(one_minus_t, log_1mp));
}

// The first n4 float4s as vectors (n4 = 0 when a buffer is misaligned),
// then the elements from 4 n4 on one by one.
__global__ void bce_scores_kernel(const float* x, float* out, int64_t n, int64_t n4,
                                  float t, float one_minus_t) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t first = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  for (int64_t i = first; i < n4; i += stride) {
    const float4 v = reinterpret_cast<const float4*>(x)[i];
    reinterpret_cast<float4*>(out)[i] =
        make_float4(bce(v.x, t, one_minus_t), bce(v.y, t, one_minus_t),
                    bce(v.z, t, one_minus_t), bce(v.w, t, one_minus_t));
  }
  for (int64_t i = 4 * n4 + first; i < n; i += stride) out[i] = bce(x[i], t, one_minus_t);
}

}  // namespace

extern "C" int sg_bce_scores(int device, const float* x, float* out, int64_t n,
                             float target, void* stream) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n > 0) {
    const bool vec = (((uintptr_t)x | (uintptr_t)out) & 15) == 0;
    const int64_t n4 = vec ? n / 4 : 0;
    const int64_t items = n4 + (n - 4 * n4);
    int64_t blocks = (items + kThreads - 1) / kThreads;
    if (blocks > 132 * 16) blocks = 132 * 16;
    bce_scores_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
        x, out, n, n4, target, 1.0f - target);
  }
  return (int)cudaGetLastError();
}
