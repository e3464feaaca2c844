// K2: masked max-|z| of a feature matrix, the z-score prefilter's statistic.
//
// Replaces two TPU kernels of strainer_gan_tpu/kernels/zscore.py:
//   K2a  :30 column_stats            (pallas_call at :51) -> sg_zscore_column_stats
//   K2b  :78 max_abs_zscores_pallas  (pallas_call at :99) -> sg_zscore_row_max
// and is held to the function the JAX package actually runs,
// strainer_gan_tpu/strain/thresholds.py:25-48 _masked_max_abs_z, which the
// Pallas template does not implement: it takes a `valid` row mask (weights
// w in {0,1}), uses a two-pass centred variance, and gives z = 0 on a
// column whose std is 0.
//   n = max(sum w, 1);  mean = sum(w x) / n
//   var = sum(w (x - mean)^2) / max(n - 1, 1)      ("torch", Bessel)
//       = sum(w (x - mean)^2) / n, std += 1e-7     ("numpy_eps")
//   out[r] = max_c |x[r,c] - mean[c]| / std[c]  (0 where std[c] == 0)
//
// Bound on the H100: memory.  F is (N, D) float32, read at least once:
// 143 MB at the main path's N = 70,000, D = 512, or 43 us at 3.35 TB/s;
// the arithmetic is a few operations per element.  This design reads F
// three times (column sum, centred column square sum, row pass), so it
// is bounded at about 3x that: the price of the two-pass variance, which
// keeps the mean's cancellation out of the std the threshold compares
// against.  Fusing the first two passes (Welford or a shifted one-pass)
// is later work.
//
// Column passes: one block per chunk of kChunkRows rows; thread c walks
// its column(s) down the chunk, so a warp reads 32 consecutive floats of
// one row (coalesced).  Each block writes one partial row; a small second
// launch sums the partials per column in double.  No atomics, so the
// result is the same on every run.  Row pass: one warp per row, lanes
// stride across the D contiguous floats, and a shuffle max finishes it.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kChunkRows = 64;
constexpr int kColThreads = 256;

__global__ void col_partial_kernel(const float* __restrict__ f,
                                   const uint8_t* __restrict__ valid,
                                   const float* __restrict__ center,
                                   int64_t n, int d, float* __restrict__ partial,
                                   float* __restrict__ partial_cnt) {
  const int64_t chunk = blockIdx.x;
  const int64_t r0 = chunk * kChunkRows;
  const int64_t r1 = r0 + kChunkRows < n ? r0 + kChunkRows : n;
  for (int c = threadIdx.x; c < d; c += blockDim.x) {
    const float mu = center == nullptr ? 0.0f : center[c];
    float acc = 0.0f;
    for (int64_t r = r0; r < r1; ++r) {
      if (valid != nullptr && !valid[r]) continue;
      const float v = f[r * d + c];
      if (center == nullptr) {
        acc += v;
      } else {
        const float dv = v - mu;
        acc += dv * dv;
      }
    }
    partial[chunk * d + c] = acc;
  }
  if (partial_cnt != nullptr && threadIdx.x == 0) {
    int cnt = 0;
    for (int64_t r = r0; r < r1; ++r) cnt += (valid == nullptr || valid[r]) ? 1 : 0;
    partial_cnt[chunk] = (float)cnt;
  }
}

__device__ double valid_count(const float* __restrict__ partial_cnt, int chunks) {
  double cnt = 0.0;
  for (int k = 0; k < chunks; ++k) cnt += partial_cnt[k];
  return cnt > 1.0 ? cnt : 1.0;  // n = max(sum w, 1)
}

__global__ void col_finish_mean_kernel(const float* __restrict__ partial,
                                       const float* __restrict__ partial_cnt,
                                       int chunks, int d, float* __restrict__ mean) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= d) return;
  const double n = valid_count(partial_cnt, chunks);
  double s = 0.0;
  for (int k = 0; k < chunks; ++k) s += partial[(int64_t)k * d + c];
  mean[c] = (float)(s / n);
}

__global__ void col_finish_std_kernel(const float* __restrict__ partial,
                                      const float* __restrict__ partial_cnt,
                                      int chunks, int d, int bessel, float eps,
                                      float* __restrict__ std_out) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= d) return;
  const double n = valid_count(partial_cnt, chunks);
  double s = 0.0;
  for (int k = 0; k < chunks; ++k) s += partial[(int64_t)k * d + c];
  const double denom = bessel ? (n - 1.0 > 1.0 ? n - 1.0 : 1.0) : n;
  std_out[c] = (float)sqrt(s / denom) + eps;
}

__device__ __forceinline__ float nan_max(float a, float b) {
  // max that keeps a NaN, as torch.amax does
  return (a != a || a > b) ? a : b;
}

__global__ void row_max_kernel(const float* __restrict__ f,
                               const float* __restrict__ mean,
                               const float* __restrict__ std_in, int64_t n,
                               int d, float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const int64_t stride = (int64_t)gridDim.x * warps;
  for (int64_t row = (int64_t)blockIdx.x * warps + (threadIdx.x >> 5); row < n;
       row += stride) {
    const float* fr = f + row * d;
    float m = 0.0f;  // every |z| is >= 0
    for (int c = lane; c < d; c += 32) {
      const float s = std_in[c];
      const float z = s == 0.0f ? 0.0f : __fdiv_rn(fabsf(fr[c] - mean[c]), s);
      m = nan_max(z, m);
    }
    for (int off = 16; off > 0; off >>= 1)
      m = nan_max(__shfl_xor_sync(0xffffffffu, m, off), m);
    if (lane == 0) out[row] = m;
  }
}

}  // namespace

extern "C" int sg_zscore_chunk_rows() { return kChunkRows; }

// mean/std of each column over the valid rows.  `valid` may be NULL (all
// rows valid).  `partial` is (ceil(n / chunk_rows), d) float32 scratch and
// `partial_cnt` (ceil(n / chunk_rows),) float32 scratch, both owned by the
// caller.  Four launches on `stream`: sum, finish mean, centred square sum,
// finish std.
extern "C" int sg_zscore_column_stats(int device, const float* f,
                                      const uint8_t* valid, int64_t n, int d,
                                      int bessel, float eps, float* partial,
                                      float* partial_cnt, float* mean,
                                      float* std_out, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const int64_t chunks = (n + kChunkRows - 1) / kChunkRows;
  const int fin_threads = 128;
  const unsigned fin_blocks = (unsigned)((d + fin_threads - 1) / fin_threads);
  col_partial_kernel<<<(unsigned)chunks, kColThreads, 0, s>>>(
      f, valid, nullptr, n, d, partial, partial_cnt);
  col_finish_mean_kernel<<<fin_blocks, fin_threads, 0, s>>>(
      partial, partial_cnt, (int)chunks, d, mean);
  col_partial_kernel<<<(unsigned)chunks, kColThreads, 0, s>>>(
      f, valid, mean, n, d, partial, nullptr);
  col_finish_std_kernel<<<fin_blocks, fin_threads, 0, s>>>(
      partial, partial_cnt, (int)chunks, d, bessel, eps, std_out);
  return (int)cudaGetLastError();
}

// out[r] = max_c |f[r,c] - mean[c]| / std[c], 0 where std[c] == 0.
extern "C" int sg_zscore_row_max(int device, const float* f, const float* mean,
                                 const float* std_in, int64_t n, int d,
                                 float* out, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n > 0) {
    const int threads = 256;
    int64_t blocks = (n + (threads / 32) - 1) / (threads / 32);
    if (blocks > 132 * 32) blocks = 132 * 32;
    row_max_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        f, mean, std_in, n, d, out);
  }
  return (int)cudaGetLastError();
}
