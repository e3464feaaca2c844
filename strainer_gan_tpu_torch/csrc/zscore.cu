// K2: masked max-|z| of a feature matrix, the z-score prefilter's statistic.
//
// Replaces two TPU kernels of strainer_gan_tpu/kernels/zscore.py:
//   K2a  :30 column_stats            (pallas_call at :51) -> sg_zscore_column_stats
//   K2b  :78 max_abs_zscores_pallas  (pallas_call at :99) -> sg_zscore_row_max
// and is held to the function the JAX package actually runs,
// strainer_gan_tpu/strain/thresholds.py:25-48 _masked_max_abs_z, which the
// Pallas template does not implement: it takes a `valid` row mask (weights
// w in {0,1}), uses a centred (two-pass quality) variance, and gives z = 0
// on a column whose std is 0.
//   n = max(sum w, 1);  mean = sum(w x) / n
//   var = sum(w (x - mean)^2) / max(n - 1, 1)      ("torch", Bessel)
//       = sum(w (x - mean)^2) / n, std += 1e-7     ("numpy_eps")
//       = sum(w (x - mean)^2) / n                  ("population")
//   out[r] = max_c |x[r,c] - mean[c]| / std[c]  (0 where std[c] == 0)
//
// Bound on the H100: memory.  F is (N, D) float32 and must be read once:
// 143 MB at the main path's N = 70,000, D = 512, or 43 us at 3.35 TB/s;
// the arithmetic is a few operations per element.
//
// K2a, two launches, one read of F:
// 1. Column pass.  One block per chunk of rows; its threads are 128 column
//    lanes x 4 row groups.  A lane owns a float4 of columns (16-byte loads,
//    a warp reading 512 consecutive bytes of one row) and runs Welford's
//    update over its row group's rows in float32: count, mean and centred
//    sum of squares M2, so F is read once and the variance is still
//    centred.  Four rows are loaded before they are folded in, to keep
//    loads in flight.  The four row groups merge in shared memory with
//    Chan's formula, and the block writes one (count, mean, M2) partial
//    per column.  Chunks are sized so the grid is about two waves of
//    resident blocks on the card's SMs.
// 2. Finish.  One block per 32 columns; 32 lanes per column each merge a
//    strided share of the partials with Chan's formula in double (loads
//    batched four at a time), then a fixed tree merges the 32 lanes.  No
//    atomics and a fixed order, so the result is the same on every run;
//    the count is merged with the rest, once per block.
// A constant column stays exact: every delta is 0, so M2 = 0 and the std
// is exactly the mode's eps.
//
// K2b, one launch, one read of F.  A warp walks rows in a grid-stride
// loop; lane l owns the float4 column groups l + 32k (k < D/128, templated),
// so at D = 512 a row is 4 float4 loads a lane, all issued before any is
// used, and a shuffle max finishes the row.  Each lane loads its 16
// columns' mean and std into registers once, for every row it walks: no
// per-element loads but F's.  68 registers let 3 blocks of 8 warps reside
// on an SM, 48 KB of rows in flight, and the grid is about two waves of
// them.  The quotient is __fdiv_rn, correctly rounded, so the kernel
// equals its plain version bit for bit; on the card this was faster than
// a reciprocal with Markstein's FMA correction and its range guard.  Rows
// of another width, or misaligned, take a scalar path: one warp a row,
// per-element mean/std loads.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;      // column lanes of a column-pass block
constexpr int kRowGroups = 4;    // row groups of a column-pass block
constexpr int kUnroll = 4;       // rows loaded before they are folded in
constexpr int kMinChunkRows = 64;
constexpr int kFinCols = 32;     // columns of a finishing block
constexpr int kFinLanes = 32;    // partial lanes per column

template <int V> struct Vec;
template <> struct Vec<1> {
  static __device__ __forceinline__ void load(const float* p, float* v) { v[0] = *p; }
};
template <> struct Vec<4> {
  static __device__ __forceinline__ void load(const float* p, float* v) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  }
};

// Chan et al.'s merge of (nb, mb, qb) into (na, ma, qa): counts, means, M2.
template <typename T>
__device__ __forceinline__ void chan_merge(T& na, T& ma, T& qa, T nb, T mb, T qb) {
  if (nb == T(0)) return;
  const T n = na + nb;
  const T delta = mb - ma;
  const T f = nb / n;
  ma += delta * f;
  qa += qb + delta * delta * na * f;
  na = n;
}

template <int V>
__global__ void __launch_bounds__(kLanes * kRowGroups)
col_welford_kernel(const float* __restrict__ f, const uint8_t* __restrict__ valid,
                   int64_t n, int d, int64_t rows_per_chunk,
                   float* __restrict__ pmean, float* __restrict__ pm2,
                   int* __restrict__ pcnt) {
  __shared__ float s_mean[kRowGroups][kLanes * V];
  __shared__ float s_m2[kRowGroups][kLanes * V];
  __shared__ int s_n[kRowGroups];
  const int lane = threadIdx.x;
  const int grp = threadIdx.y;
  const int64_t chunk = blockIdx.x;
  const int64_t r0 = chunk * rows_per_chunk;
  const int64_t r1 = r0 + rows_per_chunk < n ? r0 + rows_per_chunk : n;
  const int dq = d / V;

  for (int q0 = 0; q0 < dq; q0 += kLanes) {
    const int q = q0 + lane;
    float mean[V], m2[V];
#pragma unroll
    for (int k = 0; k < V; ++k) mean[k] = m2[k] = 0.f;
    int cnt = 0;
    for (int64_t r = r0 + grp; r < r1; r += (int64_t)kRowGroups * kUnroll) {
      float v[kUnroll][V];
      bool take[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int64_t ru = r + (int64_t)u * kRowGroups;
        take[u] = ru < r1 && q < dq && (valid == nullptr || valid[ru]);
        if (take[u]) Vec<V>::load(f + ru * d + (int64_t)q * V, v[u]);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (!take[u]) continue;
        ++cnt;
        const float inv = __frcp_rn((float)cnt);
#pragma unroll
        for (int k = 0; k < V; ++k) {
          const float delta = v[u][k] - mean[k];
          mean[k] = fmaf(delta, inv, mean[k]);
          m2[k] = fmaf(delta, v[u][k] - mean[k], m2[k]);
        }
      }
    }
    // every lane of a row group saw the same rows; lanes past dq counted none
    if (lane == 0) s_n[grp] = 0;
    __syncthreads();
    if (q < dq && cnt > 0) s_n[grp] = cnt;  // benign: all writers agree
#pragma unroll
    for (int k = 0; k < V; ++k) {
      s_mean[grp][lane * V + k] = mean[k];
      s_m2[grp][lane * V + k] = m2[k];
    }
    __syncthreads();
    if (grp == 0 && q < dq) {
#pragma unroll
      for (int k = 0; k < V; ++k) {
        double na = s_n[0], ma = s_mean[0][lane * V + k], qa = s_m2[0][lane * V + k];
        for (int g = 1; g < kRowGroups; ++g)
          chan_merge<double>(na, ma, qa, (double)s_n[g], (double)s_mean[g][lane * V + k],
                             (double)s_m2[g][lane * V + k]);
        pmean[chunk * d + (int64_t)q * V + k] = (float)ma;
        pm2[chunk * d + (int64_t)q * V + k] = (float)qa;
      }
    }
    if (q0 == 0 && grp == 0 && lane == 0) {
      int total = 0;
      for (int g = 0; g < kRowGroups; ++g) total += s_n[g];
      pcnt[chunk] = total;
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kFinCols * kFinLanes)
col_finish_kernel(const float* __restrict__ pmean, const float* __restrict__ pm2,
                  const int* __restrict__ pcnt, int chunks, int d, int bessel,
                  float eps, float* __restrict__ mean_out, float* __restrict__ std_out) {
  __shared__ double s_n[kFinLanes][kFinCols];
  __shared__ double s_mean[kFinLanes][kFinCols];
  __shared__ double s_m2[kFinLanes][kFinCols];
  const int x = threadIdx.x, y = threadIdx.y;
  const int c = blockIdx.x * kFinCols + x;
  double na = 0.0, ma = 0.0, qa = 0.0;
  if (c < d) {
    for (int k0 = y; k0 < chunks; k0 += 4 * kFinLanes) {
      int nb[4];
      float mb[4], qb[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int k = k0 + u * kFinLanes;
        nb[u] = k < chunks ? pcnt[k] : 0;
        mb[u] = k < chunks ? pmean[(int64_t)k * d + c] : 0.f;
        qb[u] = k < chunks ? pm2[(int64_t)k * d + c] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
        chan_merge<double>(na, ma, qa, (double)nb[u], (double)mb[u], (double)qb[u]);
    }
  }
  s_n[y][x] = na;
  s_mean[y][x] = ma;
  s_m2[y][x] = qa;
  __syncthreads();
  for (int half = kFinLanes / 2; half > 0; half >>= 1) {
    if (y < half) {
      double nb = s_n[y][x], mb = s_mean[y][x], qb = s_m2[y][x];
      chan_merge<double>(nb, mb, qb, s_n[y + half][x], s_mean[y + half][x],
                         s_m2[y + half][x]);
      s_n[y][x] = nb;
      s_mean[y][x] = mb;
      s_m2[y][x] = qb;
    }
    __syncthreads();
  }
  if (y == 0 && c < d) {
    const double nv = s_n[0][x] > 1.0 ? s_n[0][x] : 1.0;  // n = max(sum w, 1)
    const double denom = bessel ? (nv - 1.0 > 1.0 ? nv - 1.0 : 1.0) : nv;
    mean_out[c] = (float)s_mean[0][x];
    std_out[c] = (float)sqrt(s_m2[0][x] / denom) + eps;
  }
}

__device__ __forceinline__ float nan_max(float a, float b) {
  // max that keeps a NaN, as torch.amax does (one instruction on sm_80+)
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

constexpr int kRowThreads = 256;
constexpr int kMaxGroups = 4;  // float4 groups a lane owns: D <= 512

// |x - mean| / std rounded to nearest, 0 where std == 0: the plain version.
__device__ __forceinline__ float abs_z(float x, float mean, float std) {
  return std == 0.0f ? 0.0f : __fdiv_rn(fabsf(__fsub_rn(x, mean)), std);
}

__device__ __forceinline__ float warp_max(float m) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) m = nan_max(__shfl_xor_sync(0xffffffffu, m, off), m);
  return m;
}

// G float4 groups a lane: D <= 128 G, D % 4 == 0, rows 16-byte aligned.
template <int G>
__global__ void __launch_bounds__(kRowThreads, 2)
row_max_vec_kernel(const float* __restrict__ f, const float* __restrict__ mean,
                   const float* __restrict__ std_in, int64_t n, int d,
                   float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const int64_t stride = (int64_t)gridDim.x * warps;
  const int dq = d >> 2;
  // column 4(lane + 32g) + j; padding columns get std 0, so z = 0 there
  float mu[G][4], sd[G][4];
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = 4 * (lane + 32 * g) + j;
      mu[g][j] = c < d ? mean[c] : 0.0f;
      sd[g][j] = c < d ? std_in[c] : 0.0f;
    }
  }
  for (int64_t row = (int64_t)blockIdx.x * warps + (threadIdx.x >> 5); row < n;
       row += stride) {
    const float4* fr = reinterpret_cast<const float4*>(f + row * d);
    float4 v[G];
#pragma unroll
    for (int g = 0; g < G; ++g)  // all loads of the row before any use
      v[g] = lane + 32 * g < dq ? __ldcs(fr + lane + 32 * g) : make_float4(0.f, 0.f, 0.f, 0.f);
    float m = 0.0f;  // every |z| is >= 0
#pragma unroll
    for (int g = 0; g < G; ++g) {
      m = nan_max(abs_z(v[g].x, mu[g][0], sd[g][0]), m);
      m = nan_max(abs_z(v[g].y, mu[g][1], sd[g][1]), m);
      m = nan_max(abs_z(v[g].z, mu[g][2], sd[g][2]), m);
      m = nan_max(abs_z(v[g].w, mu[g][3], sd[g][3]), m);
    }
    m = warp_max(m);
    if (lane == 0) out[row] = m;
  }
}

// Any D and alignment: one warp a row, lanes stride across the columns.
__global__ void row_max_scalar_kernel(const float* __restrict__ f,
                                      const float* __restrict__ mean,
                                      const float* __restrict__ std_in, int64_t n,
                                      int d, float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const int64_t stride = (int64_t)gridDim.x * warps;
  for (int64_t row = (int64_t)blockIdx.x * warps + (threadIdx.x >> 5); row < n;
       row += stride) {
    const float* fr = f + row * d;
    float m = 0.0f;
    for (int c = lane; c < d; c += 32) m = nan_max(abs_z(fr[c], mean[c], std_in[c]), m);
    m = warp_max(m);
    if (lane == 0) out[row] = m;
  }
}

// Launch one of the row kernels on a grid of about two waves of its
// resident blocks (fewer for a small n), each warp walking rows.
template <typename K>
void launch_rows(K kernel, int device, const float* f, const float* mean,
                 const float* std_in, int64_t n, int d, float* out, cudaStream_t s) {
  int sms = 132, per_sm = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kRowThreads, 0);
  const int64_t waves = 2LL * sms * (per_sm < 1 ? 1 : per_sm);
  int64_t blocks = (n + kRowThreads / 32 - 1) / (kRowThreads / 32);
  if (blocks > waves) blocks = waves;
  kernel<<<(unsigned)blocks, kRowThreads, 0, s>>>(f, mean, std_in, n, d, out);
}

}  // namespace

// Number of row chunks (column-pass blocks, and partial rows) that
// sg_zscore_column_stats uses for an (n, d) matrix on `device`: about two
// waves of resident blocks, each of at least kMinChunkRows rows.
extern "C" int64_t sg_zscore_stats_chunks(int device, int64_t n, int d) {
  int sms = 132, per_sm = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, col_welford_kernel<4>,
                                                kLanes * kRowGroups, 0);
  if (per_sm < 1) per_sm = 1;
  const int64_t waves = 2LL * sms * per_sm;
  int64_t chunks = (n + kMinChunkRows - 1) / kMinChunkRows;
  if (chunks > waves) chunks = waves;
  return chunks < 1 ? 1 : chunks;
}

// mean/std of each column over the valid rows.  `valid` may be NULL (all
// rows valid).  `pmean`, `pm2` are (chunks, d) float32 and `pcnt` (chunks,)
// int32 scratch owned by the caller, chunks = sg_zscore_stats_chunks(...).
// Two launches on `stream`: the column pass and the finish.
extern "C" int sg_zscore_column_stats(int device, const float* f,
                                      const uint8_t* valid, int64_t n, int d,
                                      int bessel, float eps, int64_t chunks,
                                      float* pmean, float* pm2, int* pcnt,
                                      float* mean, float* std_out, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0 || d <= 0 || chunks <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const int64_t rows_per_chunk = (n + chunks - 1) / chunks;
  const unsigned grid = (unsigned)((n + rows_per_chunk - 1) / rows_per_chunk);
  const dim3 block(kLanes, kRowGroups);
  if (d % 4 == 0 && ((uintptr_t)f & 15) == 0)
    col_welford_kernel<4><<<grid, block, 0, s>>>(f, valid, n, d, rows_per_chunk,
                                                 pmean, pm2, pcnt);
  else
    col_welford_kernel<1><<<grid, block, 0, s>>>(f, valid, n, d, rows_per_chunk,
                                                 pmean, pm2, pcnt);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  col_finish_kernel<<<(unsigned)((d + kFinCols - 1) / kFinCols), dim3(kFinCols, kFinLanes),
                      0, s>>>(pmean, pm2, pcnt, (int)grid, d, bessel, eps, mean, std_out);
  return (int)cudaGetLastError();
}

// out[r] = max_c |f[r,c] - mean[c]| / std[c], 0 where std[c] == 0.
extern "C" int sg_zscore_row_max(int device, const float* f, const float* mean,
                                 const float* std_in, int64_t n, int d,
                                 float* out, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0 || d <= 0) return (int)cudaGetLastError();
  const cudaStream_t s = (cudaStream_t)stream;
  const int groups = (d + 127) / 128;
  const bool vec = d % 4 == 0 && groups <= kMaxGroups && ((uintptr_t)f & 15) == 0;
  switch (vec ? groups : 0) {
    case 1: launch_rows(row_max_vec_kernel<1>, device, f, mean, std_in, n, d, out, s); break;
    case 2: launch_rows(row_max_vec_kernel<2>, device, f, mean, std_in, n, d, out, s); break;
    case 3: launch_rows(row_max_vec_kernel<3>, device, f, mean, std_in, n, d, out, s); break;
    case 4: launch_rows(row_max_vec_kernel<4>, device, f, mean, std_in, n, d, out, s); break;
    default: launch_rows(row_max_scalar_kernel, device, f, mean, std_in, n, d, out, s); break;
  }
  return (int)cudaGetLastError();
}
