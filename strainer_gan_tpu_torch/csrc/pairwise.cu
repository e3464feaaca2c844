// K3: weighted neighbour counts within eps, DBSCAN's noise test.
//
// Replaces the TPU kernel strainer_gan_tpu/kernels/pairwise.py:25
// neighbor_counts_pallas (pallas_call at :75), which :93
// dbscan_non_noise_pallas calls twice:
//   counts[i] = sum_j w[j] * [ ||x_i - x_j||^2 <= eps^2 ]   (self included)
// for valid rows i; an invalid row counts nothing (0) and, because the
// caller folds `valid` into w, is counted by nothing.  w is 0/1 (uint8).
//
// Bound on the H100: operations.  Each pass compares all N^2 pairs over D
// features: 2*N^2*D flops, 1.6e12 at the zscore_dbscan path's N = 40,000,
// D = 512, against 164 MB of input.  The decisions are exact `<= eps^2`
// tests, so the arithmetic stays float32 on the CUDA cores (TF32 keeps
// about three decimal digits and would move pairs across eps).
//
// Form: the direct sum  d2 = sum_k (a_k - b_k)^2  with one subtract and
// one FMA per element, not the TPU kernel's expansion |a|^2 + |b|^2 - 2ab
// (one FMA per element).  The direct form costs twice the instructions
// but has no cancellation: its rounding error is relative to d2 itself,
// where the expansion's is relative to |a|^2 + |b|^2, which for
// standardised 512-wide features is about 1024 against eps^2 = 400.
// Moving the products to the tensor cores in 3xTF32 (with the expansion)
// is the redesign for a later change.
//
// Design: a 128x128 tile of pairs per block iteration, 256 threads, each
// thread holding an 8x8 register micro-tile of d2.  Both operand tiles are
// staged through shared memory 16 features at a time, stored transposed
// (feature-major) so a thread reads its 8 rows and 8 columns as float4s.
// Each block owns one 128-row tile and walks a contiguous range of column
// tiles itself; the column range is split over gridDim.y blocks only so
// that a small N still fills the card.  Per-row counts stay in registers,
// are summed over the 16 threads that share a row with shuffles, and are
// added to the int32 output with one atomicAdd per row and block: integer
// sums, so the result is the same on every run.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;      // rows of a tile
constexpr int kBN = 128;      // columns of a tile
constexpr int kBK = 16;       // features staged per step
constexpr int kThreads = 256; // 16 x 16 threads, 8 x 8 pairs each

__device__ __forceinline__ int tile_offset(int t, int lane16) {
  // micro-tile index t in [0, 8) of thread lane16 -> offset in the tile:
  // two groups of four, 64 apart, so a quarter-warp's float4 reads are
  // contiguous in shared memory
  return (t < 4 ? 0 : 64) + lane16 * 4 + (t & 3);
}

__device__ __forceinline__ void load_tile(const float* __restrict__ x, int n,
                                          int d, int row0, int k0,
                                          float (*dst)[kBM]) {
  // 128 rows x 16 features = 512 float4s, two per thread
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    const int f = threadIdx.x + p * kThreads;
    const int r = f >> 2;
    const int kq = (f & 3) * 4;
    const int gr = row0 + r;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (gr < n) v = *reinterpret_cast<const float4*>(x + (int64_t)gr * d + k0 + kq);
    dst[kq + 0][r] = v.x;
    dst[kq + 1][r] = v.y;
    dst[kq + 2][r] = v.z;
    dst[kq + 3][r] = v.w;
  }
}

__global__ void __launch_bounds__(kThreads, 2)
neighbor_counts_kernel(const float* __restrict__ x,
                       const uint8_t* __restrict__ row_valid,
                       const uint8_t* __restrict__ col_w, int n, int d,
                       float eps2, int cols_per_block,
                       int* __restrict__ counts) {
  __shared__ __align__(16) float As[kBK][kBM];
  __shared__ __align__(16) float Bs[kBK][kBN];
  const int tx = threadIdx.x & 15;  // column group
  const int ty = threadIdx.x >> 4;  // row group
  const int row0 = blockIdx.x * kBM;
  const int col_begin = blockIdx.y * cols_per_block;
  int col_end = col_begin + cols_per_block;
  if (col_end > n) col_end = n;

  int cnt[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) cnt[i] = 0;

  for (int c0 = col_begin; c0 < col_end; c0 += kBN) {
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

    for (int k0 = 0; k0 < d; k0 += kBK) {
      load_tile(x, n, d, row0, k0, As);
      load_tile(x, n, d, c0, k0, Bs);
      __syncthreads();
#pragma unroll
      for (int k = 0; k < kBK; ++k) {
        const float4 a0 = *reinterpret_cast<const float4*>(&As[k][ty * 4]);
        const float4 a1 = *reinterpret_cast<const float4*>(&As[k][64 + ty * 4]);
        const float4 b0 = *reinterpret_cast<const float4*>(&Bs[k][tx * 4]);
        const float4 b1 = *reinterpret_cast<const float4*>(&Bs[k][64 + tx * 4]);
        const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float t = a[i] - b[j];
            acc[i][j] = fmaf(t, t, acc[i][j]);
          }
      }
      __syncthreads();
    }

#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = c0 + tile_offset(j, tx);
      if (col < col_end && col_w[col]) {
#pragma unroll
        for (int i = 0; i < 8; ++i) cnt[i] += acc[i][j] <= eps2 ? 1 : 0;
      }
    }
  }

  // sum over the 16 threads (tx) of a row group: lanes 0-15 and 16-31 of a
  // warp are two row groups, and xor offsets below 16 stay inside each
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    int v = cnt[i];
    v += __shfl_xor_sync(0xffffffffu, v, 8);
    v += __shfl_xor_sync(0xffffffffu, v, 4);
    v += __shfl_xor_sync(0xffffffffu, v, 2);
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    const int row = row0 + tile_offset(i, ty);
    if (tx == 0 && row < n && v != 0 && (row_valid == nullptr || row_valid[row]))
      atomicAdd(&counts[row], v);
  }
}

}  // namespace

extern "C" int sg_pairwise_feature_step() { return kBK; }

// counts[i] (int32, zeroed by the caller) += #{ j : col_w[j] != 0 and
// ||x_i - x_j||^2 <= eps2 } for each row i with row_valid[i] (row_valid may
// be NULL: every row valid).  x is (n, d) float32, row-major, d a multiple
// of sg_pairwise_feature_step() and 16-byte aligned rows.  One launch on
// `stream`.
extern "C" int sg_neighbor_counts(int device, const float* x,
                                  const uint8_t* row_valid,
                                  const uint8_t* col_w, int n, int d,
                                  float eps2, int* counts, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0) return (int)cudaSuccess;
  if (d <= 0 || d % kBK != 0) return (int)cudaErrorInvalidValue;
  int sms = 132;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const int row_tiles = (n + kBM - 1) / kBM;
  const int col_tiles = (n + kBN - 1) / kBN;
  // split the columns until about four waves of two blocks per SM are in
  // flight; each block keeps at least 8 column tiles to walk
  int splits = (8 * sms + row_tiles - 1) / row_tiles;
  const int max_splits = (col_tiles + 7) / 8;
  if (splits > max_splits) splits = max_splits;
  if (splits < 1) splits = 1;
  const int tiles_per_block = (col_tiles + splits - 1) / splits;
  splits = (col_tiles + tiles_per_block - 1) / tiles_per_block;
  const dim3 grid((unsigned)row_tiles, (unsigned)splits);
  neighbor_counts_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      x, row_valid, col_w, n, d, eps2, tiles_per_block * kBN, counts);
  return (int)cudaGetLastError();
}
