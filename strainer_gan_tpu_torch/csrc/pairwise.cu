// K3: weighted neighbour counts within eps, and DBSCAN's noise test.
//
// Replaces the TPU kernel strainer_gan_tpu/kernels/pairwise.py:25
// neighbor_counts_pallas (pallas_call at :75), which :93
// dbscan_non_noise_pallas calls twice:
//   counts[i] = sum_j w[j] * [ ||x_i - x_j||^2 <= eps^2 ]   (self included)
// for valid rows i; an invalid row counts nothing and, because the caller
// folds `valid` into w, is counted by nothing.  w is 0/1 (uint8).  Pass 2
// is near_core[i] = OR_j adj(i, j) & core[j].
//
// Bound on the H100: operations.  d^2 is symmetric, so the least work is
// the Gram matrix of the N(N+1)/2 pairs i <= j once: N(N+1) D flops, on
// the tensor cores in 3xTF32 (three TF32 products stand in for one f32
// product) at 495/3 TFLOP/s: 5.0 ms at N = 40,000, D = 512.  Pass 2 needs
// no product: it reads pass 1's adjacency, kept as a bitmask.
//
// Launches (sg_pairwise_counts, then sg_dbscan_near_core):
// 1. split: X_hi = tf32_rn(X), X_lo = tf32_rn(X - X_hi) (round to nearest
//    even on the bits), both (N, D') float32 with D' = D padded with zeros
//    to a multiple of 32; sq[i] = sum_k x_ik^2 in double, rounded once.
// 2. gram: persistent blocks (one per SM) walk the upper triangle of
//    128 x 128 tile pairs (I, J), J >= I, in a linear order, so every SM
//    gets the same number of tiles.  Products by `mma.sync` m16n8k8 TF32 (the stated first step; `wgmma` with TMA is
//    the later one).  Operands by `cp.async` into a 3-stage ring of
//    shared memory (A hi, A lo, B hi, B lo; 32 features a stage, rows
//    padded to 36 floats so fragment reads are free of bank conflicts),
//    running ahead across tile boundaries.  8 warps, 64 x 32 pairs each.
//    Per 8-feature step: hi*hi into one f32 accumulator, hi*lo + lo*hi
//    into a second one (so the small terms do not lengthen the big sum's
//    chain).  Epilogue in registers: d2 = (sq_i + sq_j) - 2 g, decided against eps^2
//    unless it lies in the band |d2 - eps^2| <= tau_ij; band pairs go to a
//    list.  Decided pairs add w_j to count[i] and w_i to count[j] (a
//    diagonal tile counts i < j once and self once), summed over the tile
//    with shuffles and shared-memory atomics, then one global atomicAdd per
//    row and column per tile: integer sums, the same on every run.  The
//    tile's decisions are written once as 512 packed 32-bit words.
// 3. band: one warp per listed pair redecides it by the direct form
//    sum_k (a_k - b_k)^2 in f32 (its error is relative to d2, not to
//    sq_i + sq_j), adds its counts and ORs its bit.  The list has a fixed
//    capacity; the wrapper reads the pair count and, if it overflowed,
//    grows the list and runs the call again: no pair is dropped.
// 4. near_core: per tile, each row's 4 words against the packed core bits
//    of J, and the rows' core bits against the words for the columns;
//    stores of 1 only, so the result is the same on every run.
//
// tau_ij = tau_coef * (sq_i + sq_j), tau_coef = (D'/8 + 16) 2^-22, a
// worst-case bound on |d2_computed - d2_exact| (valid for D' <= 4096):
// - split: hi has 11 significant bits, so |x - hi| <= 2^-11 |x| (exact in
//   f32) and x = hi + lo + e with |e| <= 2^-22 |x|.  Dropping lo*lo and
//   the e terms costs <= 3.01 * 2^-22 |a||b| per feature, so
//   <= 3.01 * 2^-22 S with S = sum_k |a_k b_k| <= (sq_i + sq_j) / 2.
// - products of TF32 values are exact in f32 (22 significant bits).
//   Every addition, in the tensor core or into the accumulator, is taken
//   to err by at most u = 2^-22 relative (two f32 ulps: covers truncation
//   in place of rounding).  A hi*hi product passes through at most 8
//   additions inside its mma and D'/8 accumulator updates:
//   <= 1.001 (8 + D'/8) u S.  The hi*lo + lo*hi sum is <= 2^-10 1.001 S,
//   so its own error (8 + D'/4) u 2^-10 S is <= 0.14 u S at D' = 512;
//   adding the two accumulators: <= 0.26 u S.
// - g enters d2 twice (2 g), and 2 S <= sq_i + sq_j, so the Gram error
//   is <= (D'/8 + 11.5) u (sq_i + sq_j) at D' = 512; the norms' rounding
//   to f32 and the two f32 operations of the epilogue add <= u (sq_i + sq_j).
// That is <= (D'/8 + 12.5) u (sq_i + sq_j); the 3.5 u left is margin for
// the rounding of tau and of d2 - eps^2.  Off the band, therefore, the
// decision equals the exact one; in the band it is the direct form's.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 128;                 // rows of a tile, both ways
constexpr int kBK = 32;                    // features per pipeline stage
constexpr int kLd = kBK + 4;               // shared row stride: conflict-free fragments
constexpr int kStages = 3;
constexpr int kThreads = 256;              // 8 warps: 2 (rows) x 4 (columns)
constexpr int kTileWords = kTile * kTile / 32;
constexpr int kArr = kTile * kLd;          // floats of one operand array in a stage
constexpr int kStageFloats = 4 * kArr;     // A hi, A lo, B hi, B lo
constexpr int kSmemBytes = kStages * kStageFloats * (int)sizeof(float);

// round to the 10 explicit mantissa bits of TF32, to nearest, ties to even
__device__ __forceinline__ float tf32_rne(float x) {
  const uint32_t u = __float_as_uint(x);
  if ((u & 0x7f800000u) == 0x7f800000u) return x;  // inf, nan
  return __uint_as_float((u + 0xfffu + ((u >> 13) & 1u)) & 0xffffe000u);
}

__global__ void split_kernel(const float* __restrict__ x, int n, int d, int dp,
                             float* __restrict__ xhi, float* __restrict__ xlo,
                             float* __restrict__ sq) {
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  for (int64_t row = (int64_t)blockIdx.x * warps + (threadIdx.x >> 5); row < n;
       row += (int64_t)gridDim.x * warps) {
    double acc = 0.0;
    for (int k = lane; k < dp; k += 32) {
      const float v = k < d ? x[row * d + k] : 0.f;
      const float hi = tf32_rne(v);
      xhi[row * dp + k] = hi;
      xlo[row * dp + k] = tf32_rne(v - hi);
      acc += (double)v * (double)v;
    }
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) sq[row] = (float)acc;
  }
}

__host__ __device__ __forceinline__ int64_t tri_offset(int64_t i, int64_t tiles) {
  return i * tiles - i * (i - 1) / 2;  // tile pairs in rows 0..i-1 of the triangle
}

// linear index -> (I, J), J >= I, row-major over the upper triangle
__device__ __forceinline__ void tile_coords(int64_t idx, int tiles, int& I, int& J) {
  const double b = 2.0 * tiles + 1.0;
  int64_t i = (int64_t)((b - sqrt(b * b - 8.0 * (double)idx)) * 0.5);
  if (i < 0) i = 0;
  if (i > tiles - 1) i = tiles - 1;
  while (i + 1 < tiles && tri_offset(i + 1, tiles) <= idx) ++i;
  while (i > 0 && tri_offset(i, tiles) > idx) --i;
  I = (int)i;
  J = (int)(i + (idx - tri_offset(i, tiles)));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool pred) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
  const int bytes = pred ? 16 : 0;  // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(bytes));
}

// one stage: rows i0.. and j0.. of X_hi and X_lo, features k0..k0+31
__device__ __forceinline__ void load_stage(float* st, const float* __restrict__ xhi,
                                           const float* __restrict__ xlo, int n, int dp,
                                           int i0, int j0, int k0) {
#pragma unroll
  for (int p = 0; p < 16; ++p) {
    const int f = threadIdx.x + p * kThreads;  // 4 arrays x 128 rows x 8 chunks
    const int arr = f >> 10;
    const int r = (f >> 3) & (kTile - 1);
    const int c = f & 7;
    const int gr = (arr < 2 ? i0 : j0) + r;
    const float* base = (arr & 1) ? xlo : xhi;
    const bool ok = gr < n;
    cp_async16(st + arr * kArr + r * kLd + c * 4,
               base + (ok ? (int64_t)gr * dp + k0 + c * 4 : 0), ok);
  }
}

__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a, const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__global__ void __launch_bounds__(kThreads, 1)
gram_counts_kernel(const float* __restrict__ xhi, const float* __restrict__ xlo,
                   const float* __restrict__ sq, const uint8_t* __restrict__ row_valid,
                   const uint8_t* __restrict__ w, int n, int dp, float eps2,
                   float tau_coef, int* __restrict__ counts, uint32_t* __restrict__ adj,
                   int2* __restrict__ band, int* __restrict__ band_count, int band_cap,
                   float* __restrict__ d2_sample, int sample_tiles) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int s_row[kTile];
  __shared__ int s_col[kTile];
  const int tiles_1d = (n + kTile - 1) / kTile;
  const int64_t tiles = (int64_t)tiles_1d * (tiles_1d + 1) / 2;
  const int64_t mine = tiles > blockIdx.x ? (tiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const int ks = dp / kBK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp >> 2, wn = warp & 3;
  const int g = lane >> 2, t = lane & 3;

  if (threadIdx.x < kTile) {
    s_row[threadIdx.x] = 0;
    s_col[threadIdx.x] = 0;
  }

  float acc[4][4][4], accs[4][4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[a][b][c] = accs[a][b][c] = 0.f;

  // the loader runs kStages - 1 stages ahead of the consumer, across tiles
  int64_t ld_tile = 0;
  int ld_k = 0, ld_stage = 0, ld_i = 0, ld_j = 0;
  auto issue = [&]() {
    if (ld_tile < mine) {
      if (ld_k == 0)
        tile_coords(blockIdx.x + ld_tile * gridDim.x, tiles_1d, ld_i, ld_j);
      load_stage(smem + ld_stage * kStageFloats, xhi, xlo, n, dp, ld_i * kTile,
                 ld_j * kTile, ld_k * kBK);
    }
    asm volatile("cp.async.commit_group;\n" ::);
    if (++ld_k == ks) {
      ld_k = 0;
      ++ld_tile;
    }
    if (++ld_stage == kStages) ld_stage = 0;
  };
#pragma unroll
  for (int p = 0; p < kStages - 1; ++p) issue();

  int stage = 0;
  for (int64_t tile = 0; tile < mine; ++tile) {
    for (int k = 0; k < ks; ++k) {
      asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2));
      __syncthreads();
      issue();  // into the stage every warp finished with before the barrier
      const float* ah_s = smem + stage * kStageFloats;
      const float* al_s = ah_s + kArr;
      const float* bh_s = ah_s + 2 * kArr;
      const float* bl_s = ah_s + 3 * kArr;
      if (++stage == kStages) stage = 0;
#pragma unroll
      for (int kk = 0; kk < kBK; kk += 8) {
        uint32_t bh[4][2], bl[4][2];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int r = (wn * 32 + nt * 8 + g) * kLd + kk + t;
          bh[nt][0] = __float_as_uint(bh_s[r]);
          bh[nt][1] = __float_as_uint(bh_s[r + 4]);
          bl[nt][0] = __float_as_uint(bl_s[r]);
          bl[nt][1] = __float_as_uint(bl_s[r + 4]);
        }
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          const int r = (wm * 64 + mt * 16 + g) * kLd + kk + t;
          const uint32_t ah[4] = {__float_as_uint(ah_s[r]), __float_as_uint(ah_s[r + 8 * kLd]),
                                  __float_as_uint(ah_s[r + 4]),
                                  __float_as_uint(ah_s[r + 8 * kLd + 4])};
          const uint32_t al[4] = {__float_as_uint(al_s[r]), __float_as_uint(al_s[r + 8 * kLd]),
                                  __float_as_uint(al_s[r + 4]),
                                  __float_as_uint(al_s[r + 8 * kLd + 4])};
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            mma_tf32(accs[mt][nt], ah, bl[nt]);
            mma_tf32(accs[mt][nt], al, bh[nt]);
            mma_tf32(acc[mt][nt], ah, bh[nt]);
          }
        }
      }
    }

    // ---- epilogue of tile idx: decide, count, pack
    const int64_t idx = blockIdx.x + tile * gridDim.x;
    int I, J;
    tile_coords(idx, tiles_1d, I, J);
    const int i0 = I * kTile, j0 = J * kTile;
    const bool diag = I == J;
    float sq_c[4][2];
    int w_c[4][2], col_cnt[4][2];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int gj = j0 + wn * 32 + nt * 8 + 2 * t + e;
        sq_c[nt][e] = gj < n ? sq[gj] : 0.f;
        w_c[nt][e] = gj < n ? w[gj] : 0;
        col_cnt[nt][e] = 0;
      }
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int rl = wm * 64 + mt * 16 + g + 8 * h;
        const int gi = i0 + rl;
        const float sq_i = gi < n ? sq[gi] : 0.f;
        const int w_i = gi < n ? w[gi] : 0;
        int row_cnt = 0;
        uint32_t word = 0;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int cl = wn * 32 + nt * 8 + 2 * t + e;
            const int gj = j0 + cl;
            const float gram = acc[mt][nt][2 * h + e] + accs[mt][nt][2 * h + e];
            const float s2 = sq_i + sq_c[nt][e];
            const float d2 = s2 - 2.f * gram;
            if (d2_sample != nullptr && idx < sample_tiles)
              d2_sample[idx * kTile * kTile + rl * kTile + cl] = d2;
            bool a = false;
            if (gi < n && gj < n && (!diag || gj >= gi)) {
              if (gi == gj) {
                a = true;  // self: d2 = 0
              } else if (fabsf(d2 - eps2) <= tau_coef * s2) {
                const int slot = atomicAdd(band_count, 1);
                if (slot < band_cap) band[slot] = make_int2(gi, gj);
              } else {
                a = d2 <= eps2;
              }
            }
            if (a) {
              word |= 1u << (nt * 8 + 2 * t + e);
              row_cnt += w_c[nt][e];
              if (gi != gj) col_cnt[nt][e] += w_i;
            }
          }
        row_cnt += __shfl_xor_sync(0xffffffffu, row_cnt, 1);
        row_cnt += __shfl_xor_sync(0xffffffffu, row_cnt, 2);
        word |= __shfl_xor_sync(0xffffffffu, word, 1);
        word |= __shfl_xor_sync(0xffffffffu, word, 2);
        if (t == 0) {
          if (row_cnt) atomicAdd(&s_row[rl], row_cnt);
          if (adj != nullptr) adj[idx * kTileWords + rl * 4 + wn] = word;
        }
      }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        int v = col_cnt[nt][e];
        v += __shfl_xor_sync(0xffffffffu, v, 4);
        v += __shfl_xor_sync(0xffffffffu, v, 8);
        v += __shfl_xor_sync(0xffffffffu, v, 16);
        if (g == 0 && v) atomicAdd(&s_col[wn * 32 + nt * 8 + 2 * t + e], v);
      }
    __syncthreads();
    {
      const bool is_row = threadIdx.x < kTile;
      const int l = is_row ? threadIdx.x : threadIdx.x - kTile;
      int* cell = is_row ? &s_row[l] : &s_col[l];
      const int gr = (is_row ? i0 : j0) + l;
      const int v = *cell;
      if (v && gr < n && (row_valid == nullptr || row_valid[gr])) atomicAdd(&counts[gr], v);
      *cell = 0;  // read again only after the next stage's barrier
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[a][b][c] = accs[a][b][c] = 0.f;
  }
  asm volatile("cp.async.wait_all;\n" ::);
}

__global__ void band_kernel(const float* __restrict__ x, int n, int d,
                            const uint8_t* __restrict__ row_valid,
                            const uint8_t* __restrict__ w, float eps2,
                            const int2* __restrict__ band, const int* __restrict__ band_count,
                            int band_cap, int* __restrict__ counts,
                            uint32_t* __restrict__ adj) {
  int m = *band_count;
  if (m > band_cap) m = band_cap;
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const int tiles_1d = (n + kTile - 1) / kTile;
  for (int64_t p = (int64_t)blockIdx.x * warps + (threadIdx.x >> 5); p < m;
       p += (int64_t)gridDim.x * warps) {
    const int2 pr = band[p];  // pr.x < pr.y
    const float* a = x + (int64_t)pr.x * d;
    const float* b = x + (int64_t)pr.y * d;
    float acc = 0.f;
    for (int k = lane; k < d; k += 32) {
      const float diff = a[k] - b[k];
      acc = fmaf(diff, diff, acc);
    }
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0 && acc <= eps2) {
      if (w[pr.y] && (row_valid == nullptr || row_valid[pr.x])) atomicAdd(&counts[pr.x], 1);
      if (w[pr.x] && (row_valid == nullptr || row_valid[pr.y])) atomicAdd(&counts[pr.y], 1);
      if (adj != nullptr) {
        const int I = pr.x / kTile, J = pr.y / kTile;
        const int rl = pr.x % kTile, cl = pr.y % kTile;
        const int64_t idx = tri_offset(I, tiles_1d) + (J - I);
        atomicOr(&adj[idx * kTileWords + rl * 4 + cl / 32], 1u << (cl % 32));
      }
    }
  }
}

__global__ void __launch_bounds__(kTile)
near_core_kernel(const uint32_t* __restrict__ adj, const uint8_t* __restrict__ core, int n,
                 uint8_t* __restrict__ near) {
  __shared__ uint32_t s_core[4];
  __shared__ uint32_t s_col[4];
  const int tiles_1d = (n + kTile - 1) / kTile;
  const int64_t tiles = (int64_t)tiles_1d * (tiles_1d + 1) / 2;
  const int r = threadIdx.x, lane = r & 31, wq = r >> 5;
  for (int64_t idx = blockIdx.x; idx < tiles; idx += gridDim.x) {
    int I, J;
    tile_coords(idx, tiles_1d, I, J);
    const int gi = I * kTile + r, gj = J * kTile + r;
    const uint32_t core_j = __ballot_sync(0xffffffffu, gj < n && core[gj]);
    if (lane == 0) {
      s_core[wq] = core_j;
      s_col[wq] = 0;
    }
    __syncthreads();
    const uint4 wv = reinterpret_cast<const uint4*>(adj)[idx * kTile + r];  // row r's 4 words
    const uint32_t hit = (wv.x & s_core[0]) | (wv.y & s_core[1]) | (wv.z & s_core[2]) |
                         (wv.w & s_core[3]);
    if (hit && gi < n) near[gi] = 1;
    const bool core_i = gi < n && core[gi];
    uint32_t c[4] = {core_i ? wv.x : 0u, core_i ? wv.y : 0u, core_i ? wv.z : 0u,
                     core_i ? wv.w : 0u};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      for (int off = 16; off > 0; off >>= 1) c[k] |= __shfl_xor_sync(0xffffffffu, c[k], off);
      if (lane == 0 && c[k]) atomicOr(&s_col[k], c[k]);
    }
    __syncthreads();
    if (((s_col[wq] >> lane) & 1u) && gj < n) near[gj] = 1;
    __syncthreads();
  }
}

int sm_count(int device) {
  int sms = 132;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  return sms;
}

}  // namespace

extern "C" int sg_pairwise_feature_step() { return kBK; }
extern "C" int sg_pairwise_tile() { return kTile; }

// Pass 1.  counts[i] (int32, zeroed by the caller) += sum_j w[j] [d2 <= eps2]
// over all j, self included, for each row i with row_valid[i] (row_valid
// may be NULL: every row valid).  x is (n, d) float32 row-major; xhi, xlo
// (n, dp) and sq (n,) float32 are scratch, dp = d rounded up to a multiple
// of sg_pairwise_feature_step().  adj (may be NULL) receives the packed
// upper-triangle adjacency, 512 words per tile pair in the triangle's
// row-major order.  band ((band_cap, 2) int32) and *band_count (zeroed by
// the caller) hold the band pairs; *band_count ends as their number, which
// may exceed band_cap (then only band_cap were redecided and the caller
// must run again with more room).  d2_sample (may be NULL) receives the
// computed d2 of the first sample_tiles tiles, 128 x 128 each.  Three
// launches on `stream`: split, gram, band.
extern "C" int sg_pairwise_counts(int device, const float* x, int n, int d, int dp,
                                  float* xhi, float* xlo, float* sq,
                                  const uint8_t* row_valid, const uint8_t* w, float eps2,
                                  float tau_coef, int* counts, uint32_t* adj, int* band,
                                  int* band_count, int band_cap, float* d2_sample,
                                  int sample_tiles, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0) return (int)cudaSuccess;
  if (d <= 0 || dp < d || dp % kBK != 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const int sms = sm_count(device);
  split_kernel<<<(unsigned)(sms * 8), 256, 0, s>>>(x, n, d, dp, xhi, xlo, sq);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(gram_counts_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const int64_t tiles_1d = (n + kTile - 1) / kTile;
  const int64_t tiles = tiles_1d * (tiles_1d + 1) / 2;
  const unsigned grid = (unsigned)(tiles < sms ? tiles : sms);
  gram_counts_kernel<<<grid, kThreads, kSmemBytes, s>>>(
      xhi, xlo, sq, row_valid, w, n, dp, eps2, tau_coef, counts, adj,
      reinterpret_cast<int2*>(band), band_count, band_cap, d2_sample, sample_tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  band_kernel<<<(unsigned)(sms * 4), 256, 0, s>>>(x, n, d, row_valid, w, eps2,
                                                  reinterpret_cast<const int2*>(band),
                                                  band_count, band_cap, counts, adj);
  return (int)cudaGetLastError();
}

// Pass 2.  near[i] = 1 (uint8, zeroed by the caller) where some j with
// core[j] is adjacent to i in pass 1's packed adjacency `adj`.  One launch.
extern "C" int sg_dbscan_near_core(int device, const uint32_t* adj, const uint8_t* core, int n,
                                   uint8_t* near, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0) return (int)cudaSuccess;
  const int64_t tiles_1d = (n + kTile - 1) / kTile;
  const int64_t tiles = tiles_1d * (tiles_1d + 1) / 2;
  const int64_t cap = (int64_t)sm_count(device) * 16;
  near_core_kernel<<<(unsigned)(tiles < cap ? tiles : cap), kTile, 0, (cudaStream_t)stream>>>(
      adj, core, n, near);
  return (int)cudaGetLastError();
}
