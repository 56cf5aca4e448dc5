// FP32 register-tiled products from shared memory on the CUDA cores,
// shared by the tower epoch (mlp_epoch.cu) and LRML's row tiles
// (rows_epoch.cu).

#pragma once

#include <cuda_runtime.h>

namespace {

__host__ __device__ constexpr int pad4(int n) { return (n + 3) & ~3; }

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// The identity row map: operand row r is stored row r.
struct Rows {
  __device__ __forceinline__ int operator()(int r) const { return r; }
};

// The 4 x 4 sums of tile (r, c) of C = A B (see gemm4) over the depth
// columns k0, k0 + kstep, ... below K (k0 and kstep multiples of 4), each
// one fmaf chain in increasing k, added into acc.
template <bool AK, bool BK, typename RA, typename RB>
__device__ __forceinline__ void tile_sums(const float* A, int lda,
                                          const float* B, int ldb, int K,
                                          int r, int c, int nc, RA ra, RB rb,
                                          int k0, int kstep,
                                          float (&acc)[4][4]) {
  const float* a[4];   // AK: A's rows 4 r + i
  const float* b[4];   // BK: B's rows c + nc j
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    a[i] = AK ? A + (size_t)ra(4 * r + i) * lda : A + 4 * r;
    b[i] = BK ? B + (size_t)rb(c + nc * i) * ldb : B + 4 * c;
  }
  for (int k = k0; k < K; k += kstep) {
    float av[4][4], bv[4][4];   // A(4 r + i, k + e), B(k + e, column j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float4 x = AK ? ld4(a[e] + k) : ld4(a[0] + (size_t)ra(k + e) * lda);
      const float4 y = BK ? ld4(b[e] + k) : ld4(b[0] + (size_t)rb(k + e) * ldb);
      if constexpr (AK) {
        av[e][0] = x.x; av[e][1] = x.y; av[e][2] = x.z; av[e][3] = x.w;
      } else {
        av[0][e] = x.x; av[1][e] = x.y; av[2][e] = x.z; av[3][e] = x.w;
      }
      if constexpr (BK) {
        bv[e][0] = y.x; bv[e][1] = y.y; bv[e][2] = y.z; bv[e][3] = y.w;
      } else {
        bv[0][e] = y.x; bv[1][e] = y.y; bv[2][e] = y.z; bv[3][e] = y.w;
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[i][j] = fmaf(av[i][e], bv[j][e], acc[i][j]);
  }
}

// epi(m, n, dn, v) for every row m of every 4-column group of the M x N
// product C = A B over depth K (M, N and K multiples of 4), on a block of
// NT threads: v[j] is C[m][n + dn j].  Each thread takes 4 x 4 sums, tile
// t: rows 4 r + i and columns 4 c + j (BK false: dn 1, the group is
// contiguous and may go out as one float4) or c + N/4 j (BK true: dn N/4),
// t = r N/4 + c, and reads its operands four depth columns at a time, as
// float4s:
//   AK: A(m, k) = A[ra(m) lda + k], else A[ra(k) lda + m];
//   BK: B(k, n) = B[rb(n) ldb + k], else B[rb(k) ldb + n].
// ra and rb map an operand's logical rows to the rows where they are
// stored (a gather over a list of rows; Rows for none).  Neighbouring
// threads take neighbouring c, so a quarter-warp's B loads are 8
// consecutive float4s (BK false) or 8 rows at stride ldb (BK true: ldb / 4
// must be odd), and its A loads one broadcast (N >= 32) or a few of them:
// no bank conflicts.  Every pointer and stride is a multiple of 4 floats.
//
// SPLIT: a product of fewer tiles than threads splits the depth of each
// tile over ks = 2, 4 or 8 neighbouring lanes (lane p of a tile sums the
// depth columns 4 p, 4 (p + ks), ...), whose sums are then added in a fixed
// xor tree; else each v[j] is one fmaf chain in increasing k.
template <int NT, bool AK, bool BK, bool SPLIT = false, typename RA,
          typename RB, typename Epi>
__device__ __forceinline__ void gemm4(const float* A, int lda, const float* B,
                                      int ldb, int M, int N, int K, RA ra,
                                      RB rb, Epi epi) {
  const int nc = N / 4, tiles = (M / 4) * nc;
  int ks = 1;
  if constexpr (SPLIT)
    while (ks < 8 && 2 * ks * tiles <= NT) ks *= 2;
  if (ks == 1) {
    for (int t = threadIdx.x; t < tiles; t += NT) {
      const int r = t / nc, c = t - r * nc;
      float acc[4][4] = {};
      tile_sums<AK, BK>(A, lda, B, ldb, K, r, c, nc, ra, rb, 0, 4, acc);
#pragma unroll
      for (int i = 0; i < 4; ++i) epi(4 * r + i, BK ? c : 4 * c, BK ? nc : 1, acc[i]);
    }
    return;
  }
  // ks * tiles <= NT / 2: one pass, and the lanes of a tile share a warp.
  const int t = threadIdx.x / ks, p = threadIdx.x - t * ks;
  const int r = t / nc, c = t - r * nc;
  float acc[4][4] = {};
  if (t < tiles) tile_sums<AK, BK>(A, lda, B, ldb, K, r, c, nc, ra, rb, 4 * p, 4 * ks, acc);
  for (int off = 1; off < ks; off <<= 1)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        acc[i][j] += __shfl_xor_sync(0xffffffffu, acc[i][j], off);
  if (t < tiles && p == 0)
#pragma unroll
    for (int i = 0; i < 4; ++i) epi(4 * r + i, BK ? c : 4 * c, BK ? nc : 1, acc[i]);
}

}  // namespace
