// Masked full-catalog dot scoring on Hopper (sm_90a), behind a plain C
// interface that cleverrec_tpu_torch/ops/scores.py loads with ctypes.
//
// Replaces the three TPU kernels of cleverrec_tpu/ops/pallas_scores.py:
//
//   dot_scores  <- fused_dot_scores (_kernel_scores_only, pallas_call :276)
//       out[b, i] = u[b] . q[i] + bias[i], or -3e38 where bit (i & 31) of
//       the user's seen word bits[b, i >> 5] is set.           -> [B, I]
//   dot_gmax    <- fused_dot_gmax (_kernel_gmax_only, pallas_call :241)
//       out[b, g] = max of the masked score over items [32g, 32g + 32);
//       items >= I count as seen.  The [B, I] scores stay in registers
//       and never reach device memory.                         -> [B, ceil(I/32)]
//   dot_topk_scores <- fused_dot_topk_scores (_kernel/_masked_tile,
//       pallas_call :181)
//       out as dot_scores over I padded to whole 4096-item tiles (padding
//       masked)                                                -> [B, Ipad]
//       gmax[b, 128t + j] = max of out[b, 4096t + j + 32m] over m < 128
//       for j < 32, -3e38 for 32 <= j < 128                    -> [B, Ipad/32]
//       That is the TPU kernel's lane layout: its group j of tile t is
//       128 PERMUTED columns, which hold exactly these original items.
//
// The TPU kernels permute the item table into a 4096-column order because
// Mosaic has no lane gather.  Here every thread reads its own bitmap word,
// so all three kernels work in ORIGINAL item order and need no
// permutation (dot_topk_scores' item_map is the identity).
//
// What bounds them on an H100 (67 TFLOP/s FP32 on the CUDA cores,
// 3.35 TB/s HBM): each output score costs d FP32 FMAs.  At the serving
// width d = 128 that is 64 FLOP per 4-byte output, above the card's
// FP32 balance of ~20 FLOP/byte, so all three are bound by their FP32
// FMAs; the [B, I] f32 write of dot_scores and dot_topk_scores is their
// largest memory term, and dot_gmax writes 32x less.  The design answers the FMA bound with a
// register tile: a block stages a 64-user x 64-item tile of u and q in
// shared memory, 32 depth columns at a time, and each of its 256 threads
// keeps a 4 x 4 block of sums in registers (16 FMAs for every 8 shared
// loads).  The epilogue reads one bitmap word per 32 items from shared
// memory, adds the bias, masks, and either writes the scores (half-warps
// store 16 consecutive items of a row) or max-reduces each aligned run of
// 32 items across 16 lanes with __shfl_xor_sync and writes one float.
// dot_topk_scores runs the same register tile over the 64 sub-tiles of a
// 4096-item tile in one block, so a comb's 128 items meet in one thread's
// registers (see dot_topk_kernel).  Plain FP32 FMAs, no tensor cores: the sums stay comparable to the
// float32 reference.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;        // users per block
constexpr int BN = 64;        // items per block: two 32-item groups
constexpr int BK = 32;        // depth columns staged per pass
constexpr int TX = 16;        // threads along items
constexpr int TY = 16;        // threads along users
constexpr int RM = BM / TY;   // users per thread
constexpr int RN = BN / TX;   // items per thread: tx, tx + 16, tx + 32, tx + 48
constexpr int WPB = BN / 32;  // bitmap words per block row
constexpr float NEG = -3.0e38f;  // finite mask value, as on the TPU
constexpr int TILE_I = 4096;  // dot_topk_scores: items per tile, as on the TPU
constexpr int GROUP_LANES = 128;  // dot_topk_scores: gmax lanes per tile

static_assert(BM == BN, "one loop stages both tiles");
static_assert(TX == 16 && RN == 4, "group g of a row is items j = 2g, 2g + 1 of a thread");
static_assert(TILE_I % BN == 0 && TILE_I / 32 == GROUP_LANES, "combs of a tile");

// A block's shared staging: a BM-user x BN-item tile of u and q, BK depth
// columns at a time, and the users' bitmap words of the BN items.  Rows
// padded to BK + 1 floats: the 16 item lanes of a half-warp read 16
// different banks.
struct Stage {
  float us[BM][BK + 1];
  float qs[BN][BK + 1];
  uint32_t ws[BM][WPB];
};

// v[i][j] = the masked score of user m0 + ty * RM + i and item
// n0 + tx + TX * j: u . q + bias, or NEG where the item is seen or >= I.
// Every thread of the block calls it (it synchronises).
__device__ __forceinline__ void masked_tile(
    Stage& s, const float* __restrict__ u, const float* __restrict__ q,
    const uint32_t* __restrict__ bits, const float* __restrict__ bias,
    int B, int I, int d, int W, int m0, int n0, float (&v)[RM][RN]) {
  const int tx = threadIdx.x % TX;
  const int ty = threadIdx.x / TX;

  __syncthreads();   // a previous tile's epilogue is done with s.ws
  for (int t = threadIdx.x; t < BM * WPB; t += TX * TY) {
    const int r = t / WPB, w = n0 / 32 + t % WPB;
    s.ws[r][t % WPB] = (m0 + r < B && w < W) ? bits[(size_t)(m0 + r) * W + w] : 0u;
  }

  float acc[RM][RN];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < d; k0 += BK) {
    // Consecutive threads read consecutive depth columns of one row.
    for (int t = threadIdx.x; t < BM * BK; t += TX * TY) {
      const int r = t / BK, c = t % BK, col = k0 + c;
      s.us[r][c] = (m0 + r < B && col < d) ? u[(size_t)(m0 + r) * d + col] : 0.f;
      s.qs[r][c] = (n0 + r < I && col < d) ? q[(size_t)(n0 + r) * d + col] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int c = 0; c < BK; ++c) {
      float a[RM], b[RN];
#pragma unroll
      for (int i = 0; i < RM; ++i) a[i] = s.us[ty * RM + i][c];
#pragma unroll
      for (int j = 0; j < RN; ++j) b[j] = s.qs[tx + TX * j][c];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < RN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
  __syncthreads();   // s.ws visible even when d == 0

  float bj[RN];
#pragma unroll
  for (int j = 0; j < RN; ++j) {
    const int item = n0 + tx + TX * j;
    bj[j] = (bias != nullptr && item < I) ? bias[item] : 0.f;
  }
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int r = ty * RM + i;
#pragma unroll
    for (int j = 0; j < RN; ++j) {
      const int c = tx + TX * j;
      const bool seen = (n0 + c >= I) || ((s.ws[r][c >> 5] >> (c & 31)) & 1u);
      v[i][j] = seen ? NEG : acc[i][j] + bj[j];
    }
  }
}

template <bool GMAX>
__global__ void __launch_bounds__(TX * TY)
dot_scores_kernel(const float* __restrict__ u, const float* __restrict__ q,
                  const uint32_t* __restrict__ bits,
                  const float* __restrict__ bias, float* __restrict__ out,
                  int B, int I, int d, int W) {
  __shared__ Stage s;
  const int tx = threadIdx.x % TX;
  const int ty = threadIdx.x / TX;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  float v[RM][RN];
  masked_tile(s, u, q, bits, bias, B, I, d, W, m0, n0, v);

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int row = m0 + ty * RM + i;
    if (!GMAX) {
      if (row < B) {
#pragma unroll
        for (int j = 0; j < RN; ++j) {
          const int item = n0 + tx + TX * j;
          if (item < I) out[(size_t)row * I + item] = v[i][j];
        }
      }
    } else {
      // Items tx + 16j of the tile: j = 0, 1 form group 0, j = 2, 3 group 1.
      float g0 = fmaxf(v[i][0], v[i][1]), g1 = fmaxf(v[i][2], v[i][3]);
#pragma unroll
      for (int off = TX / 2; off > 0; off >>= 1) {
        g0 = fmaxf(g0, __shfl_xor_sync(0xffffffffu, g0, off));
        g1 = fmaxf(g1, __shfl_xor_sync(0xffffffffu, g1, off));
      }
      const int G = (I + 31) / 32, g = n0 / 32;
      if (tx == 0 && row < B) {
        out[(size_t)row * G + g] = g0;
        if (g + 1 < G) out[(size_t)row * G + g + 1] = g1;
      }
    }
  }
}

// dot_topk_scores: a block takes BM users x one TILE_I-item tile and walks
// it in BN-item sub-tiles.  Item l of the tile belongs to comb l & 31; a
// thread's items tx + 16j of every sub-tile fall in combs tx (j = 0, 2)
// and tx + 16 (j = 1, 3), so each thread keeps two running comb maxes per
// row in registers and the 16 threads of a row cover all 32 combs: no
// shuffles, no atomics, one gmax write per (row, comb).
__global__ void __launch_bounds__(TX * TY)
dot_topk_kernel(const float* __restrict__ u, const float* __restrict__ q,
                const uint32_t* __restrict__ bits,
                const float* __restrict__ bias, float* __restrict__ out,
                float* __restrict__ gmax, int B, int I, int Ipad, int d,
                int W) {
  __shared__ Stage s;
  const int tx = threadIdx.x % TX;
  const int ty = threadIdx.x / TX;
  const int m0 = blockIdx.y * BM;
  const int t0 = blockIdx.x * TILE_I;
  float cm[RM][2];
#pragma unroll
  for (int i = 0; i < RM; ++i) cm[i][0] = cm[i][1] = NEG;

  for (int n0 = t0; n0 < t0 + TILE_I; n0 += BN) {
    float v[RM][RN];
    masked_tile(s, u, q, bits, bias, B, I, d, W, m0, n0, v);
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int row = m0 + ty * RM + i;
      cm[i][0] = fmaxf(cm[i][0], fmaxf(v[i][0], v[i][2]));
      cm[i][1] = fmaxf(cm[i][1], fmaxf(v[i][1], v[i][3]));
      if (row < B) {
#pragma unroll
        for (int j = 0; j < RN; ++j)
          out[(size_t)row * Ipad + n0 + tx + TX * j] = v[i][j];
      }
    }
  }

  const int lanes = Ipad / 32;   // GROUP_LANES per tile, 32 of them real
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int row = m0 + ty * RM + i;
    if (row >= B) continue;
    float* g = gmax + (size_t)row * lanes + (size_t)blockIdx.x * GROUP_LANES;
    g[tx] = cm[i][0];
    g[tx + TX] = cm[i][1];
    for (int l = 32 + tx; l < GROUP_LANES; l += TX) g[l] = NEG;
  }
}

template <bool GMAX>
int launch(const float* u, const float* q, const uint32_t* bits,
           const float* bias, float* out, int B, int I, int d, int W,
           cudaStream_t stream) {
  const dim3 grid((I + BN - 1) / BN, (B + BM - 1) / BM);
  dot_scores_kernel<GMAX><<<grid, TX * TY, 0, stream>>>(u, q, bits, bias, out,
                                                        B, I, d, W);
  return (int)cudaGetLastError();
}

}  // namespace

// Pointers are device pointers; bias may be null.  bits is [B, W] with
// W = ceil(I / 32); the result is 0 or the cudaError_t of the launch.
extern "C" int dot_scores(const float* u, const float* q, const uint32_t* bits,
                          const float* bias, float* out, int B, int I, int d,
                          int W, cudaStream_t stream) {
  return launch<false>(u, q, bits, bias, out, B, I, d, W, stream);
}

extern "C" int dot_gmax(const float* u, const float* q, const uint32_t* bits,
                        const float* bias, float* out, int B, int I, int d,
                        int W, cudaStream_t stream) {
  return launch<true>(u, q, bits, bias, out, B, I, d, W, stream);
}

// out is [B, Ipad] and gmax [B, Ipad / 32], Ipad = I rounded up to
// TILE_I; both are written in full.
extern "C" int dot_topk_scores(const float* u, const float* q,
                               const uint32_t* bits, const float* bias,
                               float* out, float* gmax, int B, int I, int d,
                               int W, cudaStream_t stream) {
  const int tiles = (I + TILE_I - 1) / TILE_I;
  const dim3 grid(tiles, (B + BM - 1) / BM);
  dot_topk_kernel<<<grid, TX * TY, 0, stream>>>(
      u, q, bits, bias, out, gmax, B, I, tiles * TILE_I, d, W);
  return (int)cudaGetLastError();
}
