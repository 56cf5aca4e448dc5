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
// width d = 128 that is 64 FLOP per 4-byte output, above the card's FP32
// balance of ~20 FLOP/byte, so all three are bound by their FP32 FMAs; the
// [B, I] f32 write of dot_scores and dot_topk_scores is their largest
// memory term, and dot_gmax writes 32x less.  A kernel reaches the FMA
// rate only if nothing else fills the issue slots or stalls them: shared
// loads, waits on device memory, barriers.  Shared memory feeds an SM 32
// floats a clock; an 8 x 8 register tile needs that at the full FMA rate.
//
// All three share one FP32 mainloop (fma_chunk):
// - Register tile.  Each thread keeps TM x TN sums (8 x 8 in the 128-user
//   tiles) and reads its operands from shared memory as float4: per 4
//   depth columns, TM + TN 16-byte loads feed 4 TM TN FMAs (1 load per 16
//   FMAs at 8 x 8, 1 per 8 at 4 x 4).
// - Layout.  u and q are [rows, d] with d contiguous, so shared memory
//   keeps chunks of 32 depth columns, each rows x 32 floats (a row stride
//   the mainloop knows at compile time) of 16-byte pieces.  A thread owns
//   item rows 4 tx + 64 j + c (tx < 16), whose float4 stores are
//   contiguous; piece g of item row n sits at piece g ^ ((n >> 2) & 7), so
//   the 8 threads of a quarter-warp, which read rows 4 tx + c with the
//   same g, hit 8 different bank groups.  The user rows of a quarter-warp
//   are one row (a broadcast) and need no swizzle.
// - Staging.  cp.async copies (cp_async.cuh), 16 bytes where d % 4 == 0
//   and both bases are 16-byte aligned (the wrapper passes the flag), else
//   4 bytes (the scalar path, for views such as table[1:]), zero-filled
//   past the edges.  A ring of depth chunks lets the next chunk load while
//   the current one is multiplied; the 64- and 32-user tiles stage the
//   whole depth (d <= 256; deeper inputs take the strip kernel) in one
//   group instead: one wait and one barrier.
// - Plain FP32 sums.  Each output is one fmaf chain in increasing depth
//   order, as a float32 matrix product on the card sums it; the zero
//   columns past d add 0 exactly.  No TF32.
// The 128 x 128 tile runs the strip kernel: a block keeps its 128 user
// rows in shared memory for a whole strip of 128-item sub-tiles (a
// 4096-item tile for dot_topk_scores, loaded once, not once per
// sub-tile), walks the strip through the ring without a break between
// sub-tiles, and applies bias and mask in registers.  Grids run users
// along x, so the blocks that share q rows run together and read them from
// L2.  dot_scores and dot_gmax pick their tile (scores.py's _scores_tile,
// on the SM count the wrapper passes: 132 on an H100 SXM) so that the
// grid fills the card; the 128 x 128 tile splits its sub-tiles into as
// many strips as fill the card's SMs.  Three epilogues:
// - dot_scores writes through shared memory, so that its stores are
//   coalesced whatever I % 4 (store_rows);
// - dot_topk_scores stores float4s and keeps its comb maxes per thread
//   (see dot_strip_kernel);
// - dot_gmax keeps no scores: a thread's items 4 tx + 64 g + c of an
//   aligned sub-tile fall in 32-item group (tx >> 3) + 2 g, so it takes
//   the max over its 4 c, three __shfl_xor_sync merge the 8 lanes that
//   share the group, and one lane writes one float (store_gmax).

#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace {

constexpr float NEG = -3.0e38f;  // finite mask value, as on the TPU
constexpr int TILE_I = 4096;  // dot_topk_scores: items per tile, as on the TPU
constexpr int GROUP_LANES = 128;  // dot_topk_scores: gmax lanes per tile
constexpr int KC = 32;        // depth columns per staged chunk: 8 pieces

// The epilogue a kernel runs on its sums: dot_scores', dot_topk_scores'
// or dot_gmax's.
enum Epi { SCORES, TOPK, GMAX };

// ------------------------------------------------ the shared FP32 mainloop

// Stage rows [r0, r0 + rows) of the row-major [n, d] matrix src, depth
// columns [k0, k0 + KC chunks), into dst chunk by chunk: chunk c is rows
// x KC floats at dst + c rows KC, row r at r KC, so every row stride the
// mainloop reads is the constant KC.  Rows >= n and columns >= d read as
// 0.  SWZ: piece g (4 columns) of row r lands at piece g ^ ((r >> 2) & 7),
// the layout fma_chunk reads item rows in.  VEC: one 16-byte cp.async a
// piece (src 16-byte aligned and d % 4 == 0), else four 4-byte ones.
// Commits nothing.
template <bool VEC, bool SWZ, int ROWS>
__device__ __forceinline__ void stage(float* dst,
                                      const float* __restrict__ src, int n,
                                      int d, int r0, int k0, int chunks) {
  constexpr int P = KC / 4;   // pieces a chunk row
  for (int t = threadIdx.x; t < chunks * ROWS * P; t += blockDim.x) {
    const int c = t / (ROWS * P), r = t / P % ROWS, g = t % P;
    const int k = k0 + c * KC + 4 * g;
    float* to = dst + (c * ROWS + r) * KC + 4 * (SWZ ? g ^ ((r >> 2) & 7) : g);
    const bool row_ok = r0 + r < n;
    const float* from = src + (row_ok ? (size_t)(r0 + r) * d + k : 0);
    if (VEC) {
      const bool ok = row_ok && k < d;
      cp16(to, ok ? from : src, ok ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = row_ok && k + e < d;
        cp4(to + e, ok ? from + e : src, ok ? 4 : 0);
      }
    }
  }
}

// acc[i][4 j + c] += the products over one staged chunk (KC depth
// columns) of user row ty * TM + i of a and item row 4 tx + 4 TX j + c of
// b (swizzled as stage<., true, .> writes it): one fmaf per column, in
// increasing depth order.  Row strides are KC: every shared load but the
// swizzled piece index has an immediate offset.
template <int TM, int TN, int TX>
__device__ __forceinline__ void fma_chunk(float (&acc)[TM][TN],
                                          const float* a, const float* b,
                                          int ty, int tx) {
  static_assert(TX == 16 && TN % 4 == 0, "item row n = 4 tx + 64 j + c: (n >> 2) & 7 == tx & 7");
  static_assert(KC == 32, "8 pieces a chunk row: the swizzle spans them");
  const int sw = tx & 7;
  a += ty * TM * KC;
  b += 4 * tx * KC;
#pragma unroll
  for (int g = 0; g < KC / 4; ++g) {
    float4 av[TM];
#pragma unroll
    for (int i = 0; i < TM; ++i)
      av[i] = *reinterpret_cast<const float4*>(a + i * KC + 4 * g);
    const float* bg = b + 4 * (g ^ sw);
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const float4 bv = *reinterpret_cast<const float4*>(
          bg + (4 * TX * (j / 4) + j % 4) * KC);
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        float s = acc[i][j];
        s = fmaf(av[i].x, bv.x, s);
        s = fmaf(av[i].y, bv.y, s);
        s = fmaf(av[i].z, bv.z, s);
        s = fmaf(av[i].w, bv.w, s);
        acc[i][j] = s;
      }
    }
  }
}

// The masks of a thread's items n0 + 4 tx + 64 g + c (c < 4; one bitmap
// word a group g) for its user rows row0 + i, and their biases.
template <int TM, int TN>
__device__ __forceinline__ void fetch_masks(
    uint32_t (&wd)[TM][TN / 4], float (&bj)[TN],
    const uint32_t* __restrict__ bits, const float* __restrict__ bias,
    int B, int I, int W, int row0, int n0, int tx) {
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int g = 0; g < TN / 4; ++g) {
      const int item = n0 + 4 * tx + 64 * g;
      wd[i][g] = (row0 + i < B && item < I)
                     ? bits[(size_t)(row0 + i) * W + (item >> 5)] : 0u;
    }
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const int item = n0 + 4 * tx + 64 * (j / 4) + j % 4;
    bj[j] = (bias != nullptr && item < I) ? bias[item] : 0.f;
  }
}

// The masked scores of a thread's row i, items n0 + 4 tx + 64 g + c:
// u . q + bias, or NEG where the item is seen or >= I.
template <int TM, int TN>
__device__ __forceinline__ float4 masked4(
    const float (&acc)[TM][TN], const uint32_t (&wd)[TM][TN / 4],
    const float (&bj)[TN], int i, int g, int n0, int tx, int I) {
  const int item = n0 + 4 * tx + 64 * g, sh = item & 31;
  float v[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const bool seen = item + c >= I || ((wd[i][g] >> (sh + c)) & 1u);
    v[c] = seen ? NEG : acc[i][4 * g + c] + bj[4 * g + c];
  }
  return make_float4(v[0], v[1], v[2], v[3]);
}

// Write a thread's masked scores into tile (row stride ts), barrier, then
// store the block's BM x BN tile into out ([B, I]) row by row:
// consecutive threads write consecutive items, float4s where rows are
// 16-byte aligned (I % 4 == 0).  Every thread calls it.
template <int BM, int BN, int TM, int TN, int THREADS>
__device__ __forceinline__ void store_rows(
    float* tile, int ts, const float (&acc)[TM][TN],
    const uint32_t (&wd)[TM][TN / 4], const float (&bj)[TN],
    float* __restrict__ out, int B, int I, int m0, int n0, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int g = 0; g < TN / 4; ++g)
      *reinterpret_cast<float4*>(tile + (ty * TM + i) * ts + 4 * tx + 64 * g) =
          masked4<TM, TN>(acc, wd, bj, i, g, n0, tx, I);
  __syncthreads();
  if ((I & 3) == 0) {
    for (int t = threadIdx.x; t < BM * BN / 4; t += THREADS) {
      const int r = t / (BN / 4), col = 4 * (t % (BN / 4));
      if (m0 + r < B && n0 + col < I)
        *reinterpret_cast<float4*>(out + (size_t)(m0 + r) * I + n0 + col) =
            *reinterpret_cast<const float4*>(tile + r * ts + col);
    }
  } else {
    for (int t = threadIdx.x; t < BM * BN; t += THREADS) {
      const int r = t / BN, col = t % BN;
      if (m0 + r < B && n0 + col < I)
        out[(size_t)(m0 + r) * I + n0 + col] = tile[r * ts + col];
    }
  }
}

// dot_gmax's epilogue: out[row, group] ([B, ceil(I/32)]) for a thread's
// rows row0 + i and its items n0 + 4 tx + 64 g + c (n0 % 32 == 0), which
// fall in group n0 / 32 + (tx >> 3) + 2 g; the 8 lanes tx ^ 1, 2, 4 share
// it.  Items >= I count as seen, so no group takes a score past I.  Every
// thread of a warp calls it.
template <int TM, int TN>
__device__ __forceinline__ void store_gmax(
    const float (&acc)[TM][TN], const uint32_t (&wd)[TM][TN / 4],
    const float (&bj)[TN], float* __restrict__ out, int B, int I, int row0,
    int n0, int tx) {
  const int G = (I + 31) / 32;
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int g = 0; g < TN / 4; ++g) {
      const float4 v = masked4<TM, TN>(acc, wd, bj, i, g, n0, tx, I);
      float m = fmaxf(fmaxf(v.x, v.y), fmaxf(v.z, v.w));
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
      const int grp = n0 / 32 + (tx >> 3) + 2 * g;
      if ((tx & 7) == 0 && row0 + i < B && grp < G)
        out[(size_t)(row0 + i) * G + grp] = m;
    }
}

// ------------------------------------------------- the 64- and 32-user tiles

// A block tile of BM users x BN items, TM x TN sums a thread, for depths
// up to KC * WHOLE (256), staged whole; deeper inputs take the strip
// kernel.
constexpr int WHOLE = 8;   // chunks of KC depth columns

template <int BM_, int BN_, int TM_, int TN_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, TM = TM_, TN = TN_;
  static constexpr int TX = BN / TN, TY = BM / TM, THREADS = TX * TY;
  static constexpr int TS = BN + 4;   // epilogue row stride, floats
  static_assert(TX == 16, "16 threads along items");

  // Dynamic shared memory of a block at depth d, bytes.
  static int smem(int d) {
    const int nk = d > KC ? (d + KC - 1) / KC : 1;
    const int body = (BM + BN) * nk * KC, epi = BM * TS;
    return 4 * (body > epi ? body : epi);
  }
};

// Tiles 1 and 2 of dot_scores and dot_gmax (scores.py's SCORE_TILES);
// tile 0 is the strip kernel's.
using Mid = Tile<64, 64, 4, 4>;
using Narrow = Tile<32, 64, 4, 4>;

// acc = the T-tile of u . q at users m0.., items n0.., the whole depth
// (at most WHOLE chunks) staged in one group: one wait, one barrier.  Every
// thread calls it; the caller must barrier before reusing shared memory.
template <class T, bool VEC>
__device__ __forceinline__ void tile_product(
    float (&acc)[T::TM][T::TN], float* smem, const float* __restrict__ u,
    const float* __restrict__ q, int B, int I, int d, int m0, int n0,
    int ty, int tx) {
  const int nk = d > KC ? (d + KC - 1) / KC : 1;
  float* as = smem;
  float* bs = smem + T::BM * nk * KC;
  stage<VEC, false, T::BM>(as, u, B, d, m0, 0, nk);
  stage<VEC, true, T::BN>(bs, q, I, d, n0, 0, nk);
  cp_commit();
  cp_wait<0>();
  __syncthreads();
  for (int c = 0; c < nk; ++c)
    fma_chunk<T::TM, T::TN, T::TX>(acc, as + c * T::BM * KC,
                                   bs + c * T::BN * KC, ty, tx);
}

// A block per T-tile; blockIdx.x walks users, so the blocks that share a
// q tile run together and read it from L2.  EPI: SCORES or GMAX.
template <class T, bool VEC, Epi EPI>
__global__ void __launch_bounds__(T::THREADS)
dot_tile_kernel(const float* __restrict__ u, const float* __restrict__ q,
                const uint32_t* __restrict__ bits,
                const float* __restrict__ bias, float* __restrict__ out,
                int B, int I, int d, int W) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  constexpr int TM = T::TM, TN = T::TN;
  const int tx = threadIdx.x % T::TX, ty = threadIdx.x / T::TX;
  const int m0 = blockIdx.x * T::BM, n0 = blockIdx.y * T::BN;
  // Fetched before the product, so that their latency hides under it.
  uint32_t wd[TM][TN / 4];
  float bj[TN];
  fetch_masks<TM, TN>(wd, bj, bits, bias, B, I, W, m0 + ty * TM, n0, tx);
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  tile_product<T, VEC>(acc, smem, u, q, B, I, d, m0, n0, ty, tx);
  if (EPI == GMAX) {
    store_gmax<TM, TN>(acc, wd, bj, out, B, I, m0 + ty * TM, n0, tx);
    return;
  }
  __syncthreads();   // every thread is done with the staged operands
  store_rows<T::BM, T::BN, TM, TN, T::THREADS>(smem, T::TS, acc, wd, bj, out,
                                               B, I, m0, n0, ty, tx);
}

// ------------------------------------------------------ the strip kernel

namespace strip {

constexpr int BM = 128, BN = 128, TM = 8, TN = 8, TX = 16, THREADS = 256;
constexpr int STAGES = 4;
constexpr int SUB = TILE_I / BN;   // dot_topk_scores: sub-tiles of a tile
constexpr int TS = BN + 4;         // dot_scores: staging row stride, floats
constexpr int SMEM_MAX = 232448;   // bytes of shared memory a block may use

// Beside the operands, floats: dot_topk_scores' comb maxes (TM x 4 a
// thread), dot_scores' BM x BN staging tile, or nothing (dot_gmax).
__host__ __device__ constexpr int extra(Epi epi) {
  return epi == TOPK ? TM * 4 * THREADS : epi == SCORES ? BM * TS : 0;
}

// Is the block's whole u (depth dp) kept in shared memory beside a ring of
// q chunks, or staged by chunks beside q's?
__host__ __device__ constexpr bool u_whole(int dp, Epi epi) {
  return 4 * (BM * dp + STAGES * BN * KC + extra(epi)) <= SMEM_MAX;
}

// Dynamic shared memory of a block at depth d, bytes.
int smem(int d, Epi epi) {
  const int dp = (d > KC ? (d + KC - 1) / KC : 1) * KC;
  return 4 * ((u_whole(dp, epi) ? BM * dp + STAGES * BN * KC
                                : STAGES * (BM + BN) * KC) + extra(epi));
}

}  // namespace strip

// A block takes strip::BM users (blockIdx.x) x a strip of 128-item
// sub-tiles (blockIdx.y) and walks the strip through one ring, chunk after
// chunk with no break between sub-tiles, its u rows staged once.
//
// TOPK (dot_topk_scores): a strip is one TILE_I-item tile, out is
// [B, ld = Ipad], and the scores go out as float4s from registers.  Item
// l of the tile belongs to comb l & 31.  A thread's items 4 tx + 64 g + c
// of every sub-tile fall in combs 4 (tx & 7) + c, so it keeps four
// running comb maxes per row (in shared memory, its own slots, which
// leaves the registers to the sums and the operands), and threads tx and
// tx ^ 8 (lanes 8 apart) share their four combs: one shuffle merges them
// at the end of the tile.  No atomics, one float4 gmax write per (row,
// four combs).  Sub-tiles wholly past I (the padding of the last tile) are
// written NEG without a product.
//
// Else (the 128 x 128 tile of dot_scores and dot_gmax): a strip is `len`
// sub-tiles, and each sub-tile goes out through store_rows (SCORES: out is
// [B, ld = I]) or store_gmax (GMAX: out is [B, ceil(I/32)]).
template <bool VEC, Epi EPI>
__global__ void __launch_bounds__(strip::THREADS, 1)
dot_strip_kernel(const float* __restrict__ u, const float* __restrict__ q,
             const uint32_t* __restrict__ bits, const float* __restrict__ bias,
             float* __restrict__ out, float* __restrict__ gmax, int B, int I,
             int ld, int d, int W, int len) {
  using namespace strip;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const int m0 = blockIdx.x * BM, t0 = blockIdx.y * len * BN;
  const int nk = d > KC ? (d + KC - 1) / KC : 1, dp = nk * KC;

  // u whole in shared memory, its own group ahead of the ring's; or u
  // chunks beside the q chunks in each stage of the ring.
  const bool whole = u_whole(dp, EPI);
  float* ring = smem + (whole ? BM * dp : 0);
  const int sf = (whole ? BN : BM + BN) * KC;
  // dot_scores' staging tile, or dot_topk_scores' comb maxes: slot
  // (4 i + e) THREADS + threadIdx.x.
  float* extra = ring + STAGES * sf;
  if (whole) {
    stage<VEC, false, BM>(smem, u, B, d, m0, 0, nk);
    cp_commit();
  }
  // Sub-tiles holding an item < I.
  const int live = min(len, (I - t0 + BN - 1) / BN);
  const int steps = live * nk;   // (sub-tile, chunk) pairs
  auto issue = [&](int s) {
    const int sub = s / nk, c = s - sub * nk;
    float* st = ring + (s % STAGES) * sf;
    stage<VEC, true, BN>(st, q, I, d, t0 + sub * BN, c * KC, 1);
    if (!whole) stage<VEC, false, BM>(st + BN * KC, u, B, d, m0, c * KC, 1);
  };
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < steps) issue(s);
    cp_commit();
  }

  if (EPI == TOPK)
    for (int k = 0; k < TM * 4; ++k) extra[k * THREADS + threadIdx.x] = NEG;
  float acc[TM][TN];
  uint32_t wd[TM][TN / 4];
  float bj[TN];

  for (int s = 0; s < steps; ++s) {
    const int sub = s / nk, c = s - sub * nk, n0 = t0 + sub * BN;
    if (c == 0) {
      // A new sub-tile: zero the sums, fetch its words and biases now.
      fetch_masks<TM, TN>(wd, bj, bits, bias, B, I, W, m0 + ty * TM, n0, tx);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
    }
    cp_wait<STAGES - 2>();   // u and chunk s have landed
    __syncthreads();         // for every thread; and chunk s - 1 is read
    if (s + STAGES - 1 < steps) issue(s + STAGES - 1);
    cp_commit();
    const float* st = ring + (s % STAGES) * sf;
    fma_chunk<TM, TN, TX>(acc, whole ? smem + c * BM * KC : st + BN * KC, st,
                          ty, tx);
    if (c < nk - 1) continue;

    if (EPI == GMAX) {
      store_gmax<TM, TN>(acc, wd, bj, out, B, I, m0 + ty * TM, n0, tx);
      continue;
    }
    if (EPI == SCORES) {
      // The staging tile's last readers (the previous sub-tile's stores)
      // are past this step's barrier.
      store_rows<BM, BN, TM, TN, THREADS>(extra, TS, acc, wd, bj, out, B, I,
                                          m0, n0, ty, tx);
      continue;
    }
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int row = m0 + ty * TM + i;
      float m[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) m[e] = extra[(4 * i + e) * THREADS + threadIdx.x];
#pragma unroll
      for (int g = 0; g < TN / 4; ++g) {
        const float4 v = masked4<TM, TN>(acc, wd, bj, i, g, n0, tx, I);
        m[0] = fmaxf(m[0], v.x);
        m[1] = fmaxf(m[1], v.y);
        m[2] = fmaxf(m[2], v.z);
        m[3] = fmaxf(m[3], v.w);
        if (row < B)
          *reinterpret_cast<float4*>(out + (size_t)row * ld + n0 + 4 * tx +
                                     64 * g) = v;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) extra[(4 * i + e) * THREADS + threadIdx.x] = m[e];
    }
  }
  cp_wait<0>();
  if (EPI != TOPK) return;

  const float4 neg4 = make_float4(NEG, NEG, NEG, NEG);
  for (int sub = live; sub < SUB; ++sub) {
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int row = m0 + ty * TM + i;
      if (row >= B) continue;
#pragma unroll
      for (int g = 0; g < TN / 4; ++g)
        *reinterpret_cast<float4*>(out + (size_t)row * ld + t0 + sub * BN +
                                   4 * tx + 64 * g) = neg4;
    }
  }

  const int lanes = ld / 32;   // GROUP_LANES per tile, 32 of them real
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    float m[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      m[e] = extra[(4 * i + e) * THREADS + threadIdx.x];
      m[e] = fmaxf(m[e], __shfl_xor_sync(0xffffffffu, m[e], 8));
    }
    const int row = m0 + ty * TM + i;
    if (row >= B) continue;
    float* gm = gmax + (size_t)row * lanes + (size_t)blockIdx.y * GROUP_LANES;
    if (tx < 8) {
      *reinterpret_cast<float4*>(gm + 4 * tx) = make_float4(m[0], m[1], m[2], m[3]);
    } else {
#pragma unroll
      for (int r = 0; r < 3; ++r)   // lanes 32-127: 24 float4s, 3 a thread
        *reinterpret_cast<float4*>(gm + 32 + 4 * (tx - 8 + 8 * r)) = neg4;
    }
  }
}

// Raise a kernel's dynamic shared memory limit to at least `bytes` (the
// default is 48 KB); each kernel remembers the highest limit it was given.
template <class K>
int allow_smem(K kernel, int bytes, int& allowed) {
  if (bytes <= 48 * 1024 || bytes <= allowed) return 0;
  const int err = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == 0) allowed = bytes;
  return err;
}

template <class T, bool VEC, Epi EPI>
int launch_tile(const float* u, const float* q, const uint32_t* bits,
                const float* bias, float* out, int B, int I, int d, int W,
                cudaStream_t stream) {
  static int allowed = 0;
  const int bytes = T::smem(d);
  const int err = allow_smem(dot_tile_kernel<T, VEC, EPI>, bytes, allowed);
  if (err != 0) return err;
  const dim3 grid((B + T::BM - 1) / T::BM, (I + T::BN - 1) / T::BN);
  dot_tile_kernel<T, VEC, EPI><<<grid, T::THREADS, bytes, stream>>>(
      u, q, bits, bias, out, B, I, d, W);
  return (int)cudaGetLastError();
}

// The 128 x 128 tile (SCORES, GMAX): each of the user blocks gets sms /
// user blocks strips (at least one), so that one wave fills the card's sms
// SMs.  TOPK: a strip per TILE_I-item tile.
template <bool VEC, Epi EPI>
int launch_strip(const float* u, const float* q, const uint32_t* bits,
                 const float* bias, float* out, float* gmax, int B, int I,
                 int d, int W, int sms, cudaStream_t stream) {
  static int allowed = 0;
  const int bytes = strip::smem(d, EPI);
  const int err = allow_smem(dot_strip_kernel<VEC, EPI>, bytes, allowed);
  if (err != 0) return err;
  const int users = (B + strip::BM - 1) / strip::BM;
  int strips, len, ld;
  if (EPI == TOPK) {
    strips = (I + TILE_I - 1) / TILE_I;
    len = strip::SUB;
    ld = strips * TILE_I;
  } else {
    const int subs = (I + strip::BN - 1) / strip::BN;
    const int per = sms / users > 1 ? sms / users : 1;
    len = (subs + per - 1) / per;
    strips = (subs + len - 1) / len;
    ld = I;
  }
  dot_strip_kernel<VEC, EPI><<<dim3(users, strips), strip::THREADS, bytes, stream>>>(
      u, q, bits, bias, out, gmax, B, I, ld, d, W, len);
  return (int)cudaGetLastError();
}

// dot_scores or dot_gmax (EPI) at block tile `tile`.
template <Epi EPI>
int launch(const float* u, const float* q, const uint32_t* bits,
           const float* bias, float* out, int B, int I, int d, int W,
           int tile, int vec, int sms, cudaStream_t stream) {
  switch (d > KC * WHOLE ? 0 : tile) {
    case 0:
      return vec ? launch_strip<true, EPI>(u, q, bits, bias, out, nullptr, B,
                                           I, d, W, sms, stream)
                 : launch_strip<false, EPI>(u, q, bits, bias, out, nullptr, B,
                                            I, d, W, sms, stream);
    case 1:
      return vec ? launch_tile<Mid, true, EPI>(u, q, bits, bias, out, B, I, d,
                                               W, stream)
                 : launch_tile<Mid, false, EPI>(u, q, bits, bias, out, B, I,
                                                d, W, stream);
    case 2:
      return vec ? launch_tile<Narrow, true, EPI>(u, q, bits, bias, out, B, I,
                                                  d, W, stream)
                 : launch_tile<Narrow, false, EPI>(u, q, bits, bias, out, B,
                                                   I, d, W, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Pointers are device pointers; bias may be null.  bits is [B, W] with
// W = ceil(I / 32); the result is 0 or a cudaError_t.  tile indexes the
// block tile (0: 128 x 128 strips, 1: 64 x 64, 2: 32 x 64 users x items;
// past d = 256 always 0); vec is 1 where u and q may be staged with
// 16-byte copies (d % 4 == 0, both bases 16-byte aligned), else 0; sms is
// the card's SM count, which the 128 x 128 tile's strips fill.
extern "C" int dot_scores(const float* u, const float* q, const uint32_t* bits,
                          const float* bias, float* out, int B, int I, int d,
                          int W, int tile, int vec, int sms,
                          cudaStream_t stream) {
  return launch<SCORES>(u, q, bits, bias, out, B, I, d, W, tile, vec, sms,
                        stream);
}

// out is [B, ceil(I / 32)]; the other arguments as for dot_scores.
extern "C" int dot_gmax(const float* u, const float* q, const uint32_t* bits,
                        const float* bias, float* out, int B, int I, int d,
                        int W, int tile, int vec, int sms,
                        cudaStream_t stream) {
  return launch<GMAX>(u, q, bits, bias, out, B, I, d, W, tile, vec, sms,
                      stream);
}

// out is [B, Ipad] and gmax [B, Ipad / 32], Ipad = I rounded up to
// TILE_I; both are written in full.  vec as for dot_scores.
extern "C" int dot_topk_scores(const float* u, const float* q,
                               const uint32_t* bits, const float* bias,
                               float* out, float* gmax, int B, int I, int d,
                               int W, int vec, cudaStream_t stream) {
  return vec ? launch_strip<true, TOPK>(u, q, bits, bias, out, gmax, B, I, d,
                                        W, 0, stream)
             : launch_strip<false, TOPK>(u, q, bits, bias, out, gmax, B, I, d,
                                         W, 0, stream);
}
