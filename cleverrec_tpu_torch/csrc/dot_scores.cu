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
// dot_scores and dot_topk_scores share one FP32 mainloop (fma_chunk):
// - Register tile.  Each thread keeps TM x TN sums (8 x 8 in the 128-user
//   tiles) and reads its operands from shared memory as float4: per 4
//   depth columns, TM + TN 16-byte loads feed 4 TM TN FMAs (1 load per 16
//   FMAs at 8 x 8; dot_gmax's 4 x 4 tile spends 1 scalar load per 2).
// - Layout.  u and q are [rows, d] with d contiguous, so shared memory
//   keeps chunks of 32 depth columns, each rows x 32 floats (a row stride
//   the mainloop knows at compile time) of 16-byte pieces.  A thread owns
//   item rows 4 tx + 64 j + c (tx < 16), whose float4 stores are
//   contiguous; piece g of item row n sits at piece g ^ ((n >> 2) & 7), so
//   the 8 threads of a quarter-warp, which read rows 4 tx + c with the
//   same g, hit 8 different bank groups.  The user rows of a quarter-warp
//   are one row (a broadcast) and need no swizzle.
// - Staging.  cp.async copies, 16 bytes where d % 4 == 0 and both bases
//   are 16-byte aligned (the wrapper passes the flag), else 4 bytes (the
//   scalar path, for views such as table[1:]), zero-filled past the edges.
//   A ring of depth chunks lets the next chunk load while the current one
//   is multiplied; dot_scores' 64- and 32-user tiles stage the whole depth
//   (d <= 256; deeper inputs take the strip kernel) in one group instead:
//   one wait and one barrier.
// - Plain FP32 sums.  Each output is one fmaf chain in increasing depth
//   order, as a float32 matrix product on the card sums it; the zero
//   columns past d add 0 exactly.  No TF32.
// dot_topk_scores and dot_scores' 128 x 128 tile run the strip kernel: a
// block keeps its 128 user rows in shared memory for a whole strip of
// 128-item sub-tiles (a 4096-item tile for dot_topk_scores, loaded once,
// not once per sub-tile), walks the strip through the ring without a break
// between sub-tiles, and applies bias and mask in registers;
// dot_topk_scores stores float4s and keeps its comb maxes per thread (see
// dot_strip_kernel).  Grids run users along x, so the blocks that share q
// rows run together and read them from L2.  dot_scores picks its tile
// (scores.py's _scores_tile, on the SM count the wrapper passes: 132 on
// an H100 SXM) so that its grid fills the card, and writes through shared
// memory so that its stores are coalesced whatever I % 4.
//
// dot_gmax keeps its own design (namespace group_max): a 64 x 64 block
// tile, 32 depth columns a pass, 4 x 4 sums a thread, scalar shared loads;
// its epilogue max-reduces each aligned 32-item group across 16 lanes with
// __shfl_xor_sync and writes one float.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG = -3.0e38f;  // finite mask value, as on the TPU
constexpr int TILE_I = 4096;  // dot_topk_scores: items per tile, as on the TPU
constexpr int GROUP_LANES = 128;  // dot_topk_scores: gmax lanes per tile
constexpr int KC = 32;        // depth columns per staged chunk: 8 pieces

// ---------------------------------------------------------------- dot_gmax

namespace group_max {

constexpr int BM = 64;        // users per block
constexpr int BN = 64;        // items per block: two 32-item groups
constexpr int BK = 32;        // depth columns staged per pass
constexpr int TX = 16;        // threads along items
constexpr int TY = 16;        // threads along users
constexpr int RM = BM / TY;   // users per thread
constexpr int RN = BN / TX;   // items per thread: tx, tx + 16, tx + 32, tx + 48
constexpr int WPB = BN / 32;  // bitmap words per block row

static_assert(BM == BN, "one loop stages both tiles");
static_assert(TX == 16 && RN == 4, "group g of a row is items j = 2g, 2g + 1 of a thread");

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

__global__ void __launch_bounds__(TX * TY)
dot_gmax_kernel(const float* __restrict__ u, const float* __restrict__ q,
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

}  // namespace group_max

// ------------------------------------------------ the shared FP32 mainloop

__device__ __forceinline__ void cp16(float* dst, const float* src, int n) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(n) : "memory");
}

__device__ __forceinline__ void cp4(float* dst, const float* src, int n) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(s), "l"(src), "r"(n) : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

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

// ----------------------------------------- dot_scores' 64- and 32-user tiles

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

// dot_scores' tiles 1 and 2 (scores.py's SCORE_TILES); tile 0 is the
// strip kernel's.
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
// q tile run together and read it from L2.
template <class T, bool VEC>
__global__ void __launch_bounds__(T::THREADS)
dot_scores_kernel(const float* __restrict__ u, const float* __restrict__ q,
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
// thread) or dot_scores' BM x BN staging tile.
__host__ __device__ constexpr int extra(bool topk) {
  return topk ? TM * 4 * THREADS : BM * TS;
}

// Is the block's whole u (depth dp) kept in shared memory beside a ring of
// q chunks, or staged by chunks beside q's?
__host__ __device__ constexpr bool u_whole(int dp, bool topk) {
  return 4 * (BM * dp + STAGES * BN * KC + extra(topk)) <= SMEM_MAX;
}

// Dynamic shared memory of a block at depth d, bytes.
int smem(int d, bool topk) {
  const int dp = (d > KC ? (d + KC - 1) / KC : 1) * KC;
  return 4 * ((u_whole(dp, topk) ? BM * dp + STAGES * BN * KC
                                 : STAGES * (BM + BN) * KC) + extra(topk));
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
// Else (dot_scores' 128 x 128 tile): a strip is `len` sub-tiles, out is
// [B, ld = I], and each sub-tile goes out through store_rows.
template <bool VEC, bool TOPK>
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
  const bool whole = u_whole(dp, TOPK);
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

  if (TOPK)
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

    if (!TOPK) {
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
  if (!TOPK) return;

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

template <class T, bool VEC>
int launch_tile(const float* u, const float* q, const uint32_t* bits,
                const float* bias, float* out, int B, int I, int d, int W,
                cudaStream_t stream) {
  static int allowed = 0;
  const int bytes = T::smem(d);
  const int err = allow_smem(dot_scores_kernel<T, VEC>, bytes, allowed);
  if (err != 0) return err;
  const dim3 grid((B + T::BM - 1) / T::BM, (I + T::BN - 1) / T::BN);
  dot_scores_kernel<T, VEC><<<grid, T::THREADS, bytes, stream>>>(
      u, q, bits, bias, out, B, I, d, W);
  return (int)cudaGetLastError();
}

// dot_scores' 128 x 128 tile: each of the user blocks gets sms / user
// blocks strips (at least one), so that one wave fills the card's sms SMs.
// Else dot_topk_scores: a strip per TILE_I-item tile.
template <bool VEC, bool TOPK>
int launch_strip(const float* u, const float* q, const uint32_t* bits,
                 const float* bias, float* out, float* gmax, int B, int I,
                 int d, int W, int sms, cudaStream_t stream) {
  static int allowed = 0;
  const int bytes = strip::smem(d, TOPK);
  const int err = allow_smem(dot_strip_kernel<VEC, TOPK>, bytes, allowed);
  if (err != 0) return err;
  const int users = (B + strip::BM - 1) / strip::BM;
  int strips, len, ld;
  if (TOPK) {
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
  dot_strip_kernel<VEC, TOPK><<<dim3(users, strips), strip::THREADS, bytes, stream>>>(
      u, q, bits, bias, out, gmax, B, I, ld, d, W, len);
  return (int)cudaGetLastError();
}

template <class T>
int launch_tile(const float* u, const float* q, const uint32_t* bits,
                const float* bias, float* out, int B, int I, int d, int W,
                int vec, cudaStream_t stream) {
  return vec ? launch_tile<T, true>(u, q, bits, bias, out, B, I, d, W, stream)
             : launch_tile<T, false>(u, q, bits, bias, out, B, I, d, W, stream);
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
  switch (d > KC * WHOLE ? 0 : tile) {
    case 0:
      return vec ? launch_strip<true, false>(u, q, bits, bias, out, nullptr, B,
                                             I, d, W, sms, stream)
                 : launch_strip<false, false>(u, q, bits, bias, out, nullptr,
                                              B, I, d, W, sms, stream);
    case 1: return launch_tile<Mid>(u, q, bits, bias, out, B, I, d, W, vec, stream);
    case 2: return launch_tile<Narrow>(u, q, bits, bias, out, B, I, d, W, vec, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int dot_gmax(const float* u, const float* q, const uint32_t* bits,
                        const float* bias, float* out, int B, int I, int d,
                        int W, cudaStream_t stream) {
  const dim3 grid((I + group_max::BN - 1) / group_max::BN,
                  (B + group_max::BM - 1) / group_max::BM);
  group_max::dot_gmax_kernel<<<grid, group_max::TX * group_max::TY, 0, stream>>>(
      u, q, bits, bias, out, B, I, d, W);
  return (int)cudaGetLastError();
}

// out is [B, Ipad] and gmax [B, Ipad / 32], Ipad = I rounded up to
// TILE_I; both are written in full.  vec as for dot_scores.
extern "C" int dot_topk_scores(const float* u, const float* q,
                               const uint32_t* bits, const float* bias,
                               float* out, float* gmax, int B, int I, int d,
                               int W, int vec, cudaStream_t stream) {
  return vec ? launch_strip<true, true>(u, q, bits, bias, out, gmax, B, I, d,
                                        W, 0, stream)
             : launch_strip<false, true>(u, q, bits, bias, out, gmax, B, I, d,
                                         W, 0, stream);
}
