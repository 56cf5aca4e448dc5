// One CML (collaborative metric learning) training epoch with dense Adam on
// Hopper (sm_90a), behind a plain C interface that
// cleverrec_tpu_torch/ops/train.py loads with ctypes.
//
// Replaces fused_cml_epoch of cleverrec_tpu/ops/pallas_train.py
// (_cml_kernel, pallas_call :1610).  For each step s of the epoch, over the
// B pre-sampled rows (u, i, n_1 .. n_K) of row s:
//
//   d_ui = |P[u] - Q[i]|^2,  d_k = |P[u] - Q[n_k]|^2
//   d_min = min_k d_k, n_sel its argmin (exact ties: the lowest item id)
//   cnt  = #{k : d_ui + margin - d_k > 0}   (duplicate ids count twice)
//   wlog = log(cnt / K * item_nums / K + 1)   (no gradient through it)
//   loss[s] += wlog * max(d_ui + margin - d_min, 0)
//   c = wlog [d_ui + margin - d_min > 0]
//   dP[u]     += 2c (Q[n_sel] - Q[i])
//   dQ[i]     += -2c (P[u] - Q[i])
//   dQ[n_sel] += 2c (P[u] - Q[n_sel])       (duplicate ids sum)
//
// then the covariance regulariser over the n = U + I rows of concat(Q, P),
// on the tables BEFORE this step's update, in closed form: with mu the
// column mean, xc = x - mu and s_r the row sum of xc,
//
//   grad[r] += reg (2 / n) (s_r - xc[r]),  loss[s] += reg (sum_r s_r^2 - |xc|_F^2) / n
//
// and dense Adam over ALL of P and Q at step t0 + s + 1 (epoch.cuh).  An id
// outside its table (the trainer's sentinels U_pad - 1, I_pad - 1) reads a
// zero row and writes nothing: a sentinel row adds margin log(item_nums / K
// + 1) to the loss (its slack is margin and all K negatives are imposters)
// and changes nothing else; the caller subtracts it.
//
// The TPU kernel fits its 16 MB of VMEM with one [I_pad, blk] distance
// matrix and a multiplicity mask in place of the K gathers, walks the item
// axis in slabs, and gathers and scatters by one-hot matrix products.  None
// of that carries over: here a warp reads a row's K + 2 table rows
// directly, and the sequential grid is one persistent kernel, cml_persist
// (persist.cuh): one cooperative launch an epoch, one wave of blocks of 512
// threads, two grid barriers a step.
//
//   prologue  the grid zeroes the dP, dQ scratch and sums the tables'
//             columns into the blocks' slices (as phase B does); a
//             barrier.
//   phase A   a warp a row, the rows spread over the blocks: lane l owns
//             columns W l + 32 W p (W = 4: float4 rows, where d % 4 == 0
//             and the state is 16-byte aligned; W = 1 the scalar
//             variant); the row's candidate ids (i, then the K negatives,
//             a lane each) are loaded while the warp's previous row is
//             done, and each lane issues its pieces of up to CHUNK
//             candidate rows before the first sum, so a row costs one L2
//             round trip at the conf's K 20 (at d <= 32 W, the conf's
//             128, a variant of one piece a lane).  Each lane adds its
//             squares without FMA (add_sq), an xor butterfly adds the
//             lanes; the count, the argmin and, for an active row, three
//             row gradients by float4 reductions (persist.cuh's
//             atomic_add, sm_90).  Then the grid's last
//             warps (the fewest rows) sum the blocks' column-sum slices in
//             block order into colsum [d], the column sums of concat(Q, P)
//             before the step.  A barrier.
//   phase B   a warp a row of concat(Q, P), spread over the blocks: xc,
//             s_r, the regulariser's gradient and loss, Adam on the row
//             (epoch.cuh's adam_val; at d <= 32 W one round trip for x,
//             its moments and gradient), the gradient zeroed; the row's
//             new values added into the warp's column sums in shared
//             memory (global memory past d 3584, CML_SMEM_D), which the
//             block adds in warp order into its slice
//             [blocks, d] for the next step; the block's loss of the step
//             into part_loss[s, block]; the next step's ids prefetched.
//             A barrier.
//
// Then the steps' losses are summed (persist.cuh's finish_losses).  The
// column sums and the loss are the same from run to run after one step;
// the tables' row sums use f32 atomics, whose order varies, so the state
// matches the plain version to a tolerance, not bit for bit.  The
// distances are summed in an order the plain version repeats
// (ops/train.py _lane_sq_dist), so both pick the same negatives.
//
// What bounds it on an H100: per step the rows read (K + 2) B table rows
// of d floats, 69 MB at the conf's shape (K 20, B 6144, d 128), and the
// state (2625 x 128 floats and its moments, 8 MB) stays in the 50 MB L2,
// so a step is bound by L2 traffic and its two barriers, far above the
// least time of the function (its FP32 operations).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "epoch.cuh"
#include "persist.cuh"

// Outside the unnamed namespace: a type of the C interface must not have
// internal linkage.  ops/train.py's _CmlArgs must agree with it field for
// field.
struct CmlArgs {
  // P [U, d], Q [I, d] and their moments; dP, dQ scratch.
  float *P, *Q, *mP, *vP, *mQ, *vQ, *dP, *dQ;
  const int32_t *u, *i, *negs;   // [steps, B], [steps, B], [steps, B, K]
  const float* bc;               // [steps, 2]: Adam's bias corrections
  float* colsum;                 // [d]: the step's column sums of concat(Q, P)
  float* colpart;                // [blocks, d]: each block's column sums
  float* colwarp;                // [blocks, 16, d]: the warps' column sums
                                 // where d > CML_SMEM_D, else unused
  float* part_loss;              // [steps, blocks]
  float* loss;                   // [steps + 1]: each step's, then the sum
  unsigned* bar;                 // [2]: the barrier's and finish_losses' counters
  int U, I, d, steps, B, K, blocks, vec;
  float lr, reg, margin, item_nums, eps;
  double b1, b2;
};

namespace {

constexpr int THREADS = PERSIST_THREADS;
constexpr int WARPS = PERSIST_WARPS;
// Candidate rows a lane has in flight: the conf's K + 1 (K 20).  On an
// H100 at the conf's shape, 21 took the fewest cycles a step for the rows
// of the sizes tried (8, 12, 16, 21, 24), and L2-only loads no fewer.
constexpr int CHUNK = 21;
static_assert(CHUNK <= 32, "a lane loads one candidate's id");
// The warps' column sums, WARPS x d floats, fit a block's 227 KB of
// shared memory up to this d; past it they are kept in global memory
// (colwarp), each warp's row written and read by its own lanes and then
// by its block.
constexpr int CML_SMEM_D = 3584;

// acc + x^2, rounded after the product and after the sum (no FMA), so
// that the plain version (ops/train.py _lane_sq_dist) can add the same
// squares in the same order and get the same distances bit for bit: the
// argmin and the imposter count then agree, where a near tie between two
// negatives would otherwise pick either.
__device__ __forceinline__ float add_sq(float acc, float x) {
  return __fadd_rn(acc, __fmul_rn(x, x));
}

template <int W>
struct Piece {
  float a[W];
};

// W floats of a table at p, or zeros where ``ok`` is false (plain loads:
// the tables change during the launch).
template <int W>
__device__ __forceinline__ Piece<W> ld(const float* p, bool ok) {
  Piece<W> r;
  if constexpr (W == 4) {
    const float4 t = ok ? *reinterpret_cast<const float4*>(p)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
    r.a[0] = t.x;
    r.a[1] = t.y;
    r.a[2] = t.z;
    r.a[3] = t.w;
  } else {
    r.a[0] = ok ? *p : 0.f;
  }
  return r;
}

template <int W>
__device__ __forceinline__ void st4(float* p, const Piece<W>& v) {
  if constexpr (W == 4)
    *reinterpret_cast<float4*>(p) = make_float4(v.a[0], v.a[1], v.a[2], v.a[3]);
  else
    *p = v.a[0];
}

// Row r of concat(Q, P): Q's rows first, then P's.
__device__ __forceinline__ size_t cat_off(int r, int I, int d, bool* on_q) {
  *on_q = r < I;
  return (size_t)(r < I ? r : r - I) * d;
}

// A row's ids: u, i, and in lane j < CHUNK candidate j's id (candidate
// 0 is i, candidate j > 0 the negative n_j); a shuffle hands an id out
// where it is needed (an array of ids would cost CHUNK registers).
struct RowIds {
  int u, i, cand;
};

// Row b of step s's ids (a whole warp); b past B: none.
__device__ __forceinline__ RowIds row_ids(const CmlArgs& a, int s, int b) {
  const int lane = threadIdx.x & 31;
  if (b >= a.B) return {-1, -1, -1};
  const size_t row = (size_t)s * a.B + b;
  const int i = __ldg(a.i + row);
  return {__ldg(a.u + row), i,
          lane == 0 ? i
          : lane < CHUNK && lane <= a.K ? __ldg(a.negs + row * a.K + lane - 1)
                                        : -1};
}

// One row of step s (a whole warp), its ids loaded ahead: its hinge term
// of the loss, and for an active row its three row gradients.  Returns
// the term (every lane).  ONE: d <= 32 W, one piece a lane.
template <int W, bool ONE>
__device__ float cml_row(const CmlArgs& a, int s, int b, const RowIds& r) {
  const int lane = threadIdx.x & 31, d = a.d, K = a.K;
  const int u = r.u, i = r.i;
  const bool ru = (unsigned)u < (unsigned)a.U;
  const float* pu = a.P + (size_t)(ru ? u : 0) * d;
  const int32_t* negs = a.negs + ((size_t)s * a.B + b) * K;
  const int passes = ONE ? 1 : (d + 32 * W - 1) / (32 * W);
  float d_ui = 0.f, d_min = INFINITY;
  int sel = 0x7fffffff, cnt = 0;
  // CHUNK candidates at a time.
  for (int c0 = 0; c0 <= K; c0 += CHUNK) {
    const int c = c0 + lane;
    const int my_id = c0 == 0 ? r.cand
                      : lane < CHUNK && c <= K ? negs[c - 1] : -1;
    float acc[CHUNK];
#pragma unroll
    for (int j = 0; j < CHUNK; ++j) acc[j] = 0.f;
    for (int p = 0; p < passes; ++p) {
      const int col = W * lane + 32 * W * p;
      const bool in = col < d;
      const Piece<W> pe = ld<W>(pu + col, in && ru);
      Piece<W> q[CHUNK];
#pragma unroll
      for (int j = 0; j < CHUNK; ++j) {
        const int n = __shfl_sync(0xffffffffu, my_id, j);
        const bool rn = (unsigned)n < (unsigned)a.I;
        q[j] = ld<W>(a.Q + (size_t)(rn ? n : 0) * d + col, in && rn);
      }
#pragma unroll
      for (int j = 0; j < CHUNK; ++j)
#pragma unroll
        for (int e = 0; e < W; ++e) acc[j] = add_sq(acc[j], pe.a[e] - q[j].a[e]);
    }
#pragma unroll
    for (int j = 0; j < CHUNK; ++j) {
      if (c0 + j > K) break;
      const float dist = warp_sum(acc[j]);
      if (c0 + j == 0) {
        d_ui = dist;
        continue;
      }
      const int n = __shfl_sync(0xffffffffu, my_id, j);
      cnt += d_ui + a.margin - dist > 0.f;
      if (dist < d_min || (dist == d_min && n < sel)) {
        d_min = dist;
        sel = n;
      }
    }
  }
  // The reference's rank as written (CML.py:50-53): mean(imposters) *
  // item_nums / K, in this order.
  const float wlog = logf((float)cnt / (float)K * a.item_nums / (float)K + 1.f);
  const float slack = d_ui + a.margin - d_min;
  if (slack > 0.f) {
    const float c2 = 2.f * wlog;
    const bool ri = (unsigned)i < (unsigned)a.I;
    const bool rs = (unsigned)sel < (unsigned)a.I;
    const float* qi = a.Q + (size_t)(ri ? i : 0) * d;
    const float* qs = a.Q + (size_t)(rs ? sel : 0) * d;
    for (int col = W * lane; col < d; col += 32 * W) {
      const Piece<W> pe = ld<W>(pu + col, ru), qv = ld<W>(qi + col, ri),
                     sv = ld<W>(qs + col, rs);
      float gp[W], gi[W], gs[W];
#pragma unroll
      for (int e = 0; e < W; ++e) {
        gp[e] = c2 * (sv.a[e] - qv.a[e]);
        gi[e] = -c2 * (pe.a[e] - qv.a[e]);
        gs[e] = c2 * (pe.a[e] - sv.a[e]);
      }
      if (ru) atomic_add<W>(a.dP + (size_t)u * d + col, gp);
      if (ri) atomic_add<W>(a.dQ + (size_t)i * d + col, gi);
      if (rs) atomic_add<W>(a.dQ + (size_t)sel * d + col, gs);
    }
  }
  return wlog * fmaxf(slack, 0.f);
}

// Row r of concat(Q, P) (a whole warp): the regulariser's gradient and
// Adam; the row's new values are added into colw, this warp's column sums
// (a lane owns its columns there).  Returns the row's regulariser loss
// (every lane).  ONE: d <= 32 W, one piece a lane.
template <int W, bool ONE>
__device__ float cov_adam_row(const CmlArgs& a, int r, const AdamStep& st,
                              float* colw) {
  const int lane = threadIdx.x & 31, d = a.d;
  const float n = (float)(a.U + a.I);
  bool on_q;
  const size_t off = cat_off(r, a.I, d, &on_q);
  float* x = (on_q ? a.Q : a.P) + off;
  float* m = (on_q ? a.mQ : a.mP) + off;
  float* v = (on_q ? a.vQ : a.vP) + off;
  float* g = (on_q ? a.dQ : a.dP) + off;
  const float g_cov = 2.f * a.reg / n;
  const int col = W * lane;
  if (ONE) {
    // One piece a lane: x, its moments, its gradient and the column
    // sums in one round trip, held in registers.
    const bool in = col < d;
    Piece<W> xv = ld<W>(x + col, in), mv = ld<W>(m + col, in),
             vv = ld<W>(v + col, in), gv = ld<W>(g + col, in),
             cs = ld<W>(a.colsum + col, in);
    float xc[W], s = 0.f, sq = 0.f;
#pragma unroll
    for (int e = 0; e < W; ++e) {
      xc[e] = in ? xv.a[e] - cs.a[e] / n : 0.f;
      s += xc[e];
      sq = fmaf(xc[e], xc[e], sq);
    }
    s = warp_sum(s);
    sq = warp_sum(sq);
    if (in) {
#pragma unroll
      for (int e = 0; e < W; ++e) {
        adam_val(xv.a[e], mv.a[e], vv.a[e], gv.a[e] + g_cov * (s - xc[e]), st);
        colw[col + e] += xv.a[e];
      }
      st4<W>(x + col, xv);
      st4<W>(m + col, mv);
      st4<W>(v + col, vv);
      st4<W>(g + col, Piece<W>{});
    }
    return a.reg * (s * s - sq) / n;
  }
  float s = 0.f, sq = 0.f;
  for (int c = col; c < d; c += 32 * W) {
    const Piece<W> xv = ld<W>(x + c, true), cs = ld<W>(a.colsum + c, true);
#pragma unroll
    for (int e = 0; e < W; ++e) {
      const float xc = xv.a[e] - cs.a[e] / n;
      s += xc;
      sq = fmaf(xc, xc, sq);
    }
  }
  s = warp_sum(s);
  sq = warp_sum(sq);
  // Every lane has read the whole row's sums before any lane writes it.
  for (int c = col; c < d; c += 32 * W) {
    Piece<W> xv = ld<W>(x + c, true), mv = ld<W>(m + c, true),
             vv = ld<W>(v + c, true), gv = ld<W>(g + c, true);
    const Piece<W> cs = ld<W>(a.colsum + c, true);
#pragma unroll
    for (int e = 0; e < W; ++e) {
      const float xc = xv.a[e] - cs.a[e] / n;
      adam_val(xv.a[e], mv.a[e], vv.a[e], gv.a[e] + g_cov * (s - xc), st);
      colw[c + e] += xv.a[e];
    }
    st4<W>(x + c, xv);
    st4<W>(m + c, mv);
    st4<W>(v + c, vv);
    st4<W>(g + c, Piece<W>{});
  }
  return a.reg * (s * s - sq) / n;
}

// The block's column sums: its warps' colw (``cols`` [WARPS][d], shared
// or global memory) added in warp order into the block's slice of colpart
// [blocks, d]; colw zeroed again.
__device__ __forceinline__ void fold_columns(const CmlArgs& a, float* cols) {
  __syncthreads();
  for (int c = threadIdx.x; c < a.d; c += THREADS) {
    float acc = 0.f;
    for (int w = 0; w < WARPS; ++w) {
      acc += cols[w * a.d + c];
      cols[w * a.d + c] = 0.f;
    }
    a.colpart[(size_t)blockIdx.x * a.d + c] = acc;
  }
}

template <int W, bool ONE>
__global__ void __launch_bounds__(THREADS)
cml_persist(CmlArgs a, AdamBase ab) {
  extern __shared__ float smem_cols[];
  __shared__ float loss_w[WARPS];
  PERSIST_CLOCK_INIT
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int G = gridDim.x, B = a.B, rows = a.U + a.I, d = a.d;
  // [WARPS][d]: each warp's column sums.
  float* cols = d <= CML_SMEM_D ? smem_cols
                                : a.colwarp + (size_t)blockIdx.x * WARPS * d;
  float* colw = cols + warp * d;
  unsigned round = 0;
  for (int c = threadIdx.x; c < WARPS * d; c += THREADS) cols[c] = 0.f;
  grid_zero(a.dP, (int64_t)a.U * d);
  grid_zero(a.dQ, (int64_t)a.I * d);
  // The column sums of the tables before step 0, as phase B leaves them
  // before each later step: a warp its phase-B rows.
  __syncthreads();
  for (int r = grid_warp(); r < rows; r += WARPS * G) {
    bool on_q;
    const float* x = (r < a.I ? a.Q : a.P) + cat_off(r, a.I, d, &on_q);
    for (int c = W * lane; c < d; c += 32 * W) {
      const Piece<W> xv = ld<W>(x + c, true);
#pragma unroll
      for (int e = 0; e < W; ++e) colw[c + e] += xv.a[e];
    }
  }
  fold_columns(a, cols);
  const int64_t plane = (int64_t)B * sizeof(int32_t);
  if (a.steps > 0) {
    prefetch_l2(a.u, plane);
    prefetch_l2(a.i, plane);
    prefetch_l2(a.negs, plane * a.K);
  }
  const int warps = WARPS * G;
  RowIds ahead = a.steps > 0 ? row_ids(a, 0, grid_warp())
                             : RowIds{-1, -1, -1};
  grid_sync(a.bar, round);
  for (int s = 0; s < a.steps; ++s) {
    // -- phase A: the rows' hinges and row grads; the column sums --------
    float warp_loss = 0.f;
    for (int b = grid_warp(); b < B; b += warps) {
      // The next row's ids in flight while this row is done.
      const RowIds cur = ahead;
      ahead = row_ids(a, s, b + warps);
      warp_loss += cml_row<W, ONE>(a, s, b, cur);
    }
    PERSIST_PHASE(0);
    // The step's column sums, from the blocks' slices: the grid's last
    // warps, which have the fewest rows.
    for (int c = warps - 1 - grid_warp(); c < d; c += warps) {
      const float sum = slice_sum(a.colpart + c, d, G);
      if (lane == 0) a.colsum[c] = sum;
    }
    PERSIST_PHASE(1);
    grid_sync(a.bar, round);
    PERSIST_PHASE(2);
    // -- phase B: the regulariser and Adam, a warp a row -------------------
    if (s + 1 < a.steps) {
      const size_t next = (size_t)(s + 1) * B;
      prefetch_l2(a.u + next, plane);
      prefetch_l2(a.i + next, plane);
      prefetch_l2(a.negs + next * a.K, plane * a.K);
      ahead = row_ids(a, s + 1, grid_warp());
    }
    const AdamStep st = step_at(ab, a.bc, s);
    for (int r = grid_warp(); r < rows; r += WARPS * G)
      warp_loss += cov_adam_row<W, ONE>(a, r, st, colw);
    if (lane == 0) loss_w[warp] = warp_loss;
    fold_columns(a, cols);
    if (threadIdx.x == 0) {
      float l = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) l += loss_w[w];
      a.part_loss[(size_t)s * G + blockIdx.x] = l;
    }
    PERSIST_PHASE(3);
    grid_sync(a.bar, round);
    PERSIST_PHASE(4);
  }
  finish_losses(a.part_loss, a.loss, a.steps, a.bar + 1);
  PERSIST_CLOCK_STORE
}

// The variant for vec and d: W = 4 where vec, else W = 1; one piece a
// lane where d <= 32 W (on an H100 at CML's conf shape, d 128, the
// one-piece variant took 0.482 device ms an epoch against the general
// loop's 0.515: tools/epoch_ab.py, PERF.md section 5).
PersistKernel pick(int vec, int d) {
  const void* k = vec ? (d <= 128 ? (const void*)cml_persist<4, true>
                                  : (const void*)cml_persist<4, false>)
                      : (d <= 32 ? (const void*)cml_persist<1, true>
                                 : (const void*)cml_persist<1, false>);
  return {k, THREADS};
}

// The warps' column sums in dynamic shared memory, where they fit.
size_t smem_bytes(int d) {
  return d <= CML_SMEM_D ? (size_t)WARPS * d * sizeof(float) : 0;
}

}  // namespace

// The variant for vec at width d: the blocks of it that an SM holds at
// once and its threads a block, into *per_sm and *threads; returns 0 or a
// cudaError_t.
extern "C" int cml_epoch_occupancy(int vec, int d, int* per_sm,
                                   int* threads) {
  const PersistKernel k = pick(vec, d);
  const cudaError_t err = cudaFuncSetAttribute(
      k.fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes(d));
  if (err != cudaSuccess) return (int)err;
  return persist_occupancy(k, smem_bytes(d), per_sm, threads);
}

// All pointers in ``a`` are device pointers; the parameters and their
// Adam moments are updated in place, and the scratch (dP, dQ, colsum,
// colpart, colwarp, part_loss, loss, bar) needs no initial value (colwarp:
// [blocks, 16, d] where d > 3584, else unused); bc [steps, 2] holds the
// bias corrections of steps t0 + 1 .. t0 + steps.  loss[s] receives step
// s's summed loss and loss[steps] their sum.  vec: d % 4 == 0 and every
// state tensor 16-byte aligned.  blocks: at most the SM count times
// cml_epoch_occupancy's count (one cooperative wave).  Returns 0, or the
// cudaError_t of the launch (cudaErrorInvalidValue for a shape the kernel
// does not take; cudaErrorCooperativeLaunchTooLarge when the wave does
// not fit).
extern "C" int cml_epoch(const CmlArgs* a, cudaStream_t stream) {
  if (a->d < 1 || a->K < 1 || a->blocks < 1 ||
      a->B < 0 || a->steps < 0 || (a->vec && a->d % 4))
    return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      pick(a->vec, a->d).fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_bytes(a->d));
  if (err != cudaSuccess) return (int)err;
  CmlArgs args = *a;
  AdamBase ab = adam_base(a->lr, a->b1, a->b2, a->eps);
  void* params[] = {&args, &ab};
  return persist_launch(pick(a->vec, a->d), a->blocks, params, args.bar,
                        stream, smem_bytes(a->d));
}

extern "C" const char* cml_epoch_error(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
