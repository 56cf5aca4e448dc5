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
// of that carries over: here a warp reads its K + 2 rows directly.  The
// sequential grid becomes a host loop, three launches a step:
//
//   cml_slots   blocks of 8 warps, each warp a row at a time over a grid
//               stride (capped at 264 blocks); lanes walk d with stride 32,
//               so a warp reads each row as 128-byte lines; shuffle sums
//               give the K + 1 distances, and a running (distance, id)
//               minimum the argmin; a row whose hinge is active scatters
//               its three row grads into the dP/dQ scratch by atomicAdd;
//               each block adds its rows' loss with one atomic.
//   col_sums    blocks of 32 rows of concat(Q, P) add their column sums
//               into this step's slice of a [steps, d] scratch (one atomic
//               per column per block).
//   cov_adam    one warp per row of P and of Q: xc, s_r, the regulariser's
//               grad and loss, Adam on the row (epoch.cuh's adam_elem), the
//               grad scratch zeroed for the next step; one loss atomic a
//               block.
//
// What bounds it on an H100: per step the slots read (K + 2) B rows of d
// floats, 69 MB at the conf's shape (K 20, B 6144, d 128), and the state
// (2625 x 128 floats and its moments, 8 MB) stays in the 50 MB L2, so a
// step is bound by L2 traffic and the three launches, far above the least
// time of the function (its FP32 operations).  The distances are summed
// in an order the plain version repeats (add_sq), so both pick the same
// negatives; the f32 atomics sum in a run-dependent order, so the state
// matches the plain version to a tolerance, not bit for bit.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "epoch.cuh"

namespace {

constexpr int WARPS = 8;              // warps per block of cml_slots, cov_adam
constexpr int MAX_BLOCKS = 264;       // two blocks per SM of an H100
constexpr int SUM_ROWS = 32;          // rows per block of col_sums

// acc + x^2, rounded after the product and after the sum (no FMA), so
// that the plain version (ops/train.py _lane_sq_dist) can add the same
// squares in the same order and get the same distances bit for bit: the
// argmin and the imposter count then agree, where a near tie between two
// negatives would otherwise pick either.
__device__ __forceinline__ float add_sq(float acc, float x) {
  return __fadd_rn(acc, __fmul_rn(x, x));
}

__global__ void __launch_bounds__(32 * WARPS)
cml_slots(const float* __restrict__ P, const float* __restrict__ Q,
          const int32_t* __restrict__ u_idx, const int32_t* __restrict__ i_idx,
          const int32_t* __restrict__ n_idx, float* __restrict__ dP,
          float* __restrict__ dQ, float* __restrict__ loss, int U, int I,
          int d, int B, int K, float margin, float item_nums) {
  __shared__ float part[WARPS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float warp_loss = 0.f;
  for (int b = blockIdx.x * WARPS + warp; b < B; b += gridDim.x * WARPS) {
    const int u = u_idx[b], i = i_idx[b];
    const bool ru = (unsigned)u < (unsigned)U;
    const bool ri = (unsigned)i < (unsigned)I;
    const float* pu = P + (size_t)(ru ? u : 0) * d;
    const float* qi = Q + (size_t)(ri ? i : 0) * d;
    float acc = 0.f;
    for (int k = lane; k < d; k += 32)
      acc = add_sq(acc, (ru ? pu[k] : 0.f) - (ri ? qi[k] : 0.f));
    const float d_ui = warp_sum(acc);
    const int32_t* negs = n_idx + (size_t)b * K;
    float d_min = INFINITY;
    int sel = 0x7fffffff, cnt = 0;
    for (int j = 0; j < K; ++j) {
      const int n = negs[j];
      const bool rn = (unsigned)n < (unsigned)I;
      const float* qn = Q + (size_t)(rn ? n : 0) * d;
      acc = 0.f;
      for (int k = lane; k < d; k += 32)
        acc = add_sq(acc, (ru ? pu[k] : 0.f) - (rn ? qn[k] : 0.f));
      const float dk = warp_sum(acc);
      cnt += d_ui + margin - dk > 0.f;
      if (dk < d_min || (dk == d_min && n < sel)) {
        d_min = dk;
        sel = n;
      }
    }
    // The reference's rank as written (CML.py:50-53): mean(imposters) *
    // item_nums / K, in this order.
    const float wlog = logf((float)cnt / (float)K * item_nums / (float)K + 1.f);
    const float slack = d_ui + margin - d_min;
    warp_loss += wlog * fmaxf(slack, 0.f);
    if (slack > 0.f) {
      const float c2 = 2.f * wlog;
      const bool rs = (unsigned)sel < (unsigned)I;
      const float* qs = Q + (size_t)(rs ? sel : 0) * d;
      float* dpu = dP + (size_t)(ru ? u : 0) * d;
      float* dqi = dQ + (size_t)(ri ? i : 0) * d;
      float* dqs = dQ + (size_t)(rs ? sel : 0) * d;
      for (int k = lane; k < d; k += 32) {
        const float pe = ru ? pu[k] : 0.f;
        const float qv = ri ? qi[k] : 0.f;
        const float sv = rs ? qs[k] : 0.f;
        if (ru) atomicAdd(dpu + k, c2 * (sv - qv));
        if (ri) atomicAdd(dqi + k, -c2 * (pe - qv));
        if (rs) atomicAdd(dqs + k, c2 * (pe - sv));
      }
    }
  }
  if (lane == 0) part[warp] = warp_loss;
  __syncthreads();
  if (threadIdx.x == 0) {
    float l = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) l += part[w];
    atomicAdd(loss, l);
  }
}

// Row r of concat(Q, P): Q's rows first, then P's.
__device__ __forceinline__ size_t cat_row(int r, int I, size_t d,
                                          const float* Q, const float* P,
                                          const float** base) {
  *base = r < I ? Q : P;
  return (size_t)(r < I ? r : r - I) * d;
}

__global__ void col_sums(const float* __restrict__ P,
                         const float* __restrict__ Q, float* __restrict__ colsum,
                         int U, int I, int d) {
  const int first = blockIdx.x * SUM_ROWS;
  const int last = min(first + SUM_ROWS, U + I);
  for (int k = threadIdx.x; k < d; k += blockDim.x) {
    float acc = 0.f;
    for (int r = first; r < last; ++r) {
      const float* base;
      const size_t off = cat_row(r, I, d, Q, P, &base);
      acc += base[off + k];
    }
    atomicAdd(colsum + k, acc);
  }
}

__global__ void __launch_bounds__(32 * WARPS)
cov_adam(float* __restrict__ P, float* __restrict__ Q, float* __restrict__ mP,
         float* __restrict__ vP, float* __restrict__ mQ, float* __restrict__ vQ,
         float* __restrict__ dP, float* __restrict__ dQ,
         const float* __restrict__ colsum, float* __restrict__ loss, int U,
         int I, int d, float reg, AdamStep a) {
  __shared__ float part[WARPS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float n = (float)(U + I);
  const float g_cov = 2.f * reg / n;
  float warp_loss = 0.f;
  for (int r = blockIdx.x * WARPS + warp; r < U + I;
       r += gridDim.x * WARPS) {
    const bool on_q = r < I;
    const size_t off = (size_t)(on_q ? r : r - I) * d;
    float* x = (on_q ? Q : P) + off;
    float* m = (on_q ? mQ : mP) + off;
    float* v = (on_q ? vQ : vP) + off;
    float* g = (on_q ? dQ : dP) + off;
    float s = 0.f, sq = 0.f;
    for (int k = lane; k < d; k += 32) {
      const float xc = x[k] - colsum[k] / n;
      s += xc;
      sq = fmaf(xc, xc, sq);
    }
    s = warp_sum(s);
    sq = warp_sum(sq);
    warp_loss += reg * (s * s - sq) / n;
    // Every lane has read the whole row's sums before any lane writes it.
    for (int k = lane; k < d; k += 32) {
      const float xc = x[k] - colsum[k] / n;
      adam_elem(x + k, m + k, v + k, g[k] + g_cov * (s - xc), a);
      g[k] = 0.f;
    }
  }
  if (lane == 0) part[warp] = warp_loss;
  __syncthreads();
  if (threadIdx.x == 0) {
    float l = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) l += part[w];
    atomicAdd(loss, l);
  }
}

}  // namespace

// All pointers are device pointers.  P [U, d], Q [I, d] and their Adam
// moments are updated in place; dP [U, d] and dQ [I, d] are zeroed scratch
// and are zero again on return; colsum [steps, d] is zeroed scratch; u and
// i are [steps, B] and negs [steps, B, K] int32; loss [steps] is zeroed and
// receives each step's summed loss.  b1 and b2 come as doubles (epoch.cuh).
// Returns 0, or the cudaError_t of the first launch that failed.
extern "C" int cml_epoch(float* P, float* Q, float* mP, float* vP, float* mQ,
                         float* vQ, float* dP, float* dQ, const int32_t* u_idx,
                         const int32_t* i_idx, const int32_t* n_idx,
                         float* colsum, float* loss, int U, int I, int d,
                         int steps, int B, int K, int t0, float lr, float reg,
                         float margin, float item_nums, double b1, double b2,
                         float eps, cudaStream_t stream) {
  const int want = (B + WARPS - 1) / WARPS;
  const int slot_blocks = want < MAX_BLOCKS ? want : MAX_BLOCKS;
  const int rows = U + I;
  const int sum_blocks = (rows + SUM_ROWS - 1) / SUM_ROWS;
  const int sum_threads = d < 256 ? ((d + 31) / 32) * 32 : 256;
  const int row_blocks = (rows + WARPS - 1) / WARPS;
  for (int s = 0; s < steps; ++s) {
    if (B > 0) {
      const size_t off = (size_t)s * B;
      cml_slots<<<slot_blocks, 32 * WARPS, 0, stream>>>(
          P, Q, u_idx + off, i_idx + off, n_idx + off * K, dP, dQ, loss + s,
          U, I, d, B, K, margin, item_nums);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
    if (rows == 0) continue;
    float* cs = colsum + (size_t)s * d;
    col_sums<<<sum_blocks, sum_threads, 0, stream>>>(P, Q, cs, U, I, d);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    cov_adam<<<row_blocks < 65535 ? row_blocks : 65535, 32 * WARPS, 0,
               stream>>>(P, Q, mP, vP, mQ, vQ, dP, dQ, cs, loss + s, U, I, d,
                         reg, adam_step(t0 + s + 1, lr, b1, b2, eps));
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}
