// One social-triple training epoch (SBPR, TBPR, CUNE_BPR) with dense Adam
// on Hopper (sm_90a), behind a plain C interface that
// cleverrec_tpu_torch/ops/train.py loads with ctypes.
//
// Replaces fused_rows_epoch of cleverrec_tpu/ops/pallas_train.py
// (_rows_kernel, pallas_call :847) and its streamed twin
// fused_rows_epoch_stream (:1153).  The Pallas kernel differentiates any
// model row_loss inside the kernel; CUDA has no autodiff, so the backward
// is written here by hand for the one form the three models share, the
// social BPR chain.  A row is (u, m_0 .. m_{L-1}), 2 <= L <= 4 (SBPR and
// CUNE_BPR: i, k, j; TBPR: i, s, t, j):
//
//   x_m = P[u] . Q[m_m] + bias[m_m]
//   z_t = (x_t - x_{t+1}) / c_t            t = 0 .. L-2
//   loss += sum_t -log sigmoid(z_t)
//           + reg/2 (|P[u]|^2 + sum_m |Q[m_m]|^2 + bias[m_m]^2)
//
// with c_t = max(f, 1) on the float column's link (SBPR's suk, link 0),
// s + 1 on the dense scalar's link (CUNE_BPR's s, link 1) and 1 elsewhere.
// With g_t = -sigmoid(-z_t), dx_t += g_t / c_t and dx_{t+1} -= g_t / c_t;
//
//   dP[u]      += sum_m dx_m Q[m_m] + reg P[u]
//   dQ[m_m]    += dx_m P[u] + reg Q[m_m]       (duplicate ids sum)
//   dbias[m_m] += dx_m + reg bias[m_m]
//   ds         += g_t (x_t - x_{t+1}) (-1 / (s + 1)^2)  on the dense link
//
// then dense Adam over ALL of P, Q, bias[:I] and s at step t0 + s + 1
// (epoch.cuh): untouched rows decay too.  A row whose user id is outside
// P (the trainer's sentinel U_pad - 1) is masked: it adds nothing to the
// loss and writes nothing, so the loss needs no correction; an item id
// outside Q reads a zero row and bias and writes nothing.
//
// The TPU kernel packs [Q | bias] into one odd-width table for its
// one-hot gather and scatter matmuls (Mosaic has no lane gather) and its
// streamed variant walks slabs of the tables through VMEM.  Neither
// carries over: here Q and bias stay separate tensors (bias is the
// model's own vector, whose last slot, the eval PAD item, the kernel
// never sees), the state stays in device memory, and the sequential grid
// becomes a host loop, two launches a step:
//
//   rows_slots  blocks of 8 warps, each warp a row at a time over a grid
//               stride (capped at 264 blocks); lanes walk d with stride
//               32, so a warp reads each row as 128-byte lines; shuffle
//               sums give the L dots and the squared norms; the row grads
//               go into the dP/dQ/dbias scratch by atomicAdd; each block
//               adds its rows' loss and ds with one atomic each.
//   adam_dense  one pass over P, Q, bias[:I], s and their moments,
//               zeroing the grads for the next step (epoch.cuh).
//
// What bounds it on an H100: per step the rows read and scatter (L + 1) B
// rows and Adam makes ~9 passes over (U + I) d floats; at ml-100k's shape
// (943 + 1682 rows, d 128, B 6144) the state stays in the 50 MB L2, so a
// step is bound by L2 traffic, atomics and the two launches, far above
// the least time of the function.  f32 atomics sum in a run-dependent
// order: results match the plain version to a tolerance, not bit for bit.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "epoch.cuh"

constexpr int ROWS_MAX_ITEMS = 4;

// Outside the unnamed namespace: a type of the C interface must not have
// internal linkage, or the library exports no rows_epoch.
struct RowsArgs {
  float* p[4];                    // P [U, d], Q [I, d], bias [I], s [] or null
  float* m[4];                    // their first moments
  float* v[4];                    // their second moments
  float* g[4];                    // zeroed gradient scratch of each
  const int32_t* plane[1 + ROWS_MAX_ITEMS];  // u, then the L item planes
  const float* fcol;              // [steps, B] float column, or null
  float* loss;                    // [steps], zeroed
  int U, I, d, B, items, steps, t0, float_link, dense_link;  // -1: none
  float reg, lr, eps;
  double b1, b2;
};

namespace {

constexpr int WARPS = 8;              // warps per block of rows_slots
constexpr int MAX_BLOCKS = 264;       // two blocks per SM of an H100

struct StepPlanes {
  const int32_t* plane[1 + ROWS_MAX_ITEMS];
  const float* fcol;
};

__global__ void __launch_bounds__(32 * WARPS)
rows_slots(const float* __restrict__ P, const float* __restrict__ Q,
           const float* __restrict__ bias, const float* __restrict__ s_par,
           float* __restrict__ dP, float* __restrict__ dQ,
           float* __restrict__ dbias, float* __restrict__ ds,
           StepPlanes st, float* __restrict__ loss, int U, int I, int d,
           int B, int items, int float_link, int dense_link, float reg) {
  __shared__ float part_loss[WARPS];
  __shared__ float part_ds[WARPS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float s_den = dense_link >= 0 ? s_par[0] + 1.f : 1.f;
  float warp_loss = 0.f, warp_ds = 0.f;
  for (int b = blockIdx.x * WARPS + warp; b < B; b += gridDim.x * WARPS) {
    const int u = st.plane[0][b];
    if ((unsigned)u >= (unsigned)U) continue;         // masked row, w = 0
    int id[ROWS_MAX_ITEMS];
    bool ok[ROWS_MAX_ITEMS];
    float dot[ROWS_MAX_ITEMS], bm[ROWS_MAX_ITEMS];
#pragma unroll
    for (int m = 0; m < ROWS_MAX_ITEMS; ++m) {
      id[m] = m < items ? st.plane[1 + m][b] : -1;
      ok[m] = (unsigned)id[m] < (unsigned)I;
      dot[m] = 0.f;
      bm[m] = ok[m] ? bias[id[m]] : 0.f;
    }
    const float* pu = P + (size_t)u * d;
    float nrm = 0.f;
    for (int k = lane; k < d; k += 32) {
      const float pe = pu[k];
      nrm = fmaf(pe, pe, nrm);
#pragma unroll
      for (int m = 0; m < ROWS_MAX_ITEMS; ++m) {
        if (ok[m]) {
          const float q = Q[(size_t)id[m] * d + k];
          dot[m] = fmaf(pe, q, dot[m]);
          nrm = fmaf(q, q, nrm);
        }
      }
    }
    nrm = warp_sum(nrm);
    float x[ROWS_MAX_ITEMS], dx[ROWS_MAX_ITEMS];
#pragma unroll
    for (int m = 0; m < ROWS_MAX_ITEMS; ++m) {
      x[m] = warp_sum(dot[m]) + bm[m];
      nrm = fmaf(bm[m], bm[m], nrm);
      dx[m] = 0.f;
    }
    float row_loss = 0.5f * reg * nrm;
#pragma unroll
    for (int t = 0; t + 1 < ROWS_MAX_ITEMS; ++t) {
      if (t + 1 >= items) break;
      const float c = t == float_link ? fmaxf(st.fcol[b], 1.f)
                      : t == dense_link ? s_den : 1.f;
      const float z = (x[t] - x[t + 1]) / c;
      // -log sigmoid(z) = softplus(-z), in its stable form.
      row_loss += fmaxf(-z, 0.f) + log1pf(expf(-fabsf(z)));
      const float g = -1.f / (1.f + expf(z));         // -sigmoid(-z)
      dx[t] += g / c;
      dx[t + 1] -= g / c;
      if (t == dense_link) warp_ds += g * (-z / c);   // dz/ds = -z / (s + 1)
    }
    warp_loss += row_loss;
    float* dpu = dP + (size_t)u * d;
    for (int k = lane; k < d; k += 32) {
      const float pe = pu[k];
      float acc = reg * pe;
#pragma unroll
      for (int m = 0; m < ROWS_MAX_ITEMS; ++m) {
        if (ok[m]) {
          const size_t o = (size_t)id[m] * d + k;
          const float q = Q[o];
          acc = fmaf(dx[m], q, acc);
          atomicAdd(dQ + o, fmaf(dx[m], pe, reg * q));
        }
      }
      atomicAdd(dpu + k, acc);
    }
    if (lane == 0) {
#pragma unroll
      for (int m = 0; m < ROWS_MAX_ITEMS; ++m)
        if (ok[m]) atomicAdd(dbias + id[m], fmaf(reg, bm[m], dx[m]));
    }
  }
  if (lane == 0) {
    part_loss[warp] = warp_loss;
    part_ds[warp] = warp_ds;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float l = 0.f, g = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      l += part_loss[w];
      g += part_ds[w];
    }
    atomicAdd(loss, l);
    if (dense_link >= 0) atomicAdd(ds, g);
  }
}

}  // namespace

// All pointers in ``a`` are device pointers; P, Q, bias, s and their Adam
// moments are updated in place, the gradient scratch is zero again on
// return, and loss[s] receives step s's summed loss.  b1 and b2 come as
// doubles (epoch.cuh).  Returns 0, or the cudaError_t of the first launch
// that failed.
extern "C" int rows_epoch(const RowsArgs* a, cudaStream_t stream) {
  const int want = (a->B + WARPS - 1) / WARPS;
  const int blocks = want < MAX_BLOCKS ? want : MAX_BLOCKS;
  AdamSegs segs = {};
  adam_add(segs, a->p[0], a->m[0], a->v[0], a->g[0], (int64_t)a->U * a->d);
  adam_add(segs, a->p[1], a->m[1], a->v[1], a->g[1], (int64_t)a->I * a->d);
  adam_add(segs, a->p[2], a->m[2], a->v[2], a->g[2], (int64_t)a->I);
  if (a->dense_link >= 0) adam_add(segs, a->p[3], a->m[3], a->v[3], a->g[3], 1);
  for (int s = 0; s < a->steps; ++s) {
    if (a->B > 0) {
      const size_t off = (size_t)s * a->B;
      StepPlanes st = {};
      for (int p = 0; p <= a->items; ++p) st.plane[p] = a->plane[p] + off;
      st.fcol = a->fcol ? a->fcol + off : nullptr;
      rows_slots<<<blocks, 32 * WARPS, 0, stream>>>(
          a->p[0], a->p[1], a->p[2], a->p[3], a->g[0], a->g[1], a->g[2],
          a->g[3], st, a->loss + s, a->U, a->I, a->d, a->B, a->items,
          a->float_link, a->dense_link, a->reg);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
    const int err = adam_launch(segs, a->t0 + s + 1, a->lr, a->b1, a->b2,
                                a->eps, stream);
    if (err != 0) return err;
  }
  return 0;
}
