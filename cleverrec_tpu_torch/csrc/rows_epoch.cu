// One multi-plane training epoch with dense Adam on Hopper (sm_90a): the
// social-triple family (SBPR, TBPR, CUNE_BPR) and LRML, behind a plain C
// interface that cleverrec_tpu_torch/ops/train.py loads with ctypes.
//
// Replaces fused_rows_epoch of cleverrec_tpu/ops/pallas_train.py
// (_rows_kernel, pallas_call :847) and its streamed twin
// fused_rows_epoch_stream (:1153).  The Pallas kernel differentiates any
// model row_loss inside the kernel; CUDA has no autodiff, so the backward
// is written here by hand for two forms, chosen by RowsArgs.form.
//
// Form 0, the social BPR chain the three social models share.  A row is
// (u, m_0 .. m_{L-1}), 2 <= L <= 4 (SBPR and CUNE_BPR: i, k, j; TBPR: i,
// s, t, j):
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
//
// Form 1, LRML (model/ranking/LRML.py:42-75).  A row is (u, i, j); for x
// in {Q[i], Q[j]}, with ue = P[u] and sign sigma = +1 for i, -1 for j:
//
//   a = ue * x,  l = a K (mem),  att = softmax(l),  r = att M
//   e = ue + r - x,  dist = |e|^2
//   loss += h (dist_i - dist_j + margin) + reg/2 (|ue|^2 + |Q[i]|^2 + |Q[j]|^2)
//
// with h = [dist_i - dist_j + margin > 0] (the hinge).  Backward, per x:
//
//   g_e = 2 sigma h e;  due += g_e,  dx -= g_e
//   dM += att^T g_e;  g_att = M g_e;  g_l = att * (g_att - <att, g_att>)
//   dK += a^T g_l;  g_a = K g_l;  due += g_a * x,  dx += g_a * ue
//
// plus reg on each gathered row.  K [d, mem] and M [mem, d] are dense:
//
//   lrml_slots  blocks of up to 16 warps (the plan's ``warps``), at most
//               one block per SM; each block stages K and M in shared
//               memory at odd row strides (no bank conflicts whether a
//               lane walks a row or a column) and sums its rows' dK and dM
//               there, by shared atomics, flushing them with one global
//               atomic per element per block; each warp takes a row at a
//               time over a grid stride, its rows, grads, a, e and att in
//               its own slice of shared memory.  Lanes own the d columns
//               for the elementwise parts and r, g_a; lanes own the mem
//               logits for l, softmax and g_att.  A row whose hinge is
//               inactive writes only its reg grads.  The row grads go to
//               dP/dQ by atomicAdd; each block adds its rows' loss with one
//               atomic.
//   adam_dense  one pass over P, Q, K and M and their moments (epoch.cuh).
//
// Per real row LRML does ~12 d mem FP32 operations (four products with K
// or M and two rank-1 updates for each of i and j), 77k at the conf's d
// 128 and mem 50, one warp a row from shared memory, plus 4 d mem shared
// atomics an active row for dK and dM; the flush adds 2 d mem global
// atomics per block.

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
  // Form 1 (LRML): p, m, v, g hold P, Q, K [d, mem], M [mem, d]; the
  // planes u, i, j; warps per block and the block's shared memory.
  int form, mem, warps, smem_bytes;
  float margin;
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

__global__ void __launch_bounds__(512)
lrml_slots(const float* __restrict__ P, const float* __restrict__ Q,
           const float* __restrict__ Kg, const float* __restrict__ Mg,
           float* __restrict__ dP, float* __restrict__ dQ,
           float* __restrict__ dK, float* __restrict__ dM,
           const int32_t* __restrict__ u_idx,
           const int32_t* __restrict__ i_idx,
           const int32_t* __restrict__ j_idx, float* __restrict__ loss, int U,
           int I, int d, int mem, int B, float margin, float reg) {
  // Shared memory, in floats: K [d][mem | 1], M [mem][d | 1], dK and dM
  // alike, then 10 d + 3 mem floats per warp (ops/train.py's _lrml_smem
  // counts the same).
  extern __shared__ float sm[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int ldk = mem | 1, ldm = d | 1;
  float* sK = sm;                        // [d][ldk]
  float* sM = sK + d * ldk;              // [mem][ldm]
  float* sdK = sM + mem * ldm;
  float* sdM = sdK + d * ldk;
  float* wb = sdM + mem * ldm + warp * (10 * d + 3 * mem);
  float* ue = wb;                        // P[u]
  float* xr[2] = {wb + d, wb + 2 * d};   // Q[i], Q[j]
  float* gu = wb + 3 * d;                // the row grads
  float* gx[2] = {wb + 4 * d, wb + 5 * d};
  float* av[2] = {wb + 6 * d, wb + 7 * d};       // a = ue * x
  float* ev[2] = {wb + 8 * d, wb + 9 * d};       // e, then g_e
  float* att[2] = {wb + 10 * d, wb + 10 * d + mem};
  float* gl = wb + 10 * d + 2 * mem;             // g_att, then g_l
  for (int t = threadIdx.x; t < d * mem; t += blockDim.x) {
    const int k = t / mem, m = t - k * mem;
    sK[k * ldk + m] = Kg[t];
    sdK[k * ldk + m] = 0.f;
    const int m2 = t / d, k2 = t - m2 * d;
    sM[m2 * ldm + k2] = Mg[t];
    sdM[m2 * ldm + k2] = 0.f;
  }
  __syncthreads();
  float warp_loss = 0.f;
  for (int b = blockIdx.x * warps + warp; b < B; b += gridDim.x * warps) {
    const int u = u_idx[b];
    if ((unsigned)u >= (unsigned)U) continue;           // masked row, w = 0
    const int id[2] = {i_idx[b], j_idx[b]};
    const bool ok[2] = {(unsigned)id[0] < (unsigned)I,
                        (unsigned)id[1] < (unsigned)I};
    __syncwarp();            // the previous row's readers are done
    float nrm = 0.f;
    for (int k = lane; k < d; k += 32) {
      const float pe = P[(size_t)u * d + k];
      ue[k] = pe;
      gu[k] = reg * pe;
      nrm = fmaf(pe, pe, nrm);
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const float q = ok[x] ? Q[(size_t)id[x] * d + k] : 0.f;
        xr[x][k] = q;
        gx[x][k] = reg * q;
        av[x][k] = pe * q;
        nrm = fmaf(q, q, nrm);
      }
    }
    __syncwarp();
    float dist[2];
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      // Logits and softmax: lanes own the memory slots.
      float lmax = -INFINITY;
      for (int m = lane; m < mem; m += 32) {
        float l = 0.f;
        for (int k = 0; k < d; ++k) l = fmaf(av[x][k], sK[k * ldk + m], l);
        att[x][m] = l;
        lmax = fmaxf(lmax, l);
      }
      lmax = warp_max(lmax);
      float ssum = 0.f;
      for (int m = lane; m < mem; m += 32) {
        const float ex = expf(att[x][m] - lmax);
        att[x][m] = ex;
        ssum += ex;
      }
      ssum = warp_sum(ssum);
      for (int m = lane; m < mem; m += 32) att[x][m] /= ssum;
      __syncwarp();
      // r = att M and e: lanes own the columns.
      float acc = 0.f;
      for (int k = lane; k < d; k += 32) {
        float r = 0.f;
        for (int m = 0; m < mem; ++m) r = fmaf(att[x][m], sM[m * ldm + k], r);
        const float e = ue[k] + r - xr[x][k];
        ev[x][k] = e;
        acc = fmaf(e, e, acc);
      }
      dist[x] = warp_sum(acc);
    }
    const float z = dist[0] - dist[1] + margin;
    warp_loss += fmaxf(z, 0.f) + 0.5f * reg * warp_sum(nrm);
    if (z > 0.f) {
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const float two_sigma = x == 0 ? 2.f : -2.f;
        for (int k = lane; k < d; k += 32) {
          const float ge = two_sigma * ev[x][k];
          ev[x][k] = ge;
          gu[k] += ge;
          gx[x][k] -= ge;
          for (int m = 0; m < mem; ++m)
            atomicAdd(sdM + m * ldm + k, att[x][m] * ge);
        }
        __syncwarp();
        float dot = 0.f;
        for (int m = lane; m < mem; m += 32) {
          float ga = 0.f;
          for (int k = 0; k < d; ++k) ga = fmaf(sM[m * ldm + k], ev[x][k], ga);
          gl[m] = ga;
          dot = fmaf(att[x][m], ga, dot);
        }
        dot = warp_sum(dot);
        for (int m = lane; m < mem; m += 32) {
          const float g = att[x][m] * (gl[m] - dot);
          gl[m] = g;
          for (int k = 0; k < d; ++k) atomicAdd(sdK + k * ldk + m, av[x][k] * g);
        }
        __syncwarp();
        for (int k = lane; k < d; k += 32) {
          float ga = 0.f;
          for (int m = 0; m < mem; ++m) ga = fmaf(sK[k * ldk + m], gl[m], ga);
          gu[k] = fmaf(ga, xr[x][k], gu[k]);
          gx[x][k] = fmaf(ga, ue[k], gx[x][k]);
        }
        __syncwarp();
      }
    }
    for (int k = lane; k < d; k += 32) {
      atomicAdd(dP + (size_t)u * d + k, gu[k]);
#pragma unroll
      for (int x = 0; x < 2; ++x)
        if (ok[x]) atomicAdd(dQ + (size_t)id[x] * d + k, gx[x][k]);
    }
  }
  __syncthreads();
  for (int t = threadIdx.x; t < d * mem; t += blockDim.x) {
    const int k = t / mem, m = t - k * mem;
    atomicAdd(dK + t, sdK[k * ldk + m]);
    const int m2 = t / d, k2 = t - m2 * d;
    atomicAdd(dM + t, sdM[m2 * ldm + k2]);
  }
  // The loss: per warp, then one atomic a block, through sdK once every
  // thread has flushed its part of it.
  __syncthreads();
  if (lane == 0) sdK[warp] = warp_loss;
  __syncthreads();
  if (threadIdx.x == 0) {
    float l = 0.f;
    for (int w = 0; w < warps; ++w) l += sdK[w];
    atomicAdd(loss, l);
  }
}

// LRML's epoch (form 1); see rows_epoch.
int lrml_epoch(const RowsArgs* a, cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaError_t err = cudaFuncSetAttribute(
      lrml_slots, cudaFuncAttributeMaxDynamicSharedMemorySize, a->smem_bytes);
  if (err != cudaSuccess) return (int)err;
  const int want = (a->B + a->warps - 1) / a->warps;
  const int blocks = want < sms ? want : sms;
  AdamSegs segs = {};
  adam_add(segs, a->p[0], a->m[0], a->v[0], a->g[0], (int64_t)a->U * a->d);
  adam_add(segs, a->p[1], a->m[1], a->v[1], a->g[1], (int64_t)a->I * a->d);
  adam_add(segs, a->p[2], a->m[2], a->v[2], a->g[2], (int64_t)a->d * a->mem);
  adam_add(segs, a->p[3], a->m[3], a->v[3], a->g[3], (int64_t)a->mem * a->d);
  for (int s = 0; s < a->steps; ++s) {
    if (a->B > 0) {
      const size_t off = (size_t)s * a->B;
      lrml_slots<<<blocks, 32 * a->warps, a->smem_bytes, stream>>>(
          a->p[0], a->p[1], a->p[2], a->p[3], a->g[0], a->g[1], a->g[2],
          a->g[3], a->plane[0] + off, a->plane[1] + off, a->plane[2] + off,
          a->loss + s, a->U, a->I, a->d, a->mem, a->B, a->margin, a->reg);
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
    const int aerr = adam_launch(segs, a->t0 + s + 1, a->lr, a->b1, a->b2,
                                 a->eps, stream);
    if (aerr != 0) return aerr;
  }
  return 0;
}

}  // namespace

// All pointers in ``a`` are device pointers; P, Q, bias, s and their Adam
// moments are updated in place, the gradient scratch is zero again on
// return, and loss[s] receives step s's summed loss.  b1 and b2 come as
// doubles (epoch.cuh).  Returns 0, or the cudaError_t of the first launch
// that failed.
extern "C" int rows_epoch(const RowsArgs* a, cudaStream_t stream) {
  if (a->form == 1) return lrml_epoch(a, stream);
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
