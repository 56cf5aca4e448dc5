// One GMF training epoch (pointwise sigmoid cross-entropy) with dense Adam
// on Hopper (sm_90a), behind a plain C interface that
// cleverrec_tpu_torch/ops/train.py loads with ctypes.
//
// Replaces fused_gmf_epoch of cleverrec_tpu/ops/pallas_train.py
// (_pw_kernel, pallas_call :440).  For each step s of the epoch, over the
// B pre-sampled slots (u, i, y) of row s:
//
//   pe = P[u], qi = Q[i], prod = pe * qi, x = prod . h
//   loss[s] += max(x, 0) - x y + log1p(exp(-|x|)) + 0.5 reg (|pe|^2 + |qi|^2)
//   g = sigmoid(x) - y
//   dP[u] += g (qi * h) + reg pe,  dQ[i] += g (pe * h) + reg qi,
//   dh += g prod                     (h is not regularised; ids sum)
//
// then dense Adam over ALL of P, Q and h at step t = t0 + s + 1
// (epoch.cuh).  An id outside its table (the sampler's sentinels
// U_pad - 1, I_pad - 1) reads a zero row and writes nothing, so a
// sentinel slot adds log 2 to the loss and changes nothing else; the
// caller subtracts it.
//
// The TPU kernel streams the label in the SIGN of the user id
// (uz = (u + 1)(2y - 1)) and gathers and scatters rows as one-hot matrix
// products with P, Q and the moments resident in VMEM: Mosaic workarounds
// that do not carry over.  Here u, i and y arrive as three planes, and the
// sequential grid becomes a host loop, two launches a step:
//
//   gmf_slots  a block of 8 warps; each warp walks slots with a grid
//              stride, its lanes over d; two shuffle sums give x and the
//              squared norms; row grads go into the dP/dQ scratch by
//              atomicAdd; dh sums in shared memory and leaves the block
//              with one atomic per element; the block's loss, one atomic.
//   adam_dense one pass over P, Q, h and their moments (epoch.cuh).
//
// What bounds it on an H100: per step the slots read and scatter 2 B rows
// and Adam makes ~9 passes over (U + I + 1) d floats; at ml-100k's shape
// (943 + 1682 rows, d 64, B 6144) the 4 MB state stays in L2, so a step is
// bound by L2 traffic, atomics and the two launches, far above the least
// time of the function (its FP32 operations).  The grid is capped so that
// the dh atomics of all blocks, all on d addresses, stay few.  f32 atomics
// sum in a run-dependent order: results match the plain version to a
// tolerance, not bit for bit.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "epoch.cuh"

namespace {

constexpr int WARPS = 8;              // warps per block of gmf_slots
constexpr int MAX_BLOCKS = 264;       // two blocks per SM of an H100

__global__ void __launch_bounds__(32 * WARPS)
gmf_slots(const float* __restrict__ P, const float* __restrict__ Q,
          const float* __restrict__ h, const int32_t* __restrict__ u_idx,
          const int32_t* __restrict__ i_idx, const float* __restrict__ y,
          float* __restrict__ dP, float* __restrict__ dQ,
          float* __restrict__ dh, float* __restrict__ loss, int U, int I,
          int d, int B, float reg) {
  extern __shared__ float smem[];     // h [d], then its gradient [d]
  float* h_s = smem;
  float* dh_s = smem + d;
  __shared__ float partial[WARPS];
  for (int k = threadIdx.x; k < d; k += blockDim.x) {
    h_s[k] = h[k];
    dh_s[k] = 0.f;
  }
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float warp_loss = 0.f;
  for (int b = blockIdx.x * WARPS + warp; b < B; b += gridDim.x * WARPS) {
    const int u = u_idx[b], i = i_idx[b];
    const bool ru = (unsigned)u < (unsigned)U;
    const bool ri = (unsigned)i < (unsigned)I;
    const float* pu = P + (size_t)(ru ? u : 0) * d;
    const float* qi_row = Q + (size_t)(ri ? i : 0) * d;
    float x = 0.f, nrm = 0.f;
    for (int k = lane; k < d; k += 32) {
      const float pe = ru ? pu[k] : 0.f;
      const float qi = ri ? qi_row[k] : 0.f;
      x = fmaf(pe * qi, h_s[k], x);
      nrm = fmaf(pe, pe, fmaf(qi, qi, nrm));
    }
    x = warp_sum(x);
    nrm = warp_sum(nrm);
    const float yb = y[b];
    warp_loss += fmaxf(x, 0.f) - x * yb + log1pf(expf(-fabsf(x)))
                 + 0.5f * reg * nrm;
    const float g = 1.f / (1.f + expf(-x)) - yb;      // sigmoid(x) - y
    float* dpu = dP + (size_t)(ru ? u : 0) * d;
    float* dqi = dQ + (size_t)(ri ? i : 0) * d;
    for (int k = lane; k < d; k += 32) {
      const float pe = ru ? pu[k] : 0.f;
      const float qi = ri ? qi_row[k] : 0.f;
      const float hk = h_s[k];
      if (ru) atomicAdd(dpu + k, g * (qi * hk) + reg * pe);
      if (ri) atomicAdd(dqi + k, g * (pe * hk) + reg * qi);
      atomicAdd(dh_s + k, g * (pe * qi));
    }
  }
  if (lane == 0) partial[warp] = warp_loss;
  __syncthreads();
  for (int k = threadIdx.x; k < d; k += blockDim.x) atomicAdd(dh + k, dh_s[k]);
  if (threadIdx.x == 0) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) s += partial[w];
    atomicAdd(loss, s);
  }
}

}  // namespace

// All pointers are device pointers.  P [U, d], Q [I, d], h [d] and their
// Adam moments are updated in place; dP, dQ, dh are zeroed scratch of the
// same shapes and are zero again on return; u, i are [steps, B] int32 and
// y [steps, B] f32 labels; loss [steps] is zeroed and receives each
// step's summed loss.  b1 and b2 come as doubles (epoch.cuh).
// Returns 0, or the cudaError_t of the first launch that failed.
extern "C" int gmf_epoch(float* P, float* Q, float* h, float* mP, float* vP,
                         float* mQ, float* vQ, float* mh, float* vh, float* dP,
                         float* dQ, float* dh, const int32_t* u_idx,
                         const int32_t* i_idx, const float* y, float* loss,
                         int U, int I, int d, int steps, int B, int t0,
                         float lr, float reg, double b1, double b2, float eps,
                         cudaStream_t stream) {
  const int want = (B + WARPS - 1) / WARPS;
  const int blocks = want < MAX_BLOCKS ? want : MAX_BLOCKS;
  const size_t smem = 2 * (size_t)d * sizeof(float);
  AdamSegs segs = {};
  adam_add(segs, P, mP, vP, dP, (int64_t)U * d);
  adam_add(segs, Q, mQ, vQ, dQ, (int64_t)I * d);
  adam_add(segs, h, mh, vh, dh, (int64_t)d);
  for (int s = 0; s < steps; ++s) {
    if (B > 0) {
      const size_t off = (size_t)s * B;
      gmf_slots<<<blocks, 32 * WARPS, smem, stream>>>(
          P, Q, h, u_idx + off, i_idx + off, y + off, dP, dQ, dh, loss + s,
          U, I, d, B, reg);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
    const int err = adam_launch(segs, t0 + s + 1, lr, b1, b2, eps, stream);
    if (err != 0) return err;
  }
  return 0;
}
