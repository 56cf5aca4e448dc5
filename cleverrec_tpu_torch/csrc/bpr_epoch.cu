// One BPR training epoch with dense Adam on Hopper (sm_90a), behind a
// plain C interface that cleverrec_tpu_torch/ops/train.py loads with
// ctypes.
//
// Replaces fused_bpr_epoch of cleverrec_tpu/ops/pallas_train.py
// (_epoch_kernel, pallas_call :276).  For each step s of the epoch, over
// the B pre-sampled slots (u, i, j) of row s:
//
//   pe = P[u], qi = Q[i], qj = Q[j], diff = pe . (qi - qj)
//   loss[s] += -log sigmoid(diff) + 0.5 reg (|pe|^2 + |qi|^2 + |qj|^2)
//   g = -sigmoid(-diff)
//   dP[u] += g (qi - qj) + reg pe,  dQ[i] += g pe + reg qi,
//   dQ[j] += -g pe + reg qj          (duplicate ids sum)
//
// then dense Adam over ALL of P and Q (untouched rows decay too) at step
// t = t0 + s + 1, with bias corrections 1 - exp(t log b) as on the TPU.
// An id outside its table (the sampler's sentinels U_pad - 1, I_pad - 1)
// reads a zero row and writes nothing: a slot whose three ids are
// sentinels changes nothing but adds log 2 to the loss, which the caller
// subtracts.
//
// The TPU kernel keeps the tables and moments resident in VMEM and does
// its gathers and scatters as one-hot matrix products, because Mosaic has
// no lane gather.  Neither carries over.  Here the TPU's sequential grid
// becomes a host loop over the steps on one stream, two launches a step:
//
//   bpr_slots  one warp per slot; each lane walks d with stride 32, so a
//              warp reads each row as 128-byte lines; two shuffle
//              reductions give diff and the squared norms; the row grads
//              go into the dP/dQ scratch by atomicAdd (RED); a block adds
//              its slots' loss to loss[s] with one atomic.
//   adam_dense one grid-stride pass over P then Q and their moments,
//              reading dP/dQ and zeroing them for the next step.
//
// What bounds it on an H100: per step, the slots read and scatter 3 B
// rows and Adam makes ~9 passes over (U + I) d floats; at ml-100k's
// shape (943 + 1682 rows, d 128, B 6144) the whole state is 8 MB and
// stays in the 50 MB L2, so a step is bound by L2 traffic, atomics and
// the two launches rather than by HBM.  The least time for the function
// (its inputs read once, outputs written once; its FP32 operations) is
// far below that: keeping the state on chip across steps is a later
// kernel's work.  The f32 atomics sum duplicate ids in an order that
// changes from run to run, so results match the plain version to a
// tolerance, not bit for bit.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;            // slots per block of bpr_slots
constexpr int ADAM_THREADS = 256;

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__global__ void __launch_bounds__(32 * WARPS)
bpr_slots(const float* __restrict__ P, const float* __restrict__ Q,
          const int32_t* __restrict__ u_idx, const int32_t* __restrict__ i_idx,
          const int32_t* __restrict__ j_idx, float* __restrict__ dP,
          float* __restrict__ dQ, float* __restrict__ loss, int U, int I,
          int d, int B, float reg) {
  __shared__ float partial[WARPS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.x * WARPS + warp;
  float slot_loss = 0.f;
  if (b < B) {
    const int u = u_idx[b], i = i_idx[b], j = j_idx[b];
    const bool ru = (unsigned)u < (unsigned)U;
    const bool ri = (unsigned)i < (unsigned)I;
    const bool rj = (unsigned)j < (unsigned)I;
    const float* pu = P + (size_t)(ru ? u : 0) * d;
    const float* qi_row = Q + (size_t)(ri ? i : 0) * d;
    const float* qj_row = Q + (size_t)(rj ? j : 0) * d;
    float dot = 0.f, nrm = 0.f;
    for (int k = lane; k < d; k += 32) {
      const float pe = ru ? pu[k] : 0.f;
      const float qi = ri ? qi_row[k] : 0.f;
      const float qj = rj ? qj_row[k] : 0.f;
      dot = fmaf(pe, qi - qj, dot);
      nrm = fmaf(pe, pe, fmaf(qi, qi, fmaf(qj, qj, nrm)));
    }
    const float diff = warp_sum(dot);
    nrm = warp_sum(nrm);
    // -log sigmoid(diff) = softplus(-diff), in its stable form.
    slot_loss = fmaxf(-diff, 0.f) + log1pf(expf(-fabsf(diff))) + 0.5f * reg * nrm;
    const float g = -1.f / (1.f + expf(diff));      // -sigmoid(-diff)
    float* dpu = dP + (size_t)(ru ? u : 0) * d;
    float* dqi = dQ + (size_t)(ri ? i : 0) * d;
    float* dqj = dQ + (size_t)(rj ? j : 0) * d;
    for (int k = lane; k < d; k += 32) {
      const float pe = ru ? pu[k] : 0.f;
      const float qi = ri ? qi_row[k] : 0.f;
      const float qj = rj ? qj_row[k] : 0.f;
      if (ru) atomicAdd(dpu + k, g * (qi - qj) + reg * pe);
      if (ri) atomicAdd(dqi + k, g * pe + reg * qi);
      if (rj) atomicAdd(dqj + k, -g * pe + reg * qj);
    }
  }
  if (lane == 0) partial[warp] = slot_loss;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) s += partial[w];
    atomicAdd(loss, s);
  }
}

__global__ void __launch_bounds__(ADAM_THREADS)
adam_dense(float* __restrict__ P, float* __restrict__ mP, float* __restrict__ vP,
           float* __restrict__ dP, int64_t nP, float* __restrict__ Q,
           float* __restrict__ mQ, float* __restrict__ vQ, float* __restrict__ dQ,
           int64_t nQ, float lr, float b1, float c1, float b2, float c2,
           float eps, float bc1, float bc2) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t k = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; k < nP + nQ;
       k += stride) {
    const bool in_p = k < nP;
    const int64_t e = in_p ? k : k - nP;
    float* p = in_p ? P : Q;
    float* m = in_p ? mP : mQ;
    float* v = in_p ? vP : vQ;
    float* g = in_p ? dP : dQ;
    const float gk = g[e];
    const float mk = b1 * m[e] + c1 * gk;
    const float vk = b2 * v[e] + c2 * (gk * gk);
    m[e] = mk;
    v[e] = vk;
    p[e] = p[e] - lr * (mk / bc1) / (sqrtf(vk / bc2) + eps);
    g[e] = 0.f;
  }
}

}  // namespace

// All pointers are device pointers.  P [U, d], Q [I, d] and their Adam
// moments are updated in place; dP [U, d] and dQ [I, d] are zeroed
// scratch and are zero again on return; u, i, j are [steps, B] int32;
// loss [steps] is zeroed and receives each step's summed loss.  b1 and
// b2 come as doubles so that log b and 1 - b round to f32 once, as in
// the JAX kernel.
// Returns 0, or the cudaError_t of the first launch that failed.
extern "C" int bpr_epoch(float* P, float* Q, float* mP, float* vP, float* mQ,
                         float* vQ, float* dP, float* dQ, const int32_t* u_idx,
                         const int32_t* i_idx, const int32_t* j_idx,
                         float* loss, int U, int I, int d, int steps, int B,
                         int t0, float lr, float reg, double b1, double b2,
                         float eps, cudaStream_t stream) {
  const int64_t nP = (int64_t)U * d, nQ = (int64_t)I * d;
  const int slot_blocks = (B + WARPS - 1) / WARPS;
  const int64_t adam_want = (nP + nQ + ADAM_THREADS - 1) / ADAM_THREADS;
  const int adam_blocks = (int)(adam_want < 65535 ? adam_want : 65535);
  const float log_b1 = (float)log(b1), log_b2 = (float)log(b2);
  for (int s = 0; s < steps; ++s) {
    if (B > 0) {
      const size_t off = (size_t)s * B;
      bpr_slots<<<slot_blocks, 32 * WARPS, 0, stream>>>(
          P, Q, u_idx + off, i_idx + off, j_idx + off, dP, dQ, loss + s, U, I,
          d, B, reg);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
    if (adam_blocks > 0) {
      const float t = (float)(t0 + s + 1);
      const float bc1 = 1.f - expf(t * log_b1), bc2 = 1.f - expf(t * log_b2);
      adam_dense<<<adam_blocks, ADAM_THREADS, 0, stream>>>(
          P, mP, vP, dP, nP, Q, mQ, vQ, dQ, nQ, lr, (float)b1,
          (float)(1.0 - b1), (float)b2, (float)(1.0 - b2), eps, bc1, bc2);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
  }
  return 0;
}
