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
// sequential grid is one persistent kernel (persist.cuh): one cooperative
// launch an epoch, one wave of blocks, two grid barriers a step.  At
// d <= 64 it is gmf_persist, in blocks of 1024 threads (float4 rows) or
// 512 (scalar), the slot's rows and dh in registers; past 64, up to 4096,
// gmf_wide, whose dh is in shared memory (below).
//
//   prologue  the grid zeroes the dP, dQ scratch; a barrier.
//   phase A   16 lanes (a half-warp) take a slot, the slots spread over
//             the blocks, a half-warp's first slot's ids loaded during the
//             previous phase B; lane j owns columns W j + 16 W k
//             (W = 4: float4 rows, where d % 4 == 0 and the state is
//             16-byte aligned; W = 1 the scalar variant), reads its pieces
//             of the slot's two rows and of h before the first FMA,
//             and sends each row gradient as one float4 reduction
//             (red.global.add.v4.f32, sm_90; persist.cuh's atomic_add).
//             dh sums in registers (a lane always owns the same columns),
//             then over the warp's two halves and the block's warps in
//             shared memory, in a fixed order, into the block's slice of
//             part [blocks, d]; the block's loss into part_loss[s, block].
//             gmf_wide walks a slot's rows twice (x, then the gradients)
//             and adds dh into its half-warp's row of shared memory, each
//             column by the one lane that owns it, then the block sums the
//             rows in order into its slice.
//             A barrier.
//   phase B   a warp an element of h (the grid's last warps) sums its
//             slices in block order and runs Adam on h; the grid runs
//             Adam over P and Q (float4 where aligned, epoch.cuh's
//             adam_tables), zeroing dP and dQ, and loads the next step's
//             first slots' ids, and prefetches the rest into L2.  A
//             barrier.
//
// Then the steps' losses are summed (persist.cuh's finish_losses).  h, its
// moments and the loss are the same from run to run after one step; the
// tables' row sums use f32 atomics, whose order varies, and through the
// next step so does the rest: results match the plain version to a
// tolerance, not bit for bit.
//
// What bounds it on an H100: per step the slots read and scatter 2 B rows
// and Adam makes ~9 passes over (U + I + 1) d floats; at ml-100k's shape
// (943 + 1682 rows, d 64, B 6144) the 4 MB state stays in L2, so a step is
// bound by L2 latency and traffic and its two barriers, far above the
// least time of the function (its FP32 operations).  gmf_wide's dh rows
// take 32 d bytes of shared memory a block, so d is at most 4096.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "epoch.cuh"
#include "persist.cuh"

// Outside the unnamed namespace: a type of the C interface must not have
// internal linkage.  ops/train.py's _GmfArgs must agree with it field for
// field.
struct GmfArgs {
  // P [U, d], Q [I, d], h [d] and their moments; dP, dQ scratch.
  float *P, *Q, *h, *mP, *vP, *mQ, *vQ, *mh, *vh, *dP, *dQ;
  const int32_t *u, *i;          // [steps, B]
  const float* y;                // [steps, B]
  const float* bc;               // [steps, 2]: Adam's bias corrections
  float* part;                   // [blocks, d]: each block's dh
  float* part_loss;              // [steps, blocks]
  float* loss;                   // [steps + 1]: each step's, then the sum
  unsigned* bar;                 // [2]: the barrier's and finish_losses' counters
  int U, I, d, steps, B, blocks, vec;
  float lr, reg, eps;
  double b1, b2;
};

namespace {

// The narrow kernel's widest d (a lane holds 4 columns of each row and
// of dh in registers); past it the wide kernel, whose blocks of
// WIDE_THREADS keep 8 rows of d floats of dh in shared memory, 128 KB at
// GMF_MAX_D.
constexpr int GMF_NARROW_D = 64, GMF_MAX_D = 4096, WIDE_THREADS = 128;

// A slot's ids and label.
struct Ids {
  int u, i;
  float y;
};

// Slot b of step s's ids and label (b past B: none, never read).
__device__ __forceinline__ Ids load_ids(const GmfArgs& a, int s, int b) {
  if (b >= a.B) return {-1, -1, 0.f};
  const size_t off = (size_t)s * a.B + b;
  return {__ldg(a.u + off), __ldg(a.i + off), __ldg(a.y + off)};
}

// The block's dh: rows [n][ld] of shared memory, each a warp's or a
// half-warp's sums, added in row order into out[0 .. d) (the block's
// slice of part); each row zeroed behind the read.
__device__ __forceinline__ void fold_dh(float* rows, int n, int ld, int d,
                                        float* out) {
  for (int c = threadIdx.x; c < d; c += blockDim.x) {
    float acc = 0.f;
    for (int r = 0; r < n; ++r) {
      acc += rows[r * ld + c];
      rows[r * ld + c] = 0.f;
    }
    out[c] = acc;
  }
}

// A slot's loss: the cross-entropy of x against y and the squared norms'
// regulariser.
__device__ __forceinline__ float slot_loss(float x, float y, float nrm,
                                           float reg) {
  return fmaxf(x, 0.f) - x * y + log1pf(expf(-fabsf(x))) + 0.5f * reg * nrm;
}

// The prologue of both kernels: the tables' Adam segments, dP and dQ
// zeroed, step 0's ids asked of L2.
__device__ __forceinline__ void gmf_prologue(const GmfArgs& a, AdamSegs& tab,
                                             bool (&vec)[ADAM_MAX_SEGS]) {
  adam_add(tab, a.P, a.mP, a.vP, a.dP, (int64_t)a.U * a.d);
  adam_add(tab, a.Q, a.mQ, a.vQ, a.dQ, (int64_t)a.I * a.d);
  vec[0] = vec[1] = a.vec;
  grid_zero(a.dP, (int64_t)a.U * a.d);
  grid_zero(a.dQ, (int64_t)a.I * a.d);
  if (a.steps > 0) {
    const int64_t plane = (int64_t)a.B * sizeof(int32_t);
    prefetch_l2(a.u, plane);
    prefetch_l2(a.i, plane);
    prefetch_l2(a.y, plane);
  }
}

// Phase B of step s, the same in both kernels: the next step's ids (this
// thread's first slot's into ``ahead``, the rest asked of L2); h's
// gradient from the blocks' slices and Adam on h; Adam over P and Q.
__device__ __forceinline__ void gmf_phase_b(const GmfArgs& a,
                                            const AdamBase& ab,
                                            const AdamSegs& tab,
                                            const bool (&vec)[ADAM_MAX_SEGS],
                                            int s, int first, Ids& ahead) {
  const int lane = threadIdx.x & 31, G = gridDim.x, d = a.d;
  if (s + 1 < a.steps) {
    const size_t next = (size_t)(s + 1) * a.B;
    const int64_t plane = (int64_t)a.B * sizeof(int32_t);
    prefetch_l2(a.u + next, plane);
    prefetch_l2(a.i + next, plane);
    prefetch_l2(a.y + next, plane);
    ahead = load_ids(a, s + 1, first);
  }
  const AdamStep st = step_at(ab, a.bc, s);
  // h's elements go to the last warps of the grid, which adam_tables
  // gives no units at the conf's shape.
  const int warps = (blockDim.x >> 5) * G;
  for (int e = warps - 1 - grid_warp(); e < d; e += warps) {
    const float g = slice_sum(a.part + e, d, G);
    if (lane == 0) adam_elem(a.h + e, a.mh + e, a.vh + e, g, st);
  }
  adam_tables(tab, vec, st, grid_thread(), (int64_t)G * blockDim.x);
}

// The block's loss of step s, from its warps' shares, into part_loss.
template <int WARPS>
__device__ __forceinline__ void block_loss(const GmfArgs& a, int s,
                                           const float (&loss_w)[WARPS]) {
  if (threadIdx.x == 0) {
    float l = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) l += loss_w[w];
    a.part_loss[(size_t)s * gridDim.x + blockIdx.x] = l;
  }
}

// The narrow kernel (d <= GMF_NARROW_D): NP pieces of W columns a lane,
// NP = ceil(d / (16 W)), the slot's rows and dh in registers; blocks of
// T threads.
template <int W, int NP, int T>
__global__ void __launch_bounds__(T)
gmf_persist(GmfArgs a, AdamBase ab) {
  constexpr int COLS = 16 * W * NP, WARPS = T / 32;
  __shared__ float dh_w[WARPS][COLS];
  __shared__ float loss_w[WARPS];
  PERSIST_CLOCK_INIT
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int hl = lane & 15, half = lane >> 4;
  const int G = gridDim.x, d = a.d, B = a.B;
  unsigned round = 0;
  AdamSegs tab = {};
  bool vec[ADAM_MAX_SEGS] = {};
  gmf_prologue(a, tab, vec);
  grid_sync(a.bar, round);
  // A half-warp takes a slot at a time, half-warps block-minor.  The loop
  // is the same for the whole warp (its sums shuffle over all 32 lanes),
  // each half checking its own slot.
  const int first = (warp * G + blockIdx.x) * 2 + half;
  const int stride = WARPS * G * 2;
  // The first slot's ids of each step are loaded a phase ahead, before
  // the barrier that precedes the step.
  Ids ahead = a.steps > 0 ? load_ids(a, 0, first) : Ids{-1, -1, 0.f};
  for (int s = 0; s < a.steps; ++s) {
    // -- phase A: slots, row grads, the block's dh and loss ---------------
    float hv[NP][W], dh[NP][W];
#pragma unroll
    for (int k = 0; k < NP; ++k) {
      const int c = W * hl + 16 * W * k;
#pragma unroll
      for (int e = 0; e < W; ++e) hv[k][e] = dh[k][e] = 0.f;
      if (c < d) ld<W>(hv[k], a.h + c);
    }
    float my_loss = 0.f;
    for (int b = first; b - half < B; b += stride) {
      const Ids id = b == first ? ahead : load_ids(a, s, b);
      const bool live = b < B;
      const bool ru = (unsigned)id.u < (unsigned)a.U;
      const bool ri = (unsigned)id.i < (unsigned)a.I;
      // Every row piece of the slot, loaded before the first FMA.
      float pe[NP][W], qv[NP][W];
#pragma unroll
      for (int k = 0; k < NP; ++k) {
        const int c = W * hl + 16 * W * k;
#pragma unroll
        for (int e = 0; e < W; ++e) pe[k][e] = qv[k][e] = 0.f;
        if (c < d && ru) ld<W>(pe[k], a.P + (size_t)id.u * d + c);
        if (c < d && ri) ld<W>(qv[k], a.Q + (size_t)id.i * d + c);
      }
      float x = 0.f, nrm = 0.f;
#pragma unroll
      for (int k = 0; k < NP; ++k)
#pragma unroll
        for (int e = 0; e < W; ++e) {
          x = fmaf(pe[k][e] * qv[k][e], hv[k][e], x);
          nrm = fmaf(pe[k][e], pe[k][e], fmaf(qv[k][e], qv[k][e], nrm));
        }
      x = half_sum(x);
      nrm = half_sum(nrm);
      if (!live) continue;
      if (hl == 0) my_loss += slot_loss(x, id.y, nrm, a.reg);
      const float g = 1.f / (1.f + expf(-x)) - id.y;     // sigmoid(x) - y
#pragma unroll
      for (int k = 0; k < NP; ++k) {
        const int c = W * hl + 16 * W * k;
        if (c >= d) continue;
        float gp[W], gq[W];
#pragma unroll
        for (int e = 0; e < W; ++e) {
          const float p = pe[k][e], q = qv[k][e];
          gp[e] = g * (q * hv[k][e]) + a.reg * p;
          gq[e] = g * (p * hv[k][e]) + a.reg * q;
          dh[k][e] += g * (p * q);
        }
        if (ru) atomic_add<W>(a.dP + (size_t)id.u * d + c, gp);
        if (ri) atomic_add<W>(a.dQ + (size_t)id.i * d + c, gq);
      }
    }
    PERSIST_PHASE(0);
    // dh over the warp's halves (lane j and j + 16 own the same columns),
    // then over the block's warps in order, into the block's slice.
#pragma unroll
    for (int k = 0; k < NP; ++k)
#pragma unroll
      for (int e = 0; e < W; ++e) {
        dh[k][e] += __shfl_xor_sync(0xffffffffu, dh[k][e], 16);
        if (half == 0) dh_w[warp][W * hl + 16 * W * k + e] = dh[k][e];
      }
    my_loss += __shfl_xor_sync(0xffffffffu, my_loss, 16);
    if (lane == 0) loss_w[warp] = my_loss;
    __syncthreads();
    fold_dh(&dh_w[0][0], WARPS, COLS, d, a.part + (size_t)blockIdx.x * d);
    block_loss<WARPS>(a, s, loss_w);
    PERSIST_PHASE(1);
    grid_sync(a.bar, round);
    PERSIST_PHASE(2);
    // -- phase B: h's gradient from the slices; Adam over P, Q and h ------
    gmf_phase_b(a, ab, tab, vec, s, first, ahead);
    PERSIST_PHASE(3);
    grid_sync(a.bar, round);
    PERSIST_PHASE(4);
  }
  finish_losses(a.part_loss, a.loss, a.steps, a.bar + 1);
  PERSIST_CLOCK_STORE
}

// The wide kernel (GMF_NARROW_D < d <= GMF_MAX_D), blocks of WIDE_THREADS:
// a half-warp a slot as in gmf_persist, lane j owning columns W j + 16 W k,
// but a slot's rows walked twice (x and the norms, then the gradients,
// the rows' second read from L1) and dh kept in dynamic shared memory, a
// row [d] for each half-warp that only its owner lane of a column adds
// into, so the sums are still in a fixed order.
template <int W>
__global__ void __launch_bounds__(WIDE_THREADS)
gmf_wide(GmfArgs a, AdamBase ab) {
  constexpr int WARPS = WIDE_THREADS / 32;
  extern __shared__ float dh_rows[];    // [2 WARPS][d]: each half-warp's dh
  __shared__ float loss_w[WARPS];
  PERSIST_CLOCK_INIT
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int hl = lane & 15, half = lane >> 4;
  const int G = gridDim.x, d = a.d, B = a.B;
  float* dh = dh_rows + (size_t)(2 * warp + half) * d;
  unsigned round = 0;
  AdamSegs tab = {};
  bool vec[ADAM_MAX_SEGS] = {};
  for (int c = threadIdx.x; c < 2 * WARPS * d; c += WIDE_THREADS)
    dh_rows[c] = 0.f;
  gmf_prologue(a, tab, vec);
  grid_sync(a.bar, round);
  const int first = (warp * G + blockIdx.x) * 2 + half;
  const int stride = WARPS * G * 2;
  Ids ahead = a.steps > 0 ? load_ids(a, 0, first) : Ids{-1, -1, 0.f};
  for (int s = 0; s < a.steps; ++s) {
    // -- phase A: slots, row grads, the block's dh and loss ---------------
    float my_loss = 0.f;
    for (int b = first; b - half < B; b += stride) {
      const Ids id = b == first ? ahead : load_ids(a, s, b);
      const bool live = b < B;
      const bool ru = (unsigned)id.u < (unsigned)a.U;
      const bool ri = (unsigned)id.i < (unsigned)a.I;
      const float* pu = a.P + (size_t)(ru ? id.u : 0) * d;
      const float* qi = a.Q + (size_t)(ri ? id.i : 0) * d;
      float x = 0.f, nrm = 0.f;
#pragma unroll 4
      for (int c = W * hl; c < d; c += 16 * W) {
        float pe[W] = {}, qv[W] = {}, hv[W];
        if (ru) ld<W>(pe, pu + c);
        if (ri) ld<W>(qv, qi + c);
        ld<W>(hv, a.h + c);
#pragma unroll
        for (int e = 0; e < W; ++e) {
          x = fmaf(pe[e] * qv[e], hv[e], x);
          nrm = fmaf(pe[e], pe[e], fmaf(qv[e], qv[e], nrm));
        }
      }
      x = half_sum(x);
      nrm = half_sum(nrm);
      if (!live) continue;
      if (hl == 0) my_loss += slot_loss(x, id.y, nrm, a.reg);
      const float g = 1.f / (1.f + expf(-x)) - id.y;     // sigmoid(x) - y
#pragma unroll 4
      for (int c = W * hl; c < d; c += 16 * W) {
        float pe[W] = {}, qv[W] = {}, hv[W], gp[W], gq[W];
        if (ru) ld<W>(pe, pu + c);
        if (ri) ld<W>(qv, qi + c);
        ld<W>(hv, a.h + c);
#pragma unroll
        for (int e = 0; e < W; ++e) {
          gp[e] = g * (qv[e] * hv[e]) + a.reg * pe[e];
          gq[e] = g * (pe[e] * hv[e]) + a.reg * qv[e];
          dh[c + e] += g * (pe[e] * qv[e]);
        }
        if (ru) atomic_add<W>(a.dP + (size_t)id.u * d + c, gp);
        if (ri) atomic_add<W>(a.dQ + (size_t)id.i * d + c, gq);
      }
    }
    PERSIST_PHASE(0);
    my_loss += __shfl_xor_sync(0xffffffffu, my_loss, 16);
    if (lane == 0) loss_w[warp] = my_loss;
    __syncthreads();
    fold_dh(dh_rows, 2 * WARPS, d, d, a.part + (size_t)blockIdx.x * d);
    block_loss<WARPS>(a, s, loss_w);
    PERSIST_PHASE(1);
    grid_sync(a.bar, round);
    PERSIST_PHASE(2);
    gmf_phase_b(a, ab, tab, vec, s, first, ahead);
    PERSIST_PHASE(3);
    grid_sync(a.bar, round);
    PERSIST_PHASE(4);
  }
  finish_losses(a.part_loss, a.loss, a.steps, a.bar + 1);
  PERSIST_CLOCK_STORE
}

// The variant for d and vec: W = 4 where vec, else W = 1.  At d <= 64 the
// narrow kernel with the fewest pieces a lane that cover d: the float4
// variant fits 64 registers and takes one block of 1024 threads an SM
// (half the blocks at each barrier), the scalar one 512.  Past 64 the
// wide kernel (at d 64 on an H100 it took 1.05 device ms an epoch at
// GMF's conf shape against the narrow kernel's 0.70).
PersistKernel pick(int d, int vec) {
  if (d > GMF_NARROW_D)
    return vec ? PersistKernel{(const void*)gmf_wide<4>, WIDE_THREADS}
               : PersistKernel{(const void*)gmf_wide<1>, WIDE_THREADS};
  return vec ? PersistKernel{(const void*)gmf_persist<4, 1, 1024>, 1024}
             : PersistKernel{(const void*)gmf_persist<1, 4, 512>, 512};
}

// The wide kernel's half-warps' dh rows in dynamic shared memory.
size_t smem_bytes(int d) {
  return d > GMF_NARROW_D ? (size_t)(WIDE_THREADS / 16) * d * sizeof(float)
                          : 0;
}

// Lets the variant for d use its dynamic shared memory; returns 0 or a
// cudaError_t.
int allow_smem(PersistKernel k, int d) {
  return (int)cudaFuncSetAttribute(
      k.fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes(d));
}

}  // namespace

// The variant for (d, vec): the blocks of it that an SM holds at once and
// its threads a block, into *per_sm and *threads; returns 0 or a
// cudaError_t.
extern "C" int gmf_epoch_occupancy(int d, int vec, int* per_sm,
                                   int* threads) {
  const PersistKernel k = pick(d, vec);
  const int err = allow_smem(k, d);
  if (err != 0) return err;
  return persist_occupancy(k, smem_bytes(d), per_sm, threads);
}

// All pointers in ``a`` are device pointers; the parameters and their
// Adam moments are updated in place, and the scratch (dP, dQ, part,
// part_loss, loss, bar) needs no initial value; bc [steps, 2] holds the
// bias corrections of steps t0 + 1 .. t0 + steps.  loss[s] receives step
// s's summed loss and loss[steps] their sum.  vec: d % 4 == 0 and every
// state tensor 16-byte aligned.  blocks: at most the SM count times
// gmf_epoch_occupancy's count (one cooperative wave).  Returns 0, or the
// cudaError_t of the launch (cudaErrorInvalidValue for a shape the kernel
// does not take; cudaErrorCooperativeLaunchTooLarge when the wave does
// not fit).
extern "C" int gmf_epoch(const GmfArgs* a, cudaStream_t stream) {
  if (a->d < 1 || a->d > GMF_MAX_D || a->blocks < 1 || a->B < 0 ||
      a->steps < 0 || (a->vec && a->d % 4))
    return (int)cudaErrorInvalidValue;
  const PersistKernel k = pick(a->d, a->vec);
  const int err = allow_smem(k, a->d);
  if (err != 0) return err;
  GmfArgs args = *a;
  AdamBase ab = adam_base(a->lr, a->b1, a->b2, a->eps);
  void* params[] = {&args, &ab};
  return persist_launch(k, a->blocks, params, args.bar, stream,
                        smem_bytes(a->d));
}

extern "C" const char* gmf_epoch_error(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
