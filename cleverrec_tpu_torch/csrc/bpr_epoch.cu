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
// t = t0 + s + 1, its bias corrections read from the wrapper's table (the
// numbers the plain version uses).  An id outside its table (the
// sampler's sentinels U_pad - 1, I_pad - 1) reads a zero row and writes
// nothing: a slot whose three ids are sentinels changes nothing but adds
// log 2 to the loss, which the caller subtracts.
//
// The TPU kernel keeps the tables and moments resident in VMEM and does
// its gathers and scatters as one-hot matrix products, because Mosaic has
// no lane gather.  Here the sequential grid is one persistent kernel
// (persist.cuh): one cooperative launch an epoch, one block of 768
// threads on each SM, two grid barriers a step.
//
//   prologue  the dP, dQ scratch zeroed.
//   phase A   a warp takes a slot (a half-warp where d <= 64), the slots
//             spread over the blocks block-minor, each slot's ids loaded
//             one slot ahead (a warp's first slot's during the previous
//             phase B).  Lane l owns the W columns at W l + L W k (L the
//             lanes a slot, W = 4: float4 rows where d % 4 == 0 and the
//             state is 16-byte aligned, else W = 1, the scalar variant)
//             and issues its pieces of P[u], Q[i] and Q[j] before the
//             first FMA; up to L W NP columns (64 or 128) the pieces stay in
//             registers for the gradients, so the rows are read once,
//             past it the slot walks 128-column chunks twice.  Two
//             shuffle sums give diff and the squared norms, three float4
//             reductions a piece (red.global.add.v4.f32, sm_90;
//             persist.cuh's atomic_add) send the row gradients into dP and
//             dQ.  The block's loss goes into part_loss[s, block].
//             A barrier.
//   phase B   the next step's first slots' ids are loaded and the rest of
//             its id planes asked of L2; then the grid runs epoch.cuh's
//             adam_tables over P and Q, their moments in device memory:
//             each element reads its gradient, zeroes it, and updates the
//             parameter and its moments.  A barrier (none after the last
//             step).  Keeping each block's share of the rows' p, m and v
//             in shared memory for the whole launch instead took more
//             time at ml-100k's shape (PERF.md section 5).
//
// bf16 storage (bf16 = 1; the TPU kernel's table_dtype=bfloat16,
// pallas_train.py:114-316): the six state tensors hold bf16-representable
// values in their f32 buffers (the prologue rounds them on entry), each
// slot's three row gradients are rounded to bf16 before their f32
// reductions, and adam_tables rounds p, m and v back to bf16 on write.
// Every read and the loss stay f32.  The buffers stay f32, so the bytes
// moved are those of the f32 kernel: this variant reproduces the TPU
// kernel's numbers, not its halved storage.
//
// Then the steps' losses are summed (persist.cuh's finish_losses).  The
// loss, and m and v of a row no slot of the step touched, are the same
// from run to run after one step; the row sums use f32 atomics, whose
// order varies, and through the next step so does the rest: results match
// the plain version to a tolerance, not bit for bit.
//
// What bounds it on an H100: per step the slots read and scatter 3 B rows
// (at ml-100k's shape, 943 + 1682 rows, d 128, B 6144: 9.4 MB of loads
// and 9.4 MB of reductions, all in L2), then Adam reads and writes the
// tables, their moments and the gradients (10.75 MB).  The L2's work on the
// reductions sets phase A's pace, and what is still queued at the barrier
// delays phase B's gradient reads; the two barriers and the slowest
// block's lag add a latency floor far above the least time of the
// function (its FP32 operations).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "epoch.cuh"
#include "persist.cuh"

// Outside the unnamed namespace: a type of the C interface must not have
// internal linkage.  ops/train.py's _BprArgs must agree with it field for
// field.
struct BprArgs {
  // P [U, d], Q [I, d] and their moments; dP, dQ scratch.
  float *P, *Q, *mP, *vP, *mQ, *vQ, *dP, *dQ;
  const int32_t *u, *i, *j;      // [steps, B]
  const float* bc;               // [steps, 2]: Adam's bias corrections
  float* part_loss;              // [steps, blocks]
  float* loss;                   // [steps + 1]: each step's, then the sum
  unsigned* bar;                 // [2]: the barrier's and finish_losses' counters
  int U, I, d, steps, B, blocks, vec;
  float lr, reg, eps;
  double b1, b2;
  int bf16;                      // bf16 storage: see above
};

namespace {

// One block an SM.  Blocks of 768 threads keep phase A's slot state in
// 80 registers a thread without spills; at 1024 (64 registers) the kernel
// spilled 72 bytes a thread, and its slots took more cycles a step
// (PERF.md section 5).  ops/train.py reads the count from
// bpr_epoch_occupancy.
constexpr int BPR_THREADS = 768, BPR_WARPS = BPR_THREADS / 32;

// A slot's ids (past B: none, never read).
struct Ids {
  int u, i, j;
};

__device__ __forceinline__ Ids load_ids(const BprArgs& a, int s, int64_t b) {
  if (b >= a.B) return {-1, -1, -1};
  const size_t off = (size_t)s * a.B + b;
  return {__ldg(a.u + off), __ldg(a.i + off), __ldg(a.j + off)};
}

// The next step's id planes asked of L2.
__device__ __forceinline__ void prefetch_ids(const BprArgs& a, int s) {
  const size_t off = (size_t)s * a.B;
  const int64_t plane = (int64_t)a.B * sizeof(int32_t);
  prefetch_l2(a.u + off, plane);
  prefetch_l2(a.i + off, plane);
  prefetch_l2(a.j + off, plane);
}

// -log sigmoid(diff) = softplus(-diff), in its stable form, and the
// squared norms' regulariser.
__device__ __forceinline__ float slot_loss(float diff, float nrm, float reg) {
  return fmaxf(-diff, 0.f) + log1pf(expf(-fabsf(diff))) + 0.5f * reg * nrm;
}

// One slot's row pieces: NP pieces of W columns of P[u], Q[i] and Q[j].
template <int W, int NP>
struct Pieces {
  float p[NP][W], qi[NP][W], qj[NP][W];
};

// The lane's pieces of the chunk at column c0 (lane gl of the L lanes of
// its slot owns the columns c0 + W gl + L W k); zero outside a table or
// past d.
template <int W, int NP, int L>
__device__ __forceinline__ void load_pieces(const BprArgs& a, const Ids& id,
                                            int gl, int c0,
                                            Pieces<W, NP>& r) {
  const int d = a.d;
  const bool ru = (unsigned)id.u < (unsigned)a.U;
  const bool ri = (unsigned)id.i < (unsigned)a.I;
  const bool rj = (unsigned)id.j < (unsigned)a.I;
#pragma unroll
  for (int k = 0; k < NP; ++k) {
    const int c = c0 + W * gl + L * W * k;
#pragma unroll
    for (int e = 0; e < W; ++e) r.p[k][e] = r.qi[k][e] = r.qj[k][e] = 0.f;
    if (c >= d) continue;
    if (ru) ld<W>(r.p[k], a.P + (size_t)id.u * d + c);
    if (ri) ld<W>(r.qi[k], a.Q + (size_t)id.i * d + c);
    if (rj) ld<W>(r.qj[k], a.Q + (size_t)id.j * d + c);
  }
}

// diff's and the squared norms' shares of the lane's pieces.
template <int W, int NP>
__device__ __forceinline__ void add_dots(const Pieces<W, NP>& r, float& dot,
                                         float& nrm) {
#pragma unroll
  for (int k = 0; k < NP; ++k)
#pragma unroll
    for (int e = 0; e < W; ++e) {
      const float pe = r.p[k][e], qi = r.qi[k][e], qj = r.qj[k][e];
      dot = fmaf(pe, qi - qj, dot);
      nrm = fmaf(pe, pe, fmaf(qi, qi, fmaf(qj, qj, nrm)));
    }
}

// The row gradients of the lane's pieces into dP and dQ.
template <int W, int NP, int L>
__device__ __forceinline__ void scatter(const BprArgs& a, const Ids& id,
                                        int gl, int c0, float g,
                                        const Pieces<W, NP>& r) {
  const int d = a.d;
  const float reg = a.reg;
  const bool ru = (unsigned)id.u < (unsigned)a.U;
  const bool ri = (unsigned)id.i < (unsigned)a.I;
  const bool rj = (unsigned)id.j < (unsigned)a.I;
#pragma unroll
  for (int k = 0; k < NP; ++k) {
    const int c = c0 + W * gl + L * W * k;
    if (c >= d) continue;
    float gp[W], gi[W], gj[W];
#pragma unroll
    for (int e = 0; e < W; ++e) {
      const float pe = r.p[k][e], qi = r.qi[k][e], qj = r.qj[k][e];
      gp[e] = g * (qi - qj) + reg * pe;
      gi[e] = g * pe + reg * qi;
      gj[e] = -g * pe + reg * qj;
      if (a.bf16) {
        gp[e] = bf16r(gp[e]);
        gi[e] = bf16r(gi[e]);
        gj[e] = bf16r(gj[e]);
      }
    }
    if (ru) atomic_add<W>(a.dP + (size_t)id.u * d + c, gp);
    if (ri) atomic_add<W>(a.dQ + (size_t)id.i * d + c, gi);
    if (rj) atomic_add<W>(a.dQ + (size_t)id.j * d + c, gj);
  }
}

// One slot of phase A by its L lanes (the whole warp runs the call: the
// sums shuffle over all 32 lanes); returns the slot's loss on the slot's
// first lane, else 0.  Up to COLS = L W NP columns the pieces stay in
// registers from the sums to the gradients; past it the slot walks its
// chunks twice (the second time from L1), so that no more than one
// chunk's pieces are live at once.
template <int W, int NP, int L>
__device__ __forceinline__ float slot(const BprArgs& a, const Ids& id,
                                      bool live, int gl) {
  constexpr int COLS = L * W * NP;
  const bool one = a.d <= COLS;
  Pieces<W, NP> r;
  float dot = 0.f, nrm = 0.f;
  if (one) {
    load_pieces<W, NP, L>(a, id, gl, 0, r);
    add_dots(r, dot, nrm);
  } else {
    for (int c0 = 0; c0 < a.d; c0 += COLS) {
      Pieces<W, NP> chunk;
      load_pieces<W, NP, L>(a, id, gl, c0, chunk);
      add_dots(chunk, dot, nrm);
    }
  }
  dot = L == 16 ? half_sum(dot) : warp_sum(dot);
  nrm = L == 16 ? half_sum(nrm) : warp_sum(nrm);
  if (!live) return 0.f;
  const float g = -1.f / (1.f + expf(dot));      // -sigmoid(-diff)
  if (one) {
    scatter<W, NP, L>(a, id, gl, 0, g, r);
  } else {
    for (int c0 = 0; c0 < a.d; c0 += COLS) {
      Pieces<W, NP> chunk;
      load_pieces<W, NP, L>(a, id, gl, c0, chunk);
      scatter<W, NP, L>(a, id, gl, c0, g, chunk);
    }
  }
  return gl == 0 ? slot_loss(dot, nrm, a.reg) : 0.f;
}

// The kernel: L lanes a slot, NP pieces of W columns a lane (L W NP
// columns a chunk).
template <int W, int NP, int L>
__global__ void __launch_bounds__(BPR_THREADS, 1)
bpr_persist(BprArgs a, AdamBase ab) {
  constexpr int SPW = 32 / L;              // slots a warp at once
  __shared__ float loss_w[BPR_WARPS];
  PERSIST_CLOCK_INIT
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gl = lane % L, sub = lane / L;
  const int G = gridDim.x;
  unsigned round = 0;
  AdamSegs tab = {};
  adam_add(tab, a.P, a.mP, a.vP, a.dP, (int64_t)a.U * a.d);
  adam_add(tab, a.Q, a.mQ, a.vQ, a.dQ, (int64_t)a.I * a.d);
  const bool vec[ADAM_MAX_SEGS] = {(bool)a.vec, (bool)a.vec};
  if (a.bf16) round_tables(tab);
  grid_zero(a.dP, (int64_t)a.U * a.d);
  grid_zero(a.dQ, (int64_t)a.I * a.d);
  if (a.steps > 0) prefetch_ids(a, 0);
  grid_sync(a.bar, round);
  // A slot's L lanes, slots block-minor.  The loop is the same for the
  // whole warp (its sums shuffle over all 32 lanes), each group of L
  // lanes checking its own slot.
  const int64_t first = ((int64_t)warp * G + blockIdx.x) * SPW + sub;
  const int64_t stride = (int64_t)BPR_WARPS * G * SPW;
  Ids ahead = a.steps > 0 ? load_ids(a, 0, first) : Ids{-1, -1, -1};
  for (int s = 0; s < a.steps; ++s) {
    // -- phase A: slots, row grads, the block's loss ------------------------
    float my_loss = 0.f;
    Ids id = ahead;
    for (int64_t b = first; b - sub < a.B; b += stride) {
      const Ids next = load_ids(a, s, b + stride);
      my_loss += slot<W, NP, L>(a, id, b < a.B, gl);
      id = next;
    }
    if (L == 16) my_loss += __shfl_xor_sync(0xffffffffu, my_loss, 16);
    if (lane == 0) loss_w[warp] = my_loss;
    PERSIST_PHASE(0);
    __syncthreads();
    if (threadIdx.x == 0) {
      float l = 0.f;
#pragma unroll
      for (int w = 0; w < BPR_WARPS; ++w) l += loss_w[w];
      a.part_loss[(size_t)s * G + blockIdx.x] = l;
    }
    PERSIST_PHASE(1);
    grid_sync(a.bar, round);
    PERSIST_PHASE(2);
    // -- phase B: Adam over P and Q; the next step's ids --------------------
    const bool more = s + 1 < a.steps;
    if (more) {
      prefetch_ids(a, s + 1);
      ahead = load_ids(a, s + 1, first);
    }
    adam_tables(tab, vec, step_at(ab, a.bc, s), grid_thread(),
                (int64_t)G * blockDim.x, a.bf16);
    PERSIST_PHASE(3);
    if (more) grid_sync(a.bar, round);
    PERSIST_PHASE(4);
  }
  finish_losses(a.part_loss, a.loss, a.steps, a.bar + 1);
  PERSIST_CLOCK_STORE
}

template <int W, int NP, int L>
PersistKernel kernel() {
  return {(const void*)bpr_persist<W, NP, L>, BPR_THREADS};
}

// The variant for (d, vec): float4 pieces where vec, a half-warp a slot at
// d <= 64 and a warp past it; scalar pieces, four a lane, a warp a slot,
// where not.
PersistKernel pick(int d, int vec) {
  if (!vec) return kernel<1, 4, 32>();
  return d <= 64 ? kernel<4, 1, 16>() : kernel<4, 1, 32>();
}

}  // namespace

// The variant for (d, vec): the blocks of it that an SM holds at once and
// its threads a block, into *per_sm and *threads; returns 0 or a
// cudaError_t.
extern "C" int bpr_epoch_occupancy(int d, int vec, int* per_sm,
                                   int* threads) {
  return persist_occupancy(pick(d, vec), 0, per_sm, threads);
}

// All pointers in ``a`` are device pointers; the parameters and their
// Adam moments are updated in place, and the scratch (dP, dQ, part_loss,
// loss, bar) needs no initial value; bc [steps, 2] holds the bias
// corrections of steps t0 + 1 .. t0 + steps.  loss[s] receives step s's
// summed loss and loss[steps] their sum.  vec: d % 4 == 0 and every state
// tensor 16-byte aligned.  blocks: ops/train.py's bpr_epoch_plan, at most
// the SM count times bpr_epoch_occupancy's count (one cooperative wave).
// Returns 0, or the cudaError_t of the launch (cudaErrorInvalidValue for a
// shape the kernel does not take; cudaErrorCooperativeLaunchTooLarge when
// the wave does not fit).
extern "C" int bpr_epoch(const BprArgs* a, cudaStream_t stream) {
  if (a->d < 0 || a->U < 0 || a->I < 0 || a->blocks < 1 || a->B < 0 ||
      a->steps < 0 || (a->vec && a->d % 4))
    return (int)cudaErrorInvalidValue;
  BprArgs args = *a;
  AdamBase ab = adam_base(a->lr, a->b1, a->b2, a->eps);
  void* params[] = {&args, &ab};
  return persist_launch(pick(a->d, a->vec), a->blocks, params, args.bar,
                        stream);
}

extern "C" const char* bpr_epoch_error(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
