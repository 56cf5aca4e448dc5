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
// then dense Adam over ALL of P, Q, bias[:I] and s at step t0 + s + 1:
// untouched rows decay too.  A row whose user id is outside P (the
// trainer's sentinel U_pad - 1) is masked: it adds nothing to the loss
// and writes nothing, so the loss needs no correction; an item id outside
// Q reads a zero row and bias and writes nothing.
//
// The TPU kernel packs [Q | bias] into one odd-width table for its
// one-hot gather and scatter matmuls (Mosaic has no lane gather) and its
// streamed variant walks slabs of the tables through VMEM.  Neither
// carries over: here Q and bias stay separate tensors (bias is the
// model's own vector, whose last slot, the eval PAD item, the kernel
// never sees), the state stays in device memory, and the sequential grid
// becomes a host loop, two launches a step:
//
//   rows_chain   two rows a warp, 16 rows a block, one block per 16 rows
//                of the step, so every row of a step is in flight at once
//                (three blocks an SM: one wave at 6,144 rows).  Each
//                lane owns 4 contiguous columns (vec: d % 4 == 0 and the
//                tables 16-byte aligned; else 1 column, the scalar
//                variant), reads its rows' 2 (L + 1) table rows together
//                as float4s, and sends each table-row gradient as one float4
//                atomicAdd (sm_90): duplicate ids sum.  The block's loss
//                and ds leave by plain stores into its slice of part.
//   adam_slices  one pass over P, Q, bias[:I] (float4 where aligned) and
//                s, whose gradient, like the step's loss, is the sum of
//                the blocks' slices in block order (epoch.cuh).
//
// What bounds it on an H100: per step the rows read and scatter (L + 1) B
// rows and Adam makes ~9 passes over (U + I) d floats; at ml-100k's shape
// (943 + 1682 rows, d 128, B 6144) the state stays in the 50 MB L2, so a
// step is bound by L2 traffic, the row-gradient atomics and the two
// launches, far above the least time of the function.  The loss and s are
// the same from run to run after one step; the tables' row sums use f32
// atomics, whose order varies, and through the next step so does the
// rest: results match the plain version to a tolerance, not bit for bit.
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
// plus reg on each gathered row.  K [d, mem] and M [mem, d] are dense.
// Per real row the forward is 2 x 2 d mem FMAs and the backward of an
// active row 4 x 2 d mem more, all products with K or M:
//
//   lrml_tiles   one wave of blocks of 512 threads; a block takes tiles of
//                R rows (2 R sides, i and j; ops/train.py's lrml_plan sizes
//                R from the SM count and shared memory, and a block loops
//                over its tiles).  K and M are staged once a block, zero-
//                padded to mem' = mem rounded up to 4; the tile's rows by
//                cp.async (16 bytes where vec).  Every product runs over
//                the tile as a register-tiled FP32 product from shared
//                memory (tile.cuh's gemm4): L = A K and R = Att M for all
//                2 R sides; then, for the sides of the rows whose hinge is
//                active only (a list in shared memory, which gemm4 reads
//                its rows through), G_att = G_e M^T, G_a = G_l K^T, and
//                the sums over the tile dM += Att^T G_e and dK += A^T G_l.
//                Pad logits (K's zero columns give 0, not -inf) get no
//                weight in the softmax.  dK and dM stay in shared memory,
//                each element added by one thread, and leave the block by
//                plain stores into its slice of part, with its loss: no
//                atomics on K, M or the loss.  A row whose hinge is
//                inactive writes only its reg grads; the row grads go to
//                dP/dQ by atomicAdd (float4 where vec).
//   adam_slices  one pass over P and Q (float4) and K and M, whose
//                gradients are the blocks' slices summed in block order.
//
// So K, M, their moments and the loss are the same from run to run after
// one step.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "cp_async.cuh"
#include "epoch.cuh"
#include "tile.cuh"

constexpr int ROWS_MAX_ITEMS = 4;

#ifdef ROWS_CLOCKS
// tools/rows_phases.py builds the kernels with -DROWS_CLOCKS: thread 0 of
// each block adds the clock64() cycles of each phase of its last launch
// (lrml_tiles: summed over the block's tiles, each phase ending at a
// barrier; rows_chain: its warp 0's rows), and rows_read_clocks copies
// them out.
constexpr int ROWS_PHASES = 15, ROWS_STAMP_BLOCKS = 1024;
__device__ long long rows_clocks[ROWS_STAMP_BLOCKS][ROWS_PHASES];
#define PHASE(k)                                                   \
  if (threadIdx.x == 0) {                                          \
    const long long now = clock64();                               \
    ph[k] += now - last;                                           \
    last = now;                                                    \
  }
#else
#define PHASE(k)
#endif

// Outside the unnamed namespace: a type of the C interface must not have
// internal linkage, or the library exports no rows_epoch.  ops/train.py's
// _RowsArgs must agree with it field for field.
struct RowsArgs {
  float* p[4];                    // P [U, d], Q [I, d], bias [I], s [] or null
  float* m[4];                    // their first moments
  float* v[4];                    // their second moments
  float* g[4];                    // zeroed gradient scratch of P and Q (and bias)
  const int32_t* plane[1 + ROWS_MAX_ITEMS];  // u, then the L item planes
  const float* fcol;              // [steps, B] float column, or null
  float* loss;                    // [steps]
  // [blocks, slice]: each block's dense gradients (form 0: ds when there
  // is a dense link; form 1: dK [d, mem] then dM [mem, d]) and its loss.
  float* part;
  int U, I, d, B, items, steps, t0, float_link, dense_link;  // -1: none
  float reg, lr, eps;
  double b1, b2;
  // form 0 or 1; LRML's mem; rows a block (a tile for LRML) and blocks a
  // step; vec: 16-byte rows (d % 4 == 0, tables aligned); LRML's shared
  // memory a block.  Form 1's p, m, v hold P, Q, K [d, mem], M [mem, d].
  int form, mem, rows, blocks, slice, vec, smem_bytes;
  float margin;
};

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int CHAIN_RW = 2;   // rows a warp of rows_chain
constexpr int LRML_THREADS = 512;   // lrml_tiles' block: one an SM
constexpr int LRML_WARPS = LRML_THREADS / 32;

struct StepPlanes {
  const int32_t* plane[1 + ROWS_MAX_ITEMS];
  const float* fcol;
};

// W consecutive floats of a read-only table (W = 4: one 16-byte load).
template <int W>
struct Vec {
  float a[W];
};

template <int W>
__device__ __forceinline__ Vec<W> ldv(const float* p) {
  Vec<W> r;
  if constexpr (W == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    r.a[0] = t.x;
    r.a[1] = t.y;
    r.a[2] = t.z;
    r.a[3] = t.w;
  } else {
    r.a[0] = __ldg(p);
  }
  return r;
}

template <int W>
__device__ __forceinline__ void atomic_addv(float* p, const float (&a)[W]) {
#ifdef ROWS_NO_ATOMICS
  // tools/rows_phases.py --no-atomics: the row grads are computed (a
  // store no real value takes keeps them) but not added, to time the
  // kernels without their atomics.  The results are wrong.
  if (a[0] == 1.2345e30f) *p = a[0];
  return;
#endif
  if constexpr (W == 4)
    atomicAdd(reinterpret_cast<float4*>(p), make_float4(a[0], a[1], a[2], a[3]));
  else
    atomicAdd(p, a[0]);
}

// RW rows a warp, their loads issued together (three blocks an SM at
// RW = 2: a step's 384 blocks of 6,144 rows fit in one wave on 132 SMs).
template <int W, int RW>
__global__ void __launch_bounds__(THREADS, 3)
rows_chain(const float* __restrict__ P, const float* __restrict__ Q,
           const float* __restrict__ bias, const float* __restrict__ s_par,
           float* __restrict__ dP, float* __restrict__ dQ,
           float* __restrict__ dbias, StepPlanes st, float* __restrict__ part,
           int slice, int U, int I, int d, int B, int items, int float_link,
           int dense_link, float reg) {
  __shared__ float part_loss[WARPS];
  __shared__ float part_ds[WARPS];
#ifdef ROWS_CLOCKS
  long long ph[ROWS_PHASES] = {}, last = clock64();
#endif
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b0 = (blockIdx.x * WARPS + warp) * RW;
  // The rows' ids and floats, all loaded at once; a row past the batch or
  // whose user id is outside P is masked (w = 0).
  int u[RW], id[RW][ROWS_MAX_ITEMS];
  float f[RW];
  bool ok[RW][ROWS_MAX_ITEMS];
#pragma unroll
  for (int rr = 0; rr < RW; ++rr) {
    const int b = b0 + rr;
    u[rr] = b < B ? st.plane[0][b] : -1;
    f[rr] = b < B && float_link >= 0 ? st.fcol[b] : 0.f;
#pragma unroll
    for (int m = 0; m < ROWS_MAX_ITEMS; ++m)
      id[rr][m] = b < B && m < items ? st.plane[1 + m][b] : -1;
  }
  const float s_den = dense_link >= 0 ? s_par[0] + 1.f : 1.f;
  bool valid[RW];
  float dot[RW][ROWS_MAX_ITEMS], bm[RW][ROWS_MAX_ITEMS], nrm[RW];
#pragma unroll
  for (int rr = 0; rr < RW; ++rr) {
    valid[rr] = (unsigned)u[rr] < (unsigned)U;
    nrm[rr] = 0.f;
#pragma unroll
    for (int m = 0; m < ROWS_MAX_ITEMS; ++m) {
      ok[rr][m] = valid[rr] && (unsigned)id[rr][m] < (unsigned)I;
      dot[rr][m] = 0.f;
      bm[rr][m] = ok[rr][m] ? bias[id[rr][m]] : 0.f;
    }
  }
  for (int c = W * lane; c < d; c += 32 * W) {
    // Every table row of the warp's rows, loaded before the first FMA.
    Vec<W> pe[RW], q[RW][ROWS_MAX_ITEMS];
#pragma unroll
    for (int rr = 0; rr < RW; ++rr) {
      pe[rr] = valid[rr] ? ldv<W>(P + (size_t)u[rr] * d + c) : Vec<W>{};
#pragma unroll
      for (int m = 0; m < ROWS_MAX_ITEMS; ++m)
        q[rr][m] = ok[rr][m] ? ldv<W>(Q + (size_t)id[rr][m] * d + c) : Vec<W>{};
    }
#pragma unroll
    for (int rr = 0; rr < RW; ++rr)
#pragma unroll
      for (int e = 0; e < W; ++e) {
        nrm[rr] = fmaf(pe[rr].a[e], pe[rr].a[e], nrm[rr]);
#pragma unroll
        for (int m = 0; m < ROWS_MAX_ITEMS; ++m) {
          dot[rr][m] = fmaf(pe[rr].a[e], q[rr][m].a[e], dot[rr][m]);
          nrm[rr] = fmaf(q[rr][m].a[e], q[rr][m].a[e], nrm[rr]);
        }
      }
  }
  float warp_loss = 0.f, warp_ds = 0.f;
  float dx[RW][ROWS_MAX_ITEMS];
#pragma unroll
  for (int rr = 0; rr < RW; ++rr) {
    float x[ROWS_MAX_ITEMS];
    float n = warp_sum(nrm[rr]);
#pragma unroll
    for (int m = 0; m < ROWS_MAX_ITEMS; ++m) {
      x[m] = warp_sum(dot[rr][m]) + bm[rr][m];
      n = fmaf(bm[rr][m], bm[rr][m], n);
      dx[rr][m] = 0.f;
    }
    if (!valid[rr]) continue;
    float row_loss = 0.5f * reg * n;
#pragma unroll
    for (int t = 0; t + 1 < ROWS_MAX_ITEMS; ++t) {
      if (t + 1 >= items) break;
      const float c = t == float_link ? fmaxf(f[rr], 1.f)
                      : t == dense_link ? s_den : 1.f;
      const float z = (x[t] - x[t + 1]) / c;
      // -log sigmoid(z) = softplus(-z), in its stable form.
      row_loss += fmaxf(-z, 0.f) + log1pf(expf(-fabsf(z)));
      const float g = -1.f / (1.f + expf(z));         // -sigmoid(-z)
      dx[rr][t] += g / c;
      dx[rr][t + 1] -= g / c;
      if (t == dense_link) warp_ds += g * (-z / c);    // dz/ds = -z / (s + 1)
    }
    warp_loss += row_loss;
  }
  PHASE(0);
  // The row grads; the rows come again from L1.
  for (int c = W * lane; c < d; c += 32 * W) {
#pragma unroll
    for (int rr = 0; rr < RW; ++rr) {
      if (!valid[rr]) continue;
      const Vec<W> pe = ldv<W>(P + (size_t)u[rr] * d + c);
      float acc[W];
#pragma unroll
      for (int e = 0; e < W; ++e) acc[e] = reg * pe.a[e];
#pragma unroll
      for (int m = 0; m < ROWS_MAX_ITEMS; ++m) {
        if (ok[rr][m]) {
          const size_t o = (size_t)id[rr][m] * d + c;
          const Vec<W> q = ldv<W>(Q + o);
          float gq[W];
#pragma unroll
          for (int e = 0; e < W; ++e) {
            acc[e] = fmaf(dx[rr][m], q.a[e], acc[e]);
            gq[e] = fmaf(dx[rr][m], pe.a[e], reg * q.a[e]);
          }
          atomic_addv<W>(dQ + o, gq);
        }
      }
      atomic_addv<W>(dP + (size_t)u[rr] * d + c, acc);
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int rr = 0; rr < RW; ++rr)
#pragma unroll
      for (int m = 0; m < ROWS_MAX_ITEMS; ++m)
        if (ok[rr][m])
          atomicAdd(dbias + id[rr][m], fmaf(reg, bm[rr][m], dx[rr][m]));
  }
  PHASE(1);
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
    float* out = part + (size_t)blockIdx.x * slice;
    if (dense_link >= 0) out[0] = g;
    out[slice - 1] = l;
  }
  PHASE(2);
#ifdef ROWS_CLOCKS
  if (threadIdx.x == 0 && blockIdx.x < ROWS_STAMP_BLOCKS)
    for (int k = 0; k < ROWS_PHASES; ++k) rows_clocks[blockIdx.x][k] = ph[k];
#endif
}

// Row stride, in floats, of a shared array whose rows gemm4 reads across
// threads: a multiple of 4 with an odd count of 16-byte pieces (ops/
// train.py's _ld).
__host__ __device__ constexpr int ld_rows(int n) {
  return (pad4(n) / 4) % 2 ? pad4(n) : pad4(n) + 4;
}

// lrml_tiles' shared memory for R rows, offsets in floats (ops/train.py's
// _lrml_layout computes the same): K [d'][ldk] and M [mem'][ldd] zero-
// padded (d' = d and mem' = mem rounded up to 4), their gradient sums
// dK and dM alike; the tile's user rows U [R][ldd]; for its 2 R sides and
// one zero side (2 R, the pad of the active lists) the item rows X, a = ue
// * x (later g_a), e (later g_e) [2 R + 1][ldd] and the logits (later
// att) and g_att (later g_l) [2 R + 1][ldk]; then 7 R + 8 words: the
// rows' u, i, j ids, hinge and loss, the active sides and their count.
struct LrmlLayout {
  int d4, mp, ldd, ldk;
  int K, M, dK, dM, U, X, A, E, T, G, words, floats;
  __host__ __device__ LrmlLayout(int d, int mem, int R) {
    d4 = pad4(d);
    mp = pad4(mem);
    ldd = ld_rows(d);
    ldk = ld_rows(mem);
    const int sides = 2 * R + 1;
    K = 0;
    M = K + d4 * ldk;
    dK = M + mp * ldd;
    dM = dK + d4 * ldk;
    U = dM + mp * ldd;
    X = U + R * ldd;
    A = X + sides * ldd;
    E = A + sides * ldd;
    T = E + sides * ldd;
    G = T + sides * ldk;
    words = G + sides * ldk;
    floats = words + 7 * R + 8;
  }
};

// Sum and max over the 8 lanes of an aligned group of a warp.
__device__ __forceinline__ float group8_sum(float x) {
#pragma unroll
  for (int off = 4; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ float group8_max(float x) {
#pragma unroll
  for (int off = 4; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ void add4(float* p, const float (&v)[4]) {
  float4 x = ld4(p);
  x.x += v[0];
  x.y += v[1];
  x.z += v[2];
  x.w += v[3];
  *reinterpret_cast<float4*>(p) = x;
}

__global__ void __launch_bounds__(LRML_THREADS, 1)
lrml_tiles(const RowsArgs a, const int32_t* __restrict__ u_idx,
           const int32_t* __restrict__ i_idx,
           const int32_t* __restrict__ j_idx) {
  extern __shared__ float4 sm4[];
  float* sm = reinterpret_cast<float*>(sm4);
  const LrmlLayout lay(a.d, a.mem, a.rows);
  const int d = a.d, mem = a.mem, R = a.rows, S = 2 * R;
  const int d4 = lay.d4, mp = lay.mp, ldd = lay.ldd, ldk = lay.ldk;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* sK = sm + lay.K;
  float* sM = sm + lay.M;
  float* sdK = sm + lay.dK;
  float* sdM = sm + lay.dM;
  float* sU = sm + lay.U;
  float* sX = sm + lay.X;
  float* sA = sm + lay.A;
  float* sE = sm + lay.E;
  float* sT = sm + lay.T;
  float* sG = sm + lay.G;
  int* row_u = reinterpret_cast<int*>(sm + lay.words);
  int* row_i = row_u + R;
  int* row_j = row_i + R;
  int* row_act = row_j + R;
  float* row_loss = reinterpret_cast<float*>(row_act + R);
  int* act = reinterpret_cast<int*>(row_loss + R);   // [2 R + 4]
  int* n_act = act + S + 4;
  const float* P = a.p[0];
  const float* Q = a.p[1];
  const float* Kg = a.p[2];
  const float* Mg = a.p[3];
#ifdef ROWS_CLOCKS
  long long ph[ROWS_PHASES] = {}, last = clock64();
#endif

  // -- once a block: stage K and M zero-padded, zero dK, dM and the zero
  // side's rows ---------------------------------------------------------
  if (a.vec) {
    // 16-byte copies: K [d, mem] flat into dK's room (d mem % 4 == 0),
    // then into its rows; M's rows straight into place.
    for (int e = 4 * threadIdx.x; e < d * mem; e += 4 * LRML_THREADS)
      cp16(sdK + e, Kg + e, 16);
    for (int m = warp; m < mp; m += LRML_WARPS)
      for (int k = 4 * lane; k < ldd; k += 128) {
        const bool ok = m < mem && k < d;
        cp16(sM + m * ldd + k, ok ? Mg + m * d + k : Mg, ok ? 16 : 0);
      }
    cp_commit();
    cp_wait<0>();
    __syncthreads();
    for (int k = warp; k < d4; k += LRML_WARPS)
      for (int m = lane; m < ldk; m += 32)
        sK[k * ldk + m] = m < mem ? sdK[k * mem + m] : 0.f;
    __syncthreads();
  } else {
    for (int k = warp; k < d4; k += LRML_WARPS)
      for (int m = lane; m < ldk; m += 32) {
        const bool ok = k < d && m < mem;
        cp4(sK + k * ldk + m, ok ? Kg + k * mem + m : Kg, ok ? 4 : 0);
      }
    for (int m = warp; m < mp; m += LRML_WARPS)
      for (int k = lane; k < ldd; k += 32) {
        const bool ok = m < mem && k < d;
        cp4(sM + m * ldd + k, ok ? Mg + m * d + k : Mg, ok ? 4 : 0);
      }
    cp_commit();
  }
  for (int e = threadIdx.x; e < d4 * ldk; e += LRML_THREADS) sdK[e] = 0.f;
  for (int e = threadIdx.x; e < mp * ldd; e += LRML_THREADS) sdM[e] = 0.f;
  PHASE(0);
  for (int k = threadIdx.x; k < ldd; k += LRML_THREADS)
    sX[S * ldd + k] = sA[S * ldd + k] = sE[S * ldd + k] = 0.f;
  for (int k = threadIdx.x; k < ldk; k += LRML_THREADS)
    sT[S * ldk + k] = sG[S * ldk + k] = 0.f;
  float block_loss = 0.f;                              // thread 32's
  const auto side = [&](int c) { return act[c]; };     // active side c's row

  const int tiles = (a.B + R - 1) / R;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int r0 = tile * R, nrow = min(R, a.B - r0);
    // -- the tile's ids, a thread a row (-1: outside its table; a row
    // past the batch or with its user outside P is masked) ---------------
    if (threadIdx.x < R) {
      const int r = threadIdx.x;
      int u = -1, i = -1, j = -1;
      if (r < nrow) {
        u = u_idx[r0 + r];
        i = i_idx[r0 + r];
        j = j_idx[r0 + r];
      }
      row_u[r] = (unsigned)u < (unsigned)a.U ? u : -1;
      row_i[r] = (unsigned)i < (unsigned)a.I ? i : -1;
      row_j[r] = (unsigned)j < (unsigned)a.I ? j : -1;
    }
    __syncthreads();
    PHASE(1);
    // -- gather P[u], Q[i], Q[j] into U and X, a warp a row (zero where an
    // id is outside its table, and for a masked row) ---------------------
    for (int r = warp; r < R; r += LRML_WARPS) {
      const int u = row_u[r];
      const int i = u >= 0 ? row_i[r] : -1, j = u >= 0 ? row_j[r] : -1;
      const float* src[3] = {u >= 0 ? P + (size_t)u * d : nullptr,
                             i >= 0 ? Q + (size_t)i * d : nullptr,
                             j >= 0 ? Q + (size_t)j * d : nullptr};
      float* dst[3] = {sU + r * ldd, sX + 2 * r * ldd, sX + (2 * r + 1) * ldd};
      if (a.vec) {
        for (int c = 4 * lane; c < d4; c += 128)
#pragma unroll
          for (int t = 0; t < 3; ++t)
            cp16(dst[t] + c, src[t] ? src[t] + c : P, src[t] ? 16 : 0);
      } else {
        for (int c = lane; c < d4; c += 32)
#pragma unroll
          for (int t = 0; t < 3; ++t) {
            const bool ok = src[t] && c < d;
            cp4(dst[t] + c, ok ? src[t] + c : P, ok ? 4 : 0);
          }
      }
    }
    cp_commit();
    cp_wait<0>();
    __syncthreads();
    PHASE(2);
    // -- a = ue * x --------------------------------------------------------
    const int q4 = d4 / 4;
    for (int e = threadIdx.x; e < S * q4; e += LRML_THREADS) {
      const int s = e / q4, c = 4 * (e - s * q4);
      const float4 x = ld4(sX + s * ldd + c), ue = ld4(sU + (s >> 1) * ldd + c);
      *reinterpret_cast<float4*>(sA + s * ldd + c) =
          make_float4(ue.x * x.x, ue.y * x.y, ue.z * x.z, ue.w * x.w);
    }
    __syncthreads();
    PHASE(3);
    // -- logits l = a K over every side -------------------------------------
    gemm4<LRML_THREADS, true, false, true>(
        sA, ldd, sK, ldk, S, mp, d4, Rows{}, Rows{},
        [&](int m, int n, int, const float (&v)[4]) {
          *reinterpret_cast<float4*>(sT + m * ldk + n) =
              make_float4(v[0], v[1], v[2], v[3]);
        });
    __syncthreads();
    PHASE(4);
    // -- softmax over the mem real logits of each side, 8 lanes a side
    // (S is a multiple of 4); the pad logits (0 from K's zero columns) get
    // att 0, as if they were -inf ---------------------------------------
    const int sl = lane & 7;
    for (int s0 = 4 * warp; s0 < S; s0 += 4 * LRML_WARPS) {
      float* t = sT + (s0 + (lane >> 3)) * ldk;
      float mx = -INFINITY;
      for (int m = sl; m < mem; m += 8) mx = fmaxf(mx, t[m]);
      mx = group8_max(mx);
      float sum = 0.f;
      for (int m = sl; m < mem; m += 8) {
        const float ex = expf(t[m] - mx);
        t[m] = ex;
        sum += ex;
      }
      sum = group8_sum(sum);
      for (int m = sl; m < mp; m += 8) t[m] = m < mem ? t[m] / sum : 0.f;
    }
    __syncthreads();
    PHASE(5);
    // -- r = att M; e = ue + r - x ------------------------------------------
    gemm4<LRML_THREADS, true, false, true>(
        sT, ldk, sM, ldd, S, d4, mp, Rows{}, Rows{},
        [&](int m, int n, int, const float (&v)[4]) {
          const float4 ue = ld4(sU + (m >> 1) * ldd + n), x = ld4(sX + m * ldd + n);
          *reinterpret_cast<float4*>(sE + m * ldd + n) =
              make_float4(ue.x + v[0] - x.x, ue.y + v[1] - x.y,
                          ue.z + v[2] - x.z, ue.w + v[3] - x.w);
        });
    __syncthreads();
    PHASE(6);
    // -- dist, the loss and the hinge, a warp a row; e becomes g_e = 2
    // sigma e on the sides of an active row -------------------------------
    for (int r = warp; r < R; r += LRML_WARPS) {
      const int u = row_u[r];
      float* ei = sE + 2 * r * ldd;
      float* ej = ei + ldd;
      float di = 0.f, dj = 0.f, nrm = 0.f;
      for (int c = 4 * lane; c < d4; c += 128) {   // pad columns are 0
        const float4 e4[2] = {ld4(ei + c), ld4(ej + c)};
        const float4 x4[3] = {ld4(sU + r * ldd + c), ld4(sX + 2 * r * ldd + c),
                              ld4(sX + (2 * r + 1) * ldd + c)};
        di = fmaf(e4[0].x, e4[0].x, fmaf(e4[0].y, e4[0].y,
             fmaf(e4[0].z, e4[0].z, fmaf(e4[0].w, e4[0].w, di))));
        dj = fmaf(e4[1].x, e4[1].x, fmaf(e4[1].y, e4[1].y,
             fmaf(e4[1].z, e4[1].z, fmaf(e4[1].w, e4[1].w, dj))));
#pragma unroll
        for (int t = 0; t < 3; ++t)
          nrm = fmaf(x4[t].x, x4[t].x, fmaf(x4[t].y, x4[t].y,
                fmaf(x4[t].z, x4[t].z, fmaf(x4[t].w, x4[t].w, nrm))));
      }
      di = warp_sum(di);
      dj = warp_sum(dj);
      nrm = warp_sum(nrm);
      const float z = di - dj + a.margin;
      const bool on = u >= 0 && z > 0.f;
      if (lane == 0) {
        row_loss[r] = u >= 0 ? fmaxf(z, 0.f) + 0.5f * a.reg * nrm : 0.f;
        row_act[r] = on;
      }
      if (on)
        for (int c = 4 * lane; c < d4; c += 128) {
          const float4 x = ld4(ei + c), y = ld4(ej + c);
          *reinterpret_cast<float4*>(ei + c) =
              make_float4(2.f * x.x, 2.f * x.y, 2.f * x.z, 2.f * x.w);
          *reinterpret_cast<float4*>(ej + c) =
              make_float4(-2.f * y.x, -2.f * y.y, -2.f * y.z, -2.f * y.w);
        }
    }
    __syncthreads();
    PHASE(7);
    // -- the active sides in row order, padded to a multiple of 4 with the
    // zero side; the tile's loss, row by row ------------------------------
    if (warp == 0) {
      int cnt = 0;
      for (int base = 0; base < R; base += 32) {
        const int r = base + lane;
        const bool f = r < R && row_act[r];
        const unsigned mask = __ballot_sync(0xffffffffu, f);
        const int pos = cnt + __popc(mask & ((1u << lane) - 1u));
        if (f) {
          act[2 * pos] = 2 * r;
          act[2 * pos + 1] = 2 * r + 1;
        }
        cnt += __popc(mask);
      }
      if (lane < 4 && 2 * cnt + lane < pad4(2 * cnt)) act[2 * cnt + lane] = S;
      if (lane == 0) *n_act = 2 * cnt;
    } else if (threadIdx.x == 32) {
      for (int r = 0; r < nrow; ++r) block_loss += row_loss[r];
    }
    __syncthreads();
    PHASE(8);
    const int na = *n_act, na4 = pad4(na);
    if (na > 0) {
      // -- g_att = g_e M^T on the active sides; dM += att^T g_e over them --
      gemm4<LRML_THREADS, true, true, true>(
          sE, ldd, sM, ldd, na4, mp, d4, side, Rows{},
          [&](int m, int n, int dn, const float (&v)[4]) {
            if (m >= na) return;
            float* g = sG + act[m] * ldk + n;
#pragma unroll
            for (int j = 0; j < 4; ++j) g[dn * j] = v[j];
          });
      gemm4<LRML_THREADS, false, false, true>(
          sT, ldk, sE, ldd, mp, d4, na4, side, side,
          [&](int m, int n, int, const float (&v)[4]) { add4(sdM + m * ldd + n, v); });
      __syncthreads();
      PHASE(9);
      // -- g_l = att * (g_att - <att, g_att>), a warp a side ---------------
      for (int c0 = 4 * warp; c0 < na4; c0 += 4 * LRML_WARPS) {   // 8 lanes a side
        const int c = c0 + (lane >> 3);
        const float* t = sT + act[c] * ldk;
        float* g = sG + act[c] * ldk;
        float dot = 0.f;
        for (int m = sl; m < mem; m += 8) dot = fmaf(t[m], g[m], dot);
        dot = group8_sum(dot);
        if (c < na)
          for (int m = sl; m < mem; m += 8) g[m] = t[m] * (g[m] - dot);
      }
      __syncthreads();
      PHASE(10);
      // -- dK += a^T g_l over the active sides -----------------------------
      gemm4<LRML_THREADS, false, false, true>(
          sA, ldd, sG, ldk, d4, mp, na4, side, side,
          [&](int m, int n, int, const float (&v)[4]) { add4(sdK + m * ldk + n, v); });
      __syncthreads();
      PHASE(11);
      // -- g_a = g_l K^T, into a's rows of the active sides ----------------
      gemm4<LRML_THREADS, true, true, true>(
          sG, ldk, sK, ldk, na4, d4, mp, side, Rows{},
          [&](int m, int n, int dn, const float (&v)[4]) {
            if (m >= na) return;
            float* g = sA + act[m] * ldd + n;
#pragma unroll
            for (int j = 0; j < 4; ++j) g[dn * j] = v[j];
          });
      __syncthreads();
      PHASE(12);
    }
    // -- row grads to the table scratch, a warp a row: reg grads for every
    // valid row, the hinge's for an active one ----------------------------
    for (int r = warp; r < R; r += LRML_WARPS) {
      const int u = row_u[r];
      if (u < 0) continue;
      const int i = row_i[r], j = row_j[r];
      const bool on = row_act[r];
      const float* ue = sU + r * ldd;
      const float* xi = sX + 2 * r * ldd;
      const float* xj = xi + ldd;
      const float* gei = sE + 2 * r * ldd;
      const float* gej = gei + ldd;
      const float* gai = sA + 2 * r * ldd;
      const float* gaj = gai + ldd;
      auto grads = [&](int c, float& gu, float& gi, float& gj) {
        gu = a.reg * ue[c];
        gi = a.reg * xi[c];
        gj = a.reg * xj[c];
        if (on) {
          gu += gei[c];
          gi -= gei[c];
          gu = fmaf(gai[c], xi[c], gu);
          gi = fmaf(gai[c], ue[c], gi);
          gu += gej[c];
          gj -= gej[c];
          gu = fmaf(gaj[c], xj[c], gu);
          gj = fmaf(gaj[c], ue[c], gj);
        }
      };
      float* dpu = a.g[0] + (size_t)u * d;
      float* dqi = i >= 0 ? a.g[1] + (size_t)i * d : nullptr;
      float* dqj = j >= 0 ? a.g[1] + (size_t)j * d : nullptr;
      if (a.vec) {   // one float4 atomic a lane and row
        for (int c = 4 * lane; c < d; c += 128) {
          float gu[4], gi[4], gj[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) grads(c + e, gu[e], gi[e], gj[e]);
          atomic_addv<4>(dpu + c, gu);
          if (dqi) atomic_addv<4>(dqi + c, gi);
          if (dqj) atomic_addv<4>(dqj + c, gj);
        }
      } else {
        for (int c = lane; c < d; c += 32) {
          float gu, gi, gj;
          grads(c, gu, gi, gj);
          atomicAdd(dpu + c, gu);
          if (dqi) atomicAdd(dqi + c, gi);
          if (dqj) atomicAdd(dqj + c, gj);
        }
      }
    }
    __syncthreads();
    PHASE(13);
  }
  // -- the block's slice: dK [d, mem], dM [mem, d], its loss --------------
  float* out = a.part + (size_t)blockIdx.x * a.slice;
  for (int k = warp; k < d; k += LRML_WARPS)
    for (int m = lane; m < mem; m += 32) out[k * mem + m] = sdK[k * ldk + m];
  for (int m = warp; m < mem; m += LRML_WARPS)
    for (int k = lane; k < d; k += 32)
      out[d * mem + m * d + k] = sdM[m * ldd + k];
  if (threadIdx.x == 32) out[2 * d * mem] = block_loss;
  PHASE(14);
#ifdef ROWS_CLOCKS
  if (threadIdx.x == 0 && blockIdx.x < ROWS_STAMP_BLOCKS)
    for (int k = 0; k < ROWS_PHASES; ++k) rows_clocks[blockIdx.x][k] = ph[k];
#endif
}

// LRML's epoch (form 1); see rows_epoch.
int lrml_epoch(const RowsArgs* a, cudaStream_t stream) {
  const LrmlLayout lay(a->d, a->mem, a->rows);
  const int tiles = (a->B + a->rows - 1) / a->rows;
  if (a->rows < 2 || a->rows % 2 || a->rows > LRML_THREADS || a->mem < 1 ||
      4 * lay.floats > a->smem_bytes || a->slice != 2 * a->d * a->mem + 1 ||
      (a->B > 0 && (a->blocks < 1 || a->blocks > tiles)))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      lrml_tiles, cudaFuncAttributeMaxDynamicSharedMemorySize, a->smem_bytes);
  if (err != cudaSuccess) return (int)err;
  AdamSlices s = {};
  adam_add(s.tab, a->p[0], a->m[0], a->v[0], a->g[0], (int64_t)a->U * a->d);
  adam_add(s.tab, a->p[1], a->m[1], a->v[1], a->g[1], (int64_t)a->I * a->d);
  for (int k = 0; k < 2; ++k) {
    s.p[k] = a->p[2 + k];
    s.m[k] = a->m[2 + k];
    s.v[k] = a->v[2 + k];
    s.n[k] = a->d * a->mem;
  }
  s.count = 2;
  s.part = a->part;
  s.slice = a->slice;
  s.blocks = a->B > 0 ? a->blocks : 0;
  for (int t = 0; t < a->steps; ++t) {
    if (a->B > 0) {
      const size_t off = (size_t)t * a->B;
      lrml_tiles<<<a->blocks, LRML_THREADS, a->smem_bytes, stream>>>(
          *a, a->plane[0] + off, a->plane[1] + off, a->plane[2] + off);
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
    const int aerr = adam_slices_launch(s, a->t0 + t + 1, a->lr, a->b1, a->b2,
                                        a->eps, a->loss + t, stream);
    if (aerr != 0) return aerr;
  }
  return 0;
}

// The social chain's epoch (form 0); see rows_epoch.
int chain_epoch(const RowsArgs* a, cudaStream_t stream) {
  const int dense = a->dense_link >= 0;
  const int rows = WARPS * CHAIN_RW;
  if (a->items < 2 || a->items > ROWS_MAX_ITEMS || a->rows != rows ||
      a->blocks != (a->B + rows - 1) / rows || a->slice != dense + 1)
    return (int)cudaErrorInvalidValue;
  AdamSlices s = {};
  adam_add(s.tab, a->p[0], a->m[0], a->v[0], a->g[0], (int64_t)a->U * a->d);
  adam_add(s.tab, a->p[1], a->m[1], a->v[1], a->g[1], (int64_t)a->I * a->d);
  adam_add(s.tab, a->p[2], a->m[2], a->v[2], a->g[2], (int64_t)a->I);
  if (dense) {
    s.p[0] = a->p[3];
    s.m[0] = a->m[3];
    s.v[0] = a->v[3];
    s.n[0] = 1;
    s.count = 1;
  }
  s.part = a->part;
  s.slice = a->slice;
  s.blocks = a->blocks;
  for (int t = 0; t < a->steps; ++t) {
    if (a->B > 0) {
      const size_t off = (size_t)t * a->B;
      StepPlanes st = {};
      for (int p = 0; p <= a->items; ++p) st.plane[p] = a->plane[p] + off;
      st.fcol = a->fcol ? a->fcol + off : nullptr;
      if (a->vec)
        rows_chain<4, CHAIN_RW><<<a->blocks, THREADS, 0, stream>>>(
            a->p[0], a->p[1], a->p[2], a->p[3], a->g[0], a->g[1], a->g[2], st,
            a->part, a->slice, a->U, a->I, a->d, a->B, a->items,
            a->float_link, a->dense_link, a->reg);
      else
        rows_chain<1, CHAIN_RW><<<a->blocks, THREADS, 0, stream>>>(
            a->p[0], a->p[1], a->p[2], a->p[3], a->g[0], a->g[1], a->g[2], st,
            a->part, a->slice, a->U, a->I, a->d, a->B, a->items,
            a->float_link, a->dense_link, a->reg);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
    const int err = adam_slices_launch(s, a->t0 + t + 1, a->lr, a->b1, a->b2,
                                       a->eps, a->loss + t, stream);
    if (err != 0) return err;
  }
  return 0;
}

}  // namespace

// All pointers in ``a`` are device pointers; the parameters and their
// Adam moments are updated in place, the gradient scratch is zero on
// entry and on return, part needs no initial value, and loss[s] receives
// step s's summed loss.  b1 and b2 come as doubles (epoch.cuh).  Returns
// 0, or the cudaError_t of the first launch that failed
// (cudaErrorInvalidValue for a plan the kernels do not take).
extern "C" int rows_epoch(const RowsArgs* a, cudaStream_t stream) {
  return a->form == 1 ? lrml_epoch(a, stream) : chain_epoch(a, stream);
}

#ifdef ROWS_CLOCKS
// The phase cycles of the last launch of lrml_tiles or rows_chain:
// [1024 blocks][15] into host memory ``out``; returns 0 or a cudaError_t.
extern "C" int rows_read_clocks(long long* out) {
  return (int)cudaMemcpyFromSymbol(out, rows_clocks, sizeof(rows_clocks));
}
#endif
