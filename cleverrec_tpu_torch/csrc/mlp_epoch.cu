// One pointwise tower epoch (the NCF MLP and NeuMF models) with dense Adam
// on Hopper (sm_90a), behind a plain C interface that
// cleverrec_tpu_torch/ops/train.py loads with ctypes.
//
// Replaces fused_mlp_epoch of cleverrec_tpu/ops/pallas_train.py
// (_mlp_kernel, pallas_call :631).  The TPU kernel differentiates the
// model's row_loss with jax.value_and_grad inside the kernel; CUDA has no
// such thing, so the backward is written here by hand for the one form
// that fused_mlp_spec gives for both models.  Per row, with the user row
// pe = PU[u] = [pe_g | pe_m] and the item row qe = QI[i] = [qe_g | qe_m]
// (GMF width dg, 0 for MLP; MLP width hm), weight w and label y:
//
//   ug, um, ig, im = w pe_g, w pe_m, w qe_g, w qe_m
//   x_0 = [um | im];  x_{l+1} = relu(x_l W_l + b_l),  l < L (W_l [in, out])
//   z = [ug * ig | x_L];  logit = z . h
//   loss = w bce(logit, y) + 0.5 reg_g (|ug|^2 + |ig|^2)
//                          + 0.5 reg_m (|um|^2 + |im|^2)
//
// and its gradient: dl = w (sigmoid(logit) - y); dh += dl z;
// dx_L = dl h[dg:]; da_l = dx_{l+1} * (x_{l+1} > 0) (relu's gradient at 0
// is 0, as in JAX); dW_l += x_l^T da_l; db_l += da_l; dx_l = da_l W_l^T;
// dPU[u] += w [dl h[:dg] * ig + reg_g ug | dx_0[:hm] + reg_m um] and the
// same on the item side.  Rows with w = 0 (padding, at the sentinel ids)
// contribute nothing: the kernel masks them, so no loss correction is due.
// After each step, dense Adam over the two tables and every dense param
// at step t0 + s + 1.
//
// What bounds it on an H100: the tower's FP32 products, 3 sum(in out)
// FMAs a row (forward, dW, dx; 32.3k at [128, 64], [64, 32], [32, 16]), on
// the CUDA cores: at 6,144 rows a step that is 396 MFLOP, 5.9 us at the
// FP32 peak.  Every other term of a step (the rows' gathers and
// scatters, Adam over ~350k state elements in L2) is a few us of memory
// traffic.  Design, two launches a step:
//
//   mlp_rows   one wave: a block of 256 threads takes a tile of R rows,
//              R = ceil(B / SMs) rounded up to 16 (48 rows and 128 blocks
//              at 6,144 rows on 132 SMs; smaller where shared memory is
//              short, and at most 256), so W is staged once a block a
//              step.  cp.async stages W_l, b_l and h, zero-padded to
//              widths of 4, and gathers the rows; the products run from
//              shared memory on the CUDA cores (tile.cuh's gemm4: 4 x 4 sums
//              a thread, float4 loads, each operand laid out so that its
//              loads are contiguous, a broadcast, or rows at a stride of an
//              odd number of 16-byte pieces: no bank conflicts).  The
//              column sums (dh, db_l) are split over the warps and added
//              in a fixed order (col_sums).  The block's dW_l, db_l and dh
//              leave by plain stores into its own slice of part [blocks,
//              n_dense], and each row's w-scaled grads by plain stores
//              into its row of the step's row-gradient buffers rg [B, tw]
//              (float4 where vec): no atomics anywhere.
//   mlp_adam   one Adam step over everything: a dense element's gradient
//              is the sum of the blocks' slices in a fixed order, a table
//              element's the sum of its id's rows of rg in batch order,
//              through the wrapper's per-step CSR of the ids (the batch
//              rows sorted stably by id, and where each id's run starts):
//              duplicate ids sum.
//
// So every sum is in a fixed order and an epoch is the same bit for bit
// from run to run on one card (the row tile, and with it the order of the
// dense sums, follows the SM count).  That matters beyond the kernel: the
// MLP recipe sits on a plateau for its first ten epochs (the JAX package's
// run too), and when it leaves it hangs on the rounding of every step, so
// a run-dependent order gave run-dependent models.  Against the plain
// version it matches to a tolerance, not bit for bit.
//
// Where a block's cycles go (tools/mlp_phases.py, built with
// -DMLP_CLOCKS): over half in the products, which a 4 x 4 tile leaves
// bound by shared-memory bandwidth (a warp's 16-byte load takes 4
// wavefronts: 8 loads a thread for 64 FMAs, twice what the SM feeds at
// the FMA rate); the rest in staging W and the rows from L2, the loss
// pass, the column sums and the row-grad stores.  Larger tiles leave
// too few threads at 48 rows: 8 x 8 with the depth split over lanes, and
// 8 x 4 or 4 x 8 on the two largest products, did not run faster.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "cp_async.cuh"
#include "epoch.cuh"
#include "tile.cuh"

constexpr int MLP_MAX_LAYERS = 4;
constexpr int MLP_MAX_TENSORS = 3 + 2 * MLP_MAX_LAYERS;
constexpr int MLP_MAX_DENSE = 1 + 2 * MLP_MAX_LAYERS;

// Shapes, the shared-memory layout (offsets and row strides in floats),
// the dense gradient's layout and the device pointers of one epoch.
// ops/train.py fills the same struct with ctypes; the two definitions must
// agree field for field.
struct MlpArgs {
  int L, dg, hm, tw, U, I, B, rows, blocks;
  // 1 where W_l, PU and QI may be staged with 16-byte copies: every n_out,
  // tw, dg and hm a multiple of 4 and the bases 16-byte aligned.
  int vec;
  int n_in[MLP_MAX_LAYERS], n_out[MLP_MAX_LAYERS], ld_w[MLP_MAX_LAYERS];
  int off_w[MLP_MAX_LAYERS], off_b[MLP_MAX_LAYERS], off_h;
  int off_x[MLP_MAX_LAYERS + 1], ld_x[MLP_MAX_LAYERS + 1];
  int off_ug, off_ig, off_d0, off_d1, ld_d, off_sum, ld_sum, off_row,
      smem_bytes;
  // Dense tensor k (W_0..W_{L-1}, b_0..b_{L-1}, h) starts at off_g[k] of a
  // block's slice of part; off_g[2 L + 1] is the slice's length.
  int off_g[MLP_MAX_DENSE + 1];
  float reg_g, reg_m;
  float* p[MLP_MAX_TENSORS];  // PU, QI, W_0..W_{L-1}, b_0..b_{L-1}, h
  float* m[MLP_MAX_TENSORS];  // their Adam moments, same order
  float* v[MLP_MAX_TENSORS];
  float* rg[2];               // [B, tw] w-scaled row grads, user and item
  // Per step s, the CSR of each side's ids: order[k] + s B the batch rows
  // sorted stably by id, seg[0] + s (U + 1) (seg[1] + s (I + 1)) where
  // each id's run of them starts.
  const int32_t* order[2];
  const int32_t* seg[2];
  float* part;                // [blocks, off_g[2 L + 1]]
  float* part_loss;           // [blocks] the blocks' summed losses
};

#ifdef MLP_CLOCKS
// tools/mlp_phases.py builds the kernel with -DMLP_CLOCKS: thread 0 of
// each block stamps clock64() at the end of each phase of mlp_rows (the
// last launch's stamps stay), and mlp_read_clocks copies them out.
constexpr int MLP_STAMPS = 24, MLP_STAMP_BLOCKS = 1024;
__device__ long long mlp_clocks[MLP_STAMP_BLOCKS][MLP_STAMPS];
#define STAMP()                                                      \
  if (threadIdx.x == 0 && blockIdx.x < MLP_STAMP_BLOCKS &&           \
      stamp < MLP_STAMPS)                                            \
  mlp_clocks[blockIdx.x][stamp++] = clock64()
#else
#define STAMP()
#endif

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

__device__ __forceinline__ void scale4(float* p, float s) {
  float4 v = ld4(p);
  v.x *= s;
  v.y *= s;
  v.z *= s;
  v.w *= s;
  *reinterpret_cast<float4*>(p) = v;
}

// emit(c, sum over rows r < R of f(r, c)) for every column c < C, summed
// in a fixed order: warp w adds rows w, w + WARPS, ... in turn (its lanes
// take the columns), then the warps' sums are added in warp order.  f may
// write the element it visits; each (r, c) is visited once.  Every thread
// calls it; it uses sum[WARPS][ld] (ld >= C) and barriers once, between
// the two sums, so the writes of f are visible on return.
template <typename F, typename E>
__device__ __forceinline__ void col_sums(float* sum, int ld, int R, int C,
                                         F f, E emit) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int c = lane; c < C; c += 32) {
    float s = 0.f;
    for (int r = warp; r < R; r += WARPS) s += f(r, c);
    sum[warp * ld + c] = s;
  }
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += THREADS) {
    float s = sum[c];
#pragma unroll
    for (int k = 1; k < WARPS; ++k) s += sum[k * ld + c];
    emit(c, s);
  }
}

__global__ void __launch_bounds__(THREADS, 1)
mlp_rows(const MlpArgs a, const int32_t* __restrict__ u_idx,
         const int32_t* __restrict__ i_idx, const float* __restrict__ y,
         const float* __restrict__ w) {
  extern __shared__ float4 sm4[];
  float* sm = reinterpret_cast<float*>(sm4);
  __shared__ float partial[WARPS];
  const int L = a.L, R = a.rows, dg = a.dg, hm = a.hm, tw = a.tw;
  const int r0 = blockIdx.x * R;
  const int nrow = min(R, a.B - r0);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int o_last = a.n_out[L - 1];
  float* h_s = sm + a.off_h;
  float* row_w = sm + a.off_row;
  float* row_y = row_w + R;
  float* row_dl = row_y + R;
  int* row_u = reinterpret_cast<int*>(row_dl + R);
  int* row_i = row_u + R;
  float* ug = sm + a.off_ug;
  float* ig = sm + a.off_ig;
  float* x0 = sm + a.off_x[0];
  const int ld0 = a.ld_x[0];
  float* sum = sm + a.off_sum;
  float* part = a.part + (size_t)blockIdx.x * a.off_g[2 * L + 1];
#ifdef MLP_CLOCKS
  int stamp = 0;
#endif
  STAMP();

  float ids_w = 0.f, ids_y = 0.f;
  int ids_u = -1, ids_i = -1;
  // The tile's rows' weights, labels and ids, a thread a row, stored once
  // the copies below are on their way.
  if (threadIdx.x < R) {
    const int r = threadIdx.x;
    const bool real = r < nrow;
    ids_w = real ? w[r0 + r] : 0.f;
    ids_y = real ? y[r0 + r] : 0.f;
    ids_u = real ? u_idx[r0 + r] : -1;
    ids_i = real ? i_idx[r0 + r] : -1;
  }
  // -- stage W_l, b_l and h zero-padded (cp.async: every copy in flight
  // at once; a size of 0 writes zeros), 16 bytes a copy where vec -------
  for (int l = 0; l < L; ++l) {
    const float* W = a.p[2 + l];
    const float* b = a.p[2 + L + l];
    float* W_s = sm + a.off_w[l];
    const int n_in = a.n_in[l], n_out = a.n_out[l], ld = a.ld_w[l];
    if (a.vec) {
      const int pieces = pad4(n_out) / 4;
      for (int e = threadIdx.x; e < pad4(n_in) * pieces; e += THREADS) {
        const int r = e / pieces, q = 4 * (e - r * pieces);
        const bool ok = r < n_in && q < n_out;
        cp16(W_s + r * ld + q, ok ? W + r * n_out + q : W, ok ? 16 : 0);
      }
    } else {
      for (int r = warp; r < pad4(n_in); r += WARPS)
        for (int c = lane; c < pad4(n_out); c += 32) {
          const bool ok = r < n_in && c < n_out;
          cp4(W_s + r * ld + c, ok ? W + r * n_out + c : W, ok ? 4 : 0);
        }
    }
    for (int k = threadIdx.x; k < pad4(n_out); k += THREADS)
      cp4(sm + a.off_b[l] + k, k < n_out ? b + k : b, k < n_out ? 4 : 0);
  }
  for (int c = threadIdx.x; c < dg + o_last; c += THREADS)
    cp4(h_s + c, a.p[2 + 2 * L] + c, 4);
  if (threadIdx.x < R) {
    row_w[threadIdx.x] = ids_w;
    row_y[threadIdx.x] = ids_y;
    row_u[threadIdx.x] = ids_u;
    row_i[threadIdx.x] = ids_i;
  }
  __syncthreads();
  STAMP();

  // -- gather the rows, a warp a row (an id outside its table reads a
  // zero row); once its copies have landed, each thread scales what it
  // copied by w: ug, ig and x_0 = [um | im] -----------------------------
  // pass(r, n, du, su, di, si): a piece of n floats (4 where vec, else 1)
  // of row r, bound for du and di, from su and si (null: the id is
  // outside its table).
  auto rows = [&](auto pass) {
    for (int r = warp; r < R; r += WARPS) {
      const int u = row_u[r], i = row_i[r];
      const float* pu = (unsigned)u < (unsigned)a.U ? a.p[0] + (size_t)u * tw : nullptr;
      const float* qi = (unsigned)i < (unsigned)a.I ? a.p[1] + (size_t)i * tw : nullptr;
      const int n = a.vec ? 4 : 1;
      for (int c = n * lane; c < tw; c += 32 * n)
        pass(r, n, c < dg ? ug + r * dg + c : x0 + r * ld0 + c - dg,
             pu ? pu + c : nullptr,
             c < dg ? ig + r * dg + c : x0 + r * ld0 + hm + c - dg,
             qi ? qi + c : nullptr);
    }
  };
  rows([&](int, int n, float* du, const float* su, float* di,
           const float* si) {
    if (n == 4) {
      cp16(du, su ? su : a.p[0], su ? 16 : 0);
      cp16(di, si ? si : a.p[1], si ? 16 : 0);
    } else {
      cp4(du, su ? su : a.p[0], su ? 4 : 0);
      cp4(di, si ? si : a.p[1], si ? 4 : 0);
    }
  });
  cp_commit();
  cp_wait<0>();
  rows([&](int r, int n, float* du, const float*, float* di, const float*) {
    const float wr = row_w[r];
    if (n == 4) {
      scale4(du, wr);
      scale4(di, wr);
    } else {
      *du *= wr;
      *di *= wr;
    }
  });
  for (int r = warp; r < R; r += WARPS)   // x_0's zero padding
    for (int c = 2 * hm + lane; c < pad4(2 * hm); c += 32) x0[r * ld0 + c] = 0.f;
  __syncthreads();
  STAMP();

  // -- forward: x_{l+1} = relu(x_l W_l + b_l), padding columns 0 --------
  for (int l = 0; l < L; ++l) {
    const float* b_s = sm + a.off_b[l];
    float* xn = sm + a.off_x[l + 1];
    const int ldn = a.ld_x[l + 1];
    gemm4<THREADS, true, false>(sm + a.off_x[l], a.ld_x[l], sm + a.off_w[l],
                       a.ld_w[l], R, pad4(a.n_out[l]), pad4(a.n_in[l]),
                       Rows{}, Rows{}, [&](int m, int n, int, const float (&v)[4]) {
                         const float4 bn = ld4(b_s + n);
                         *reinterpret_cast<float4*>(xn + m * ldn + n) = make_float4(
                             fmaxf(v[0] + bn.x, 0.f), fmaxf(v[1] + bn.y, 0.f),
                             fmaxf(v[2] + bn.z, 0.f), fmaxf(v[3] + bn.w, 0.f));
                       });
    __syncthreads();
    STAMP();
  }

  // -- logits, loss and dl: 8 lanes a row, 4 rows a warp at a time (R is
  // a multiple of 16) ----------------------------------------------------
  const float* xL = sm + a.off_x[L];
  const int ldL = a.ld_x[L];
  const int sl = lane & 7;
  float warp_loss = 0.f;
  for (int rw = 4 * warp; rw < R; rw += 4 * WARPS) {
    const int r = rw + (lane >> 3);
    float logit = 0.f, ng = 0.f, nm = 0.f;
    for (int c = sl; c < dg; c += 8) {
      const float gu = ug[r * dg + c], gi = ig[r * dg + c];
      logit = fmaf(gu * gi, h_s[c], logit);
      ng = fmaf(gu, gu, fmaf(gi, gi, ng));
    }
    for (int k = sl; k < o_last; k += 8)
      logit = fmaf(xL[r * ldL + k], h_s[dg + k], logit);
    for (int c = sl; c < 2 * hm; c += 8) {
      const float xm = x0[r * ld0 + c];
      nm = fmaf(xm, xm, nm);
    }
#pragma unroll
    for (int off = 4; off > 0; off >>= 1) {
      logit += __shfl_xor_sync(0xffffffffu, logit, off);
      ng += __shfl_xor_sync(0xffffffffu, ng, off);
      nm += __shfl_xor_sync(0xffffffffu, nm, off);
    }
    if (sl == 0) {
      const float wr = row_w[r], yr = row_y[r];
      const float bce = fmaxf(logit, 0.f) - logit * yr + log1pf(expf(-fabsf(logit)));
      warp_loss += wr * bce + 0.5f * a.reg_g * ng + 0.5f * a.reg_m * nm;
      row_dl[r] = wr * (1.f / (1.f + expf(-logit)) - yr);
    }
  }
  warp_loss = warp_sum(warp_loss);
  if (lane == 0) partial[warp] = warp_loss;
  __syncthreads();
  STAMP();

  // -- dh = sum_r dl z; da_{L-1} = dl h[dg:] where x_L > 0, and its db ---
  float* cur = sm + a.off_d0;
  float* nxt = sm + a.off_d1;
  const int ldd = a.ld_d, nh = dg + o_last;
  col_sums(sum, a.ld_sum, R, nh + pad4(o_last),
           [&](int r, int c) {
             if (c < dg) return row_dl[r] * (ug[r * dg + c] * ig[r * dg + c]);
             if (c < nh) return row_dl[r] * xL[r * ldL + c - dg];
             const int k = c - nh;   // padding columns (k >= o_last) get 0
             const float d = xL[r * ldL + k] > 0.f ? row_dl[r] * h_s[dg + k] : 0.f;
             cur[r * ldd + k] = d;
             return d;
           },
           [&](int c, float s) {
             if (c < nh) part[a.off_g[2 * L] + c] = s;
             else if (c - nh < o_last) part[a.off_g[2 * L - 1] + c - nh] = s;
           });
  STAMP();

  // -- backward through the tower --------------------------------------
  for (int l = L - 1; l >= 0; --l) {
    const int n_in = a.n_in[l], n_out = a.n_out[l];
    float* gW = part + a.off_g[l];
    // dW_l = x_l^T da_l, straight into the block's slice.
    // (float4 stores where vec: n_out % 4 == 0, so every slice offset is
    // 16-byte aligned)
    gemm4<THREADS, false, false>(sm + a.off_x[l], a.ld_x[l], cur, ldd, pad4(n_in),
                        pad4(n_out), R, Rows{}, Rows{},
                        [&](int m, int n, int, const float (&v)[4]) {
                          if (m >= n_in) return;
                          if (a.vec) {
                            *reinterpret_cast<float4*>(gW + m * n_out + n) =
                                make_float4(v[0], v[1], v[2], v[3]);
                            return;
                          }
                          for (int j = 0; j < 4 && n + j < n_out; ++j)
                            gW[m * n_out + n + j] = v[j];
                        });
#ifdef MLP_CLOCKS
    __syncthreads();
    STAMP();
#endif
    // dx_l = da_l W_l^T; W's zero padding leaves its padding columns 0.
    gemm4<THREADS, true, true>(cur, ldd, sm + a.off_w[l], a.ld_w[l], R, pad4(n_in),
                      pad4(n_out), Rows{}, Rows{},
                      [&](int m, int n, int dn, const float (&v)[4]) {
#pragma unroll
                        for (int j = 0; j < 4; ++j) nxt[m * ldd + n + dn * j] = v[j];
                      });
    __syncthreads();
    STAMP();
    if (l > 0) {   // da_{l-1} in place, and db_{l-1}
      const float* xl = sm + a.off_x[l];
      const int ldl = a.ld_x[l];
      float* gb = part + a.off_g[L + l - 1];
      col_sums(sum, a.ld_sum, R, n_in,
               [&](int r, int c) {
                 const float d = xl[r * ldl + c] > 0.f ? nxt[r * ldd + c] : 0.f;
                 nxt[r * ldd + c] = d;
                 return d;
               },
               [&](int c, float s) { gb[c] = s; });
      STAMP();
    }
    float* t = cur;
    cur = nxt;
    nxt = t;
  }

  // -- row grads into the step's rows of rg, a warp a row; a masked row
  // (w = 0) stores zeros, so its id's sum is unchanged ------------------
  for (int r = warp; r < nrow; r += WARPS) {
    const float wr = row_w[r];
    const float dl = row_dl[r];
    float* rg_u = a.rg[0] + (size_t)(r0 + r) * tw;
    float* rg_i = a.rg[1] + (size_t)(r0 + r) * tw;
    // w times the gradient of column c of the user and the item row.
    auto grads = [&](int c, float& dp, float& dq) {
      if (wr == 0.f) {
        dp = dq = 0.f;
      } else if (c < dg) {
        const float dz = dl * h_s[c];
        const float gu = ug[r * dg + c], gi = ig[r * dg + c];
        dp = wr * (dz * gi + a.reg_g * gu);
        dq = wr * (dz * gu + a.reg_g * gi);
      } else {
        const int cm = c - dg;
        dp = wr * (cur[r * ldd + cm] + a.reg_m * x0[r * ld0 + cm]);
        dq = wr * (cur[r * ldd + hm + cm] + a.reg_m * x0[r * ld0 + hm + cm]);
      }
    };
    if (a.vec) {   // one float4 a lane and row side
      for (int c = 4 * lane; c < tw; c += 128) {
        float dp[4], dq[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) grads(c + e, dp[e], dq[e]);
        *reinterpret_cast<float4*>(rg_u + c) = make_float4(dp[0], dp[1], dp[2], dp[3]);
        *reinterpret_cast<float4*>(rg_i + c) = make_float4(dq[0], dq[1], dq[2], dq[3]);
      }
    } else {
      for (int c = lane; c < tw; c += 32) grads(c, rg_u[c], rg_i[c]);
    }
  }
  if (threadIdx.x == 0) {
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < WARPS; ++k) s += partial[k];
    a.part_loss[blockIdx.x] = s;
  }
#ifdef MLP_CLOCKS
  __syncthreads();
  STAMP();
#endif
}

// One Adam step over every parameter.  Blocks [0, dense_blocks) take 32
// dense elements each: an element's gradient is the sum of the blocks'
// slices of part, warp w adding those of blocks [w per, (w + 1) per) in
// turn and warp 0 the warps' sums in warp order.  The other blocks walk
// PU and QI with a grid stride; a table element's gradient is the sum of
// its column of the rows of rg that step ``step``'s CSR lists for its id,
// in batch order (0 for an id not in the step).  Thread 0 also writes the
// step's loss, the blocks' losses summed in block order.
__global__ void __launch_bounds__(THREADS)
mlp_adam(const MlpArgs a, AdamStep s, int dense_blocks, int step,
         float* loss) {
  __shared__ float sums[WARPS][32];
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    float t = 0.f;
    for (int b = 0; b < a.blocks; ++b) t += a.part_loss[b];
    *loss = t;
  }
  const int n_dense = a.off_g[2 * a.L + 1];
  if ((int)blockIdx.x < dense_blocks) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int e = blockIdx.x * 32 + lane;
    const int per = (a.blocks + WARPS - 1) / WARPS;
    const int first = warp * per, last = min(a.blocks, first + per);
    float g = 0.f;
    if (e < n_dense)
      for (int b = first; b < last; ++b) g += a.part[(size_t)b * n_dense + e];
    sums[warp][lane] = g;
    __syncthreads();
    if (warp != 0 || e >= n_dense) return;
#pragma unroll
    for (int k = 1; k < WARPS; ++k) g += sums[k][lane];
    int t = 0;
    while (e >= a.off_g[t + 1]) ++t;
    const int j = e - a.off_g[t];
    adam_elem(a.p[2 + t] + j, a.m[2 + t] + j, a.v[2 + t] + j, g, s);
    return;
  }
  const int64_t nu = (int64_t)a.U * a.tw, n = nu + (int64_t)a.I * a.tw;
  const int64_t stride = (int64_t)(gridDim.x - dense_blocks) * THREADS;
  for (int64_t e = (int64_t)(blockIdx.x - dense_blocks) * THREADS + threadIdx.x;
       e < n; e += stride) {
    const int k = e < nu ? 0 : 1;
    const int64_t j = k ? e - nu : e;
    const int id = (int)(j / a.tw), c = (int)(j - (int64_t)id * a.tw);
    const int32_t* seg = a.seg[k] + (size_t)step * ((k ? a.I : a.U) + 1);
    const int32_t* order = a.order[k] + (size_t)step * a.B;
    const float* rg = a.rg[k] + c;
    // Four rows' loads in flight at a time (a popular id has tens of rows
    // a step), added one by one in batch order.
    float g = 0.f;
    int q = seg[id];
    const int q_end = seg[id + 1];
    for (; q + 4 <= q_end; q += 4) {
      const int32_t o0 = order[q], o1 = order[q + 1], o2 = order[q + 2],
                    o3 = order[q + 3];
      const float g0 = rg[(size_t)o0 * a.tw], g1 = rg[(size_t)o1 * a.tw],
                  g2 = rg[(size_t)o2 * a.tw], g3 = rg[(size_t)o3 * a.tw];
      g += g0;
      g += g1;
      g += g2;
      g += g3;
    }
    for (; q < q_end; ++q) g += rg[(size_t)order[q] * a.tw];
    adam_elem(a.p[k] + j, a.m[k] + j, a.v[k] + j, g, s);
  }
}

}  // namespace

// ``args`` is a host pointer to the epoch's MlpArgs.  The tensors of
// args->p and their moments are updated in place; args->rg and args->part
// need no initial value, nor does args->part_loss; args->order and
// args->seg hold each step's CSR of u and i.  u, i are [steps, B] int32, y
// and w [steps, B] f32; loss [steps] receives each step's summed loss.  b1
// and b2 come as doubles (epoch.cuh).  Returns 0, or the cudaError_t of
// the first call that failed.
extern "C" int mlp_epoch(const MlpArgs* args, const int32_t* u_idx,
                         const int32_t* i_idx, const float* y, const float* w,
                         float* loss, int steps, int t0, float lr, double b1,
                         double b2, float eps, cudaStream_t stream) {
  const MlpArgs a = *args;
  if (a.L < 1 || a.L > MLP_MAX_LAYERS || a.rows < 16 || a.rows % 16 != 0 ||
      a.rows > THREADS || a.blocks != (a.B + a.rows - 1) / a.rows)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      mlp_rows, cudaFuncAttributeMaxDynamicSharedMemorySize, a.smem_bytes);
  if (err != cudaSuccess) return (int)err;
  const int dense_blocks = (a.off_g[2 * a.L + 1] + 31) / 32;
  const int64_t tab = ((int64_t)a.U + a.I) * a.tw;
  const int64_t want = (tab + THREADS - 1) / THREADS;
  const int tab_blocks = (int)(want < 65535 ? want : 65535);
  for (int s = 0; s < steps; ++s) {
    if (a.B > 0) {
      const size_t off = (size_t)s * a.B;
      mlp_rows<<<a.blocks, THREADS, a.smem_bytes, stream>>>(
          a, u_idx + off, i_idx + off, y + off, w + off);
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
    mlp_adam<<<dense_blocks + tab_blocks, THREADS, 0, stream>>>(
        a, adam_step(t0 + s + 1, lr, b1, b2, eps), dense_blocks, s, loss + s);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

#ifdef MLP_CLOCKS
// The phase stamps of mlp_rows' last launch: [1024 blocks][24] clock64()
// values into host memory ``out``; returns 0 or a cudaError_t.
extern "C" int mlp_read_clocks(long long* out) {
  return (int)cudaMemcpyFromSymbol(out, mlp_clocks, sizeof(mlp_clocks));
}
#endif
