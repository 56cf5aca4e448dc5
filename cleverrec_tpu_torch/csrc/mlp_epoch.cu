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
// at step t0 + s + 1 (epoch.cuh).
//
// Design, two launches a step:
//
//   mlp_rows   one block of 256 threads takes a tile of R rows (32, or
//              fewer where shared memory is short).  It stages W, b and h
//              in dynamic shared memory (rows of W padded to an odd
//              stride, so that W^T reads miss no bank), gathers the tile's
//              rows, and runs the forward and backward products from
//              shared memory on the CUDA cores, each thread a 2x4 or 4x4
//              register tile of the output.  dW, db and dh leave the block
//              with one atomic per element; row grads go to the table
//              scratch by atomicAdd.
//   adam_dense one pass over every tensor and its moments (epoch.cuh).
//
// What bounds it on an H100: the tower's FP32 products, ~6 sum(in out)
// operations a row forward and backward (64.5k at [128, 64, 32]), on the
// CUDA cores; this first kernel also pays for staging the weights per
// tile, for bank-limited shared-memory reads, and for the dW atomics of
// every block.  f32 atomics sum in a run-dependent order: results match
// the plain version to a tolerance, not bit for bit.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "epoch.cuh"

constexpr int MLP_MAX_LAYERS = 4;
constexpr int MLP_MAX_TENSORS = 3 + 2 * MLP_MAX_LAYERS;

// Shapes, the shared-memory layout (offsets in floats) and the device
// pointers of one epoch.  ops/train.py fills the same struct with ctypes;
// the two definitions must agree field for field.
struct MlpArgs {
  int L, dg, hm, tw, U, I, B, rows;
  int n_in[MLP_MAX_LAYERS], n_out[MLP_MAX_LAYERS], ld_w[MLP_MAX_LAYERS];
  int off_w[MLP_MAX_LAYERS], off_b[MLP_MAX_LAYERS], off_h;
  int off_x[MLP_MAX_LAYERS + 1], ld_x[MLP_MAX_LAYERS + 1];
  int off_ug, off_ig, off_d0, off_d1, ld_d, off_row, smem_bytes;
  float reg_g, reg_m;
  float* p[MLP_MAX_TENSORS];  // PU, QI, W_0..W_{L-1}, b_0..b_{L-1}, h
  float* g[MLP_MAX_TENSORS];  // their gradient scratch, same order
};

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

// C[M, N] = op(A)[M, K] op(B)[K, N] from shared memory, handed to
// epi(i, j, c) element by element.  Element (i, k) of A is
// A[i a_i + k a_k], element (k, j) of B is B[k b_k + j b_j].  Each thread
// owns a TM x TN tile of rows i = ti + mi tm and columns j = tj + nj tn:
// neighbouring threads take neighbouring columns.
template <int TM, int TN, typename Epi>
__device__ __forceinline__ void block_gemm(const float* A, int a_i, int a_k,
                                           const float* B, int b_k, int b_j,
                                           int M, int N, int K, Epi epi) {
  const int tm = (M + TM - 1) / TM, tn = (N + TN - 1) / TN;
  for (int t = threadIdx.x; t < tm * tn; t += blockDim.x) {
    const int ti = t / tn, tj = t % tn;
    float acc[TM][TN];
#pragma unroll
    for (int mi = 0; mi < TM; ++mi)
#pragma unroll
      for (int nj = 0; nj < TN; ++nj) acc[mi][nj] = 0.f;
    for (int k = 0; k < K; ++k) {
      float av[TM], bv[TN];
#pragma unroll
      for (int mi = 0; mi < TM; ++mi) {
        const int i = ti + mi * tm;
        av[mi] = i < M ? A[i * a_i + k * a_k] : 0.f;
      }
#pragma unroll
      for (int nj = 0; nj < TN; ++nj) {
        const int j = tj + nj * tn;
        bv[nj] = j < N ? B[k * b_k + j * b_j] : 0.f;
      }
#pragma unroll
      for (int mi = 0; mi < TM; ++mi)
#pragma unroll
        for (int nj = 0; nj < TN; ++nj)
          acc[mi][nj] = fmaf(av[mi], bv[nj], acc[mi][nj]);
    }
#pragma unroll
    for (int mi = 0; mi < TM; ++mi)
#pragma unroll
      for (int nj = 0; nj < TN; ++nj) {
        const int i = ti + mi * tm, j = tj + nj * tn;
        if (i < M && j < N) epi(i, j, acc[mi][nj]);
      }
  }
}

__global__ void __launch_bounds__(THREADS)
mlp_rows(const MlpArgs a, const int32_t* __restrict__ u_idx,
         const int32_t* __restrict__ i_idx, const float* __restrict__ y,
         const float* __restrict__ w, float* __restrict__ loss) {
  extern __shared__ float sm[];
  __shared__ float partial[WARPS];
  const int L = a.L, R = a.rows, dg = a.dg, hm = a.hm, tw = a.tw;
  const int r0 = blockIdx.x * R;
  const int nrow = min(R, a.B - r0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
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

  // -- stage the dense params and the tile's per-row scalars ----------
  for (int l = 0; l < L; ++l) {
    const float* W = a.p[2 + l];
    float* W_s = sm + a.off_w[l];
    const int n_out = a.n_out[l], ld = a.ld_w[l];
    for (int e = tid; e < a.n_in[l] * n_out; e += THREADS)
      W_s[(e / n_out) * ld + e % n_out] = W[e];
    for (int k = tid; k < n_out; k += THREADS)
      sm[a.off_b[l] + k] = a.p[2 + L + l][k];
  }
  for (int c = tid; c < dg + o_last; c += THREADS) h_s[c] = a.p[2 + 2 * L][c];
  for (int r = tid; r < R; r += THREADS) {
    const bool real = r < nrow;
    row_w[r] = real ? w[r0 + r] : 0.f;
    row_y[r] = real ? y[r0 + r] : 0.f;
    row_u[r] = real ? u_idx[r0 + r] : -1;
    row_i[r] = real ? i_idx[r0 + r] : -1;
  }
  __syncthreads();

  // -- gather the w-scaled rows: ug, ig and x_0 = [um | im] ------------
  const float* PU = a.p[0];
  const float* QI = a.p[1];
  for (int e = tid; e < R * tw; e += THREADS) {
    const int r = e / tw, c = e % tw;
    const int u = row_u[r], i = row_i[r];
    const float wr = row_w[r];
    const float pe = (unsigned)u < (unsigned)a.U ? PU[(size_t)u * tw + c] * wr : 0.f;
    const float qe = (unsigned)i < (unsigned)a.I ? QI[(size_t)i * tw + c] * wr : 0.f;
    if (c < dg) {
      ug[r * dg + c] = pe;
      ig[r * dg + c] = qe;
    } else {
      x0[r * ld0 + (c - dg)] = pe;
      x0[r * ld0 + hm + (c - dg)] = qe;
    }
  }
  __syncthreads();

  // -- forward: x_{l+1} = relu(x_l W_l + b_l) -------------------------
  for (int l = 0; l < L; ++l) {
    const float* b_s = sm + a.off_b[l];
    float* xn = sm + a.off_x[l + 1];
    const int ldn = a.ld_x[l + 1];
    block_gemm<2, 4>(sm + a.off_x[l], a.ld_x[l], 1, sm + a.off_w[l], a.ld_w[l],
                     1, R, a.n_out[l], a.n_in[l],
                     [&](int i, int j, float c) {
                       xn[i * ldn + j] = fmaxf(c + b_s[j], 0.f);
                     });
    __syncthreads();
  }

  // -- logits, loss and dl, one warp per row ---------------------------
  const float* xL = sm + a.off_x[L];
  const int ldL = a.ld_x[L];
  float warp_loss = 0.f;
  for (int r = warp; r < R; r += WARPS) {
    float logit = 0.f, ng = 0.f, nm = 0.f;
    for (int c = lane; c < dg; c += 32) {
      const float gu = ug[r * dg + c], gi = ig[r * dg + c];
      logit = fmaf(gu * gi, h_s[c], logit);
      ng = fmaf(gu, gu, fmaf(gi, gi, ng));
    }
    for (int k = lane; k < o_last; k += 32)
      logit = fmaf(xL[r * ldL + k], h_s[dg + k], logit);
    for (int c = lane; c < 2 * hm; c += 32) {
      const float xm = x0[r * ld0 + c];
      nm = fmaf(xm, xm, nm);
    }
    logit = warp_sum(logit);
    ng = warp_sum(ng);
    nm = warp_sum(nm);
    const float wr = row_w[r], yr = row_y[r];
    const float bce = fmaxf(logit, 0.f) - logit * yr + log1pf(expf(-fabsf(logit)));
    warp_loss += wr * bce + 0.5f * a.reg_g * ng + 0.5f * a.reg_m * nm;
    if (lane == 0) row_dl[r] = wr * (1.f / (1.f + expf(-logit)) - yr);
  }
  if (lane == 0) partial[warp] = warp_loss;
  __syncthreads();

  // -- dh = sum_r dl z, and dx_L = dl h[dg:] ---------------------------
  float* g_h = a.g[2 + 2 * L];
  for (int c = tid; c < dg + o_last; c += THREADS) {
    float s = 0.f;
    for (int r = 0; r < R; ++r) {
      const float z = c < dg ? ug[r * dg + c] * ig[r * dg + c]
                             : xL[r * ldL + (c - dg)];
      s = fmaf(row_dl[r], z, s);
    }
    atomicAdd(g_h + c, s);
  }
  float* cur = sm + a.off_d0;
  float* nxt = sm + a.off_d1;
  const int ldd = a.ld_d;
  for (int e = tid; e < R * o_last; e += THREADS) {
    const int r = e / o_last, k = e % o_last;
    cur[r * ldd + k] = row_dl[r] * h_s[dg + k];
  }
  __syncthreads();

  // -- backward through the tower --------------------------------------
  for (int l = L - 1; l >= 0; --l) {
    const int n_in = a.n_in[l], n_out = a.n_out[l];
    const float* xo = sm + a.off_x[l + 1];
    const int ldo = a.ld_x[l + 1];
    for (int e = tid; e < R * n_out; e += THREADS) {   // da_l, in place
      const int r = e / n_out, k = e % n_out;
      if (!(xo[r * ldo + k] > 0.f)) cur[r * ldd + k] = 0.f;
    }
    __syncthreads();
    float* g_b = a.g[2 + L + l];
    for (int k = tid; k < n_out; k += THREADS) {
      float s = 0.f;
      for (int r = 0; r < R; ++r) s += cur[r * ldd + k];
      atomicAdd(g_b + k, s);
    }
    float* g_W = a.g[2 + l];
    block_gemm<4, 4>(sm + a.off_x[l], 1, a.ld_x[l], cur, ldd, 1, n_in, n_out,
                     R, [&](int i, int j, float c) {
                       atomicAdd(g_W + i * n_out + j, c);
                     });
    block_gemm<2, 4>(cur, ldd, 1, sm + a.off_w[l], 1, a.ld_w[l], R, n_in,
                     n_out, [&](int i, int j, float c) {
                       nxt[i * ldd + j] = c;
                     });
    __syncthreads();
    float* t = cur;
    cur = nxt;
    nxt = t;
  }

  // -- row grads to the table scratch ----------------------------------
  float* g_pu = a.g[0];
  float* g_qi = a.g[1];
  for (int e = tid; e < R * tw; e += THREADS) {
    const int r = e / tw, c = e % tw;
    const float wr = row_w[r];
    if (wr == 0.f) continue;
    float dp, dq;
    if (c < dg) {
      const float dz = row_dl[r] * h_s[c];
      const float gu = ug[r * dg + c], gi = ig[r * dg + c];
      dp = dz * gi + a.reg_g * gu;
      dq = dz * gu + a.reg_g * gi;
    } else {
      const int cm = c - dg;
      dp = cur[r * ldd + cm] + a.reg_m * x0[r * ld0 + cm];
      dq = cur[r * ldd + hm + cm] + a.reg_m * x0[r * ld0 + hm + cm];
    }
    const int u = row_u[r], i = row_i[r];
    if ((unsigned)u < (unsigned)a.U) atomicAdd(g_pu + (size_t)u * tw + c, wr * dp);
    if ((unsigned)i < (unsigned)a.I) atomicAdd(g_qi + (size_t)i * tw + c, wr * dq);
  }
  if (tid == 0) {
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < WARPS; ++k) s += partial[k];
    atomicAdd(loss, s);
  }
}

}  // namespace

// ``args`` is a host pointer to the epoch's MlpArgs; m and v are host
// arrays of the device pointers of the moments, in the order of args->p.
// The tensors of args->p and the moments are updated in place; the
// gradient scratch of args->g is zero on entry and on return.  u, i are
// [steps, B] int32, y and w [steps, B] f32; loss [steps] is zeroed and
// receives each step's summed loss.  b1 and b2 come as doubles
// (epoch.cuh).  Returns 0, or the cudaError_t of the first call that
// failed.
extern "C" int mlp_epoch(const MlpArgs* args, float* const* m, float* const* v,
                         const int32_t* u_idx, const int32_t* i_idx,
                         const float* y, const float* w, float* loss,
                         int steps, int t0, float lr, double b1, double b2,
                         float eps, cudaStream_t stream) {
  const MlpArgs a = *args;
  if (a.L < 1 || a.L > MLP_MAX_LAYERS || a.rows < 1)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      mlp_rows, cudaFuncAttributeMaxDynamicSharedMemorySize, a.smem_bytes);
  if (err != cudaSuccess) return (int)err;
  AdamSegs segs = {};
  adam_add(segs, a.p[0], m[0], v[0], a.g[0], (int64_t)a.U * a.tw);
  adam_add(segs, a.p[1], m[1], v[1], a.g[1], (int64_t)a.I * a.tw);
  for (int l = 0; l < a.L; ++l)
    adam_add(segs, a.p[2 + l], m[2 + l], v[2 + l], a.g[2 + l],
             (int64_t)a.n_in[l] * a.n_out[l]);
  for (int l = 0; l < a.L; ++l)
    adam_add(segs, a.p[2 + a.L + l], m[2 + a.L + l], v[2 + a.L + l],
             a.g[2 + a.L + l], a.n_out[l]);
  const int hk = 2 + 2 * a.L;
  adam_add(segs, a.p[hk], m[hk], v[hk], a.g[hk], a.dg + a.n_out[a.L - 1]);
  const int blocks = (a.B + a.rows - 1) / a.rows;
  for (int s = 0; s < steps; ++s) {
    if (a.B > 0) {
      const size_t off = (size_t)s * a.B;
      mlp_rows<<<blocks, THREADS, a.smem_bytes, stream>>>(
          a, u_idx + off, i_idx + off, y + off, w + off, loss + s);
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
    const int aerr = adam_launch(segs, t0 + s + 1, lr, b1, b2, eps, stream);
    if (aerr != 0) return aerr;
  }
  return 0;
}
