// What the epoch kernels (bpr_epoch.cu, gmf_epoch.cu, mlp_epoch.cu,
// rows_epoch.cu, cml_epoch.cu) share: a warp's shuffle sum and max, and
// dense Adam over a list of f32 tensors, or one element at a time inside
// a kernel of their own (cml_epoch.cu fuses it with its regulariser).
//
// The TPU epoch kernels apply optax's Adam (b1, b2, eps) to every element
// of every resident parameter after each step (_adam_apply of
// cleverrec_tpu/ops/pallas_train.py), untouched rows included.  Here one
// grid-stride pass walks the segments in turn: each element reads its
// gradient from the scratch, updates its two moments and the parameter,
// and zeroes the gradient for the next step.  The bias corrections are
// 1 - exp(t log b) in f32, with log b rounded to f32 once, as the TPU
// kernels compute them.  The pass is bound by memory traffic (5 f32 reads
// and 4 writes an element); at the ml-100k shapes the state stays in L2.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int ADAM_THREADS = 256;
constexpr int ADAM_MAX_SEGS = 12;

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

// Adam's constants at one step: b1, 1 - b1, b2, 1 - b2 and the bias
// corrections, each rounded to f32 once.
struct AdamStep {
  float lr, b1, c1, b2, c2, eps, bc1, bc2;
};

// One element of Adam: reads g, updates m, v and p in place.
__device__ __forceinline__ void adam_elem(float* p, float* m, float* v,
                                          float g, const AdamStep& a) {
  const float mk = a.b1 * *m + a.c1 * g;
  const float vk = a.b2 * *v + a.c2 * (g * g);
  *m = mk;
  *v = vk;
  *p = *p - a.lr * (mk / a.bc1) / (sqrtf(vk / a.bc2) + a.eps);
}

// b1 and b2 come as doubles so that log b and 1 - b round to f32 once,
// as in the JAX kernels.
inline AdamStep adam_step(int t, float lr, double b1, double b2, float eps) {
  const float t32 = (float)t;
  return {lr, (float)b1, (float)(1.0 - b1), (float)b2, (float)(1.0 - b2), eps,
          1.f - expf(t32 * (float)log(b1)), 1.f - expf(t32 * (float)log(b2))};
}

struct AdamSegs {
  float* p[ADAM_MAX_SEGS];
  float* m[ADAM_MAX_SEGS];
  float* v[ADAM_MAX_SEGS];
  float* g[ADAM_MAX_SEGS];
  int64_t n[ADAM_MAX_SEGS];
  int count;
};

__global__ void __launch_bounds__(ADAM_THREADS)
adam_dense(AdamSegs s, AdamStep a) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t first = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  for (int k = 0; k < s.count; ++k) {
    float* __restrict__ p = s.p[k];
    float* __restrict__ m = s.m[k];
    float* __restrict__ v = s.v[k];
    float* __restrict__ g = s.g[k];
    for (int64_t e = first; e < s.n[k]; e += stride) {
      adam_elem(p + e, m + e, v + e, g[e], a);
      g[e] = 0.f;
    }
  }
}

// Appends a tensor of n elements, its moments and its gradient scratch.
inline void adam_add(AdamSegs& s, float* p, float* m, float* v, float* g,
                     int64_t n) {
  s.p[s.count] = p;
  s.m[s.count] = m;
  s.v[s.count] = v;
  s.g[s.count] = g;
  s.n[s.count] = n;
  ++s.count;
}

// Launches one Adam pass at step t on ``stream``; returns the launch's
// cudaError_t.
inline int adam_launch(const AdamSegs& s, int t, float lr, double b1,
                       double b2, float eps, cudaStream_t stream) {
  int64_t longest = 0;
  for (int k = 0; k < s.count; ++k) longest = s.n[k] > longest ? s.n[k] : longest;
  if (longest == 0) return 0;
  const int64_t want = (longest + ADAM_THREADS - 1) / ADAM_THREADS;
  const int blocks = (int)(want < 65535 ? want : 65535);
  adam_dense<<<blocks, ADAM_THREADS, 0, stream>>>(
      s, adam_step(t, lr, b1, b2, eps));
  return (int)cudaGetLastError();
}

}  // namespace
