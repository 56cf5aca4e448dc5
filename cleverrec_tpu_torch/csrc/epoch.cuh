// What the epoch kernels (bpr_epoch.cu, gmf_epoch.cu, mlp_epoch.cu,
// rows_epoch.cu, cml_epoch.cu) share: a warp's shuffle sum and max, and
// dense Adam: on one element (adam_elem in memory, adam_val in registers,
// which cml_epoch.cu fuses with its regulariser and mlp_epoch.cu with the
// sum of its blocks' dense gradients) or four (adam4); adam_tables, a
// grid-stride pass over a list of tables inside the persistent BPR and GMF
// kernels; and adam_slices, a kernel of its own for rows_epoch.cu, whose
// dense gradients are summed from per-block slices.
//
// The TPU epoch kernels apply optax's Adam (b1, b2, eps) to every element
// of every resident parameter after each step (_adam_apply of
// cleverrec_tpu/ops/pallas_train.py), untouched rows included.  Here each
// element reads its gradient from the scratch, updates its two moments
// and the parameter, and zeroes the gradient for the next step.  The bias
// corrections are 1 - exp(t log b) in f32, with log b rounded to f32 once,
// as the TPU kernels compute them: adam_step computes them on the host for
// the kernels launched a step at a time; the persistent kernels read them
// from their wrapper's table (persist.cuh's step_at).  A pass over tables
// in device memory is bound by memory traffic (5 f32 reads and 4 writes an
// element); at the ml-100k shapes the state stays in L2.

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

// Appends a tensor of n elements, its moments and its gradient scratch.
__host__ __device__ inline void adam_add(AdamSegs& s, float* p, float* m, float* v, float* g,
                     int64_t n) {
  s.p[s.count] = p;
  s.m[s.count] = m;
  s.v[s.count] = v;
  s.g[s.count] = g;
  s.n[s.count] = n;
  ++s.count;
}

// Adam on one element held in registers (adam_elem's arithmetic).
__device__ __forceinline__ void adam_val(float& p, float& m, float& v, float g,
                                         const AdamStep& a) {
  m = a.b1 * m + a.c1 * g;
  v = a.b2 * v + a.c2 * (g * g);
  p = p - a.lr * (m / a.bc1) / (sqrtf(v / a.bc2) + a.eps);
}

// Four elements of a table at once: 16-byte loads and stores of p, m, v
// and g, g zeroed.
__device__ __forceinline__ void adam4(float* p, float* m, float* v, float* g,
                                      const AdamStep& a) {
  float4 pv = *reinterpret_cast<float4*>(p);
  float4 mv = *reinterpret_cast<float4*>(m);
  float4 vv = *reinterpret_cast<float4*>(v);
  const float4 gv = *reinterpret_cast<const float4*>(g);
  adam_val(pv.x, mv.x, vv.x, gv.x, a);
  adam_val(pv.y, mv.y, vv.y, gv.y, a);
  adam_val(pv.z, mv.z, vv.z, gv.z, a);
  adam_val(pv.w, mv.w, vv.w, gv.w, a);
  *reinterpret_cast<float4*>(p) = pv;
  *reinterpret_cast<float4*>(m) = mv;
  *reinterpret_cast<float4*>(v) = vv;
  *reinterpret_cast<float4*>(g) = make_float4(0.f, 0.f, 0.f, 0.f);
}

constexpr int ADAM_MAX_DENSE = 2;

// One Adam step of the rows kernels.  tab: the tables, whose gradients
// sit in their scratch.  part [blocks, slice]: each block of the row
// kernel stores its sums there, the gradients of the dense tensors
// p[0..count) one after the other, then its loss in the slice's last
// element.
struct AdamSlices {
  AdamSegs tab;
  float* p[ADAM_MAX_DENSE];
  float* m[ADAM_MAX_DENSE];
  float* v[ADAM_MAX_DENSE];
  int n[ADAM_MAX_DENSE];
  int count;
  const float* part;
  int slice, blocks;
  // Set by adam_slices_launch: slice elements a summing block, and
  // whether a table's p, m, v and g are all 16-byte aligned.
  int epb;
  bool vec[ADAM_MAX_SEGS];
};

// Adam over the tables of ``tab`` as one run of units, unit e for e =
// first, first + stride, ...: a segment's float4s where vec[k] (its four
// pointers 16-byte aligned), then its remaining elements one by one, so
// that every unit is in flight at once; the gradients are zeroed.
__device__ __forceinline__ void adam_tables(const AdamSegs& tab,
                                            const bool (&vec)[ADAM_MAX_SEGS],
                                            const AdamStep& a, int64_t first,
                                            int64_t stride) {
  for (int64_t e = first;; e += stride) {
    int k = 0;
    int64_t j = e, n4 = 0;
    for (; k < tab.count; ++k) {
      n4 = vec[k] ? tab.n[k] / 4 : 0;
      const int64_t units = tab.n[k] - 3 * n4;
      if (j < units) break;
      j -= units;
    }
    if (k == tab.count) return;
    float* p = tab.p[k];
    float* m = tab.m[k];
    float* v = tab.v[k];
    float* g = tab.g[k];
    if (j < n4) {
      adam4(p + 4 * j, m + 4 * j, v + 4 * j, g + 4 * j, a);
    } else {
      j += 3 * n4;
      adam_elem(p + j, m + j, v + j, g[j], a);
      g[j] = 0.f;
    }
  }
}

// Sets vec[k] for each table of ``tab`` (its p, m, v and g 16-byte
// aligned) and returns adam_tables' count of units.
inline int64_t adam_units(const AdamSegs& tab, bool (&vec)[ADAM_MAX_SEGS]) {
  int64_t units = 0;
  for (int k = 0; k < tab.count; ++k) {
    vec[k] = ((reinterpret_cast<uintptr_t>(tab.p[k]) |
               reinterpret_cast<uintptr_t>(tab.m[k]) |
               reinterpret_cast<uintptr_t>(tab.v[k]) |
               reinterpret_cast<uintptr_t>(tab.g[k])) & 15) == 0;
    units += tab.n[k] - (vec[k] ? 3 * (tab.n[k] / 4) : 0);
  }
  return units;
}

// Blocks [0, dense_blocks) take s.epb elements of a slice each (a power
// of two up to 32): an element's sum over the blocks' slices, each of the
// ADAM_THREADS / epb groups of threads adding the slices of its own run of
// blocks in turn and the groups' sums then added pairwise in a fixed
// tree, so the sum is the same from run to run; the last element is the
// step's loss, the others a dense gradient.  The other blocks walk the
// tables as one run of units with a grid stride, a unit four elements
// where a segment's four pointers are 16-byte aligned, and then one
// element of the segment's tail, so that every unit is in flight at once.
__global__ void __launch_bounds__(ADAM_THREADS)
adam_slices(AdamSlices s, AdamStep a, float* loss, int dense_blocks) {
  __shared__ float sums[ADAM_THREADS];
  if ((int)blockIdx.x < dense_blocks) {
    const int groups = ADAM_THREADS / s.epb;
    const int el = threadIdx.x & (s.epb - 1), grp = threadIdx.x / s.epb;
    const int e = blockIdx.x * s.epb + el;
    const int per = (s.blocks + groups - 1) / groups;
    const int first = grp * per, last = min(s.blocks, first + per);
    float g = 0.f;
    if (e < s.slice)
      for (int b = first; b < last; ++b) g += s.part[(size_t)b * s.slice + e];
    sums[threadIdx.x] = g;
    for (int half = groups / 2; half > 0; half >>= 1) {
      __syncthreads();
      if (grp < half) sums[threadIdx.x] += sums[threadIdx.x + half * s.epb];
    }
    if (grp != 0 || e >= s.slice) return;
    g = sums[threadIdx.x];
    if (e == s.slice - 1) {
      *loss = g;
      return;
    }
    int t = 0, j = e;
    while (j >= s.n[t]) j -= s.n[t++];
    adam_elem(s.p[t] + j, s.m[t] + j, s.v[t] + j, g, a);
    return;
  }
  adam_tables(s.tab, s.vec, a,
              (int64_t)(blockIdx.x - dense_blocks) * ADAM_THREADS + threadIdx.x,
              (int64_t)(gridDim.x - dense_blocks) * ADAM_THREADS);
}

// Launches one adam_slices pass at step t, the loss into *loss; returns
// the launch's cudaError_t.
inline int adam_slices_launch(AdamSlices s, int t, float lr, double b1,
                              double b2, float eps, float* loss,
                              cudaStream_t stream) {
  const int64_t units = adam_units(s.tab, s.vec);
  // A short slice over many blocks takes a block per element or two, its
  // threads split over the blocks' slices.
  s.epb = 1;
  while (s.epb < 32 && s.epb < s.slice) s.epb *= 2;
  const int dense_blocks = (s.slice + s.epb - 1) / s.epb;
  const int64_t want = (units + ADAM_THREADS - 1) / ADAM_THREADS;
  const int tab_blocks = (int)(want < 1 ? 1 : want < 65535 ? want : 65535);
  adam_slices<<<dense_blocks + tab_blocks, ADAM_THREADS, 0, stream>>>(
      s, adam_step(t, lr, b1, b2, eps), loss, dense_blocks);
  return (int)cudaGetLastError();
}

}  // namespace
