// The scaffolding of the persistent epoch kernels (bpr_epoch.cu,
// gmf_epoch.cu, cml_epoch.cu): one cooperative launch an epoch, one wave
// of blocks that walks the steps itself and crosses a grid barrier
// between a step's phases.
//
// - The plan: ops/train.py's persist_plan sizes the grid to one wave,
//   blocks = the SM count x the blocks an SM holds
//   (cudaOccupancyMaxActiveBlocksPerMultiprocessor, which the entry
//   points' *_occupancy functions report), and the kernel is launched by
//   cudaLaunchCooperativeKernel, which refuses a grid that cannot be
//   resident at once: the wrapper then raises, it never falls back.
// - The barrier: a counter in device memory that only grows.  After the
//   block's threads meet (__syncthreads), thread 0 adds one with a release
//   reduction and polls with acquire loads until the count of the
//   barrier's round (blocks x rounds so far) is reached; then the block's
//   threads meet again (the pattern of CUTLASS's GenericBarrier: the
//   block barriers carry each thread's writes and reads through thread 0's
//   release and acquire, with no sequentially consistent fence).  The
//   counter is zeroed by cudaMemsetAsync before each launch.  On an H100
//   it took 1.04-1.09 us at the kernels' grids against 1.12-1.21 us for
//   cooperative_groups' grid.sync() (tools/epoch_ab.py --phases times
//   both, barrier_probe).
// - The next step's id planes are prefetched into L2 during phase B
//   (prefetch_l2), so phase A waits on L2, not device memory.
// - Work is spread over the blocks block-minor: unit k of a phase goes to
//   block k % blocks, so a step's few units still reach every SM.
// - The slices: a dense sum (GMF's dh, the loss) leaves each block by
//   plain stores into the block's slice; a warp adds one element over the
//   slices in block order (lane l the slices l, l + 32, ..., then an xor
//   butterfly), so the sum is the same from run to run.
// - The loss: each block stores its share of step s at part_loss[s, block];
//   after the last barrier the warps sum the steps' rows, and the last
//   warp to finish adds the steps in order into loss[steps].
//
// The tables are written during the launch, so they are read with plain
// loads (never __ldg, never through a const __restrict__ pointer): the
// read-only path may keep a line from before another block's write.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "epoch.cuh"

namespace {

// Threads a block of the persistent kernels, unless a kernel's variant
// says otherwise (PersistKernel).
constexpr int PERSIST_THREADS = 512;
constexpr int PERSIST_WARPS = PERSIST_THREADS / 32;

#ifdef PERSIST_CLOCKS
// tools/epoch_ab.py --phases builds with -DPERSIST_CLOCKS: thread 0 of
// each block adds the clock64() cycles of each part of a step over the
// epoch's steps (0, 1: phase A's two parts, named by each kernel; 2: the
// wait at the barrier after A; 3: phase B; 4: the wait after B), and
// persist_read_clocks copies them out.
constexpr int PERSIST_PHASES = 5, PERSIST_STAMP_BLOCKS = 1024;
__device__ long long persist_clocks[PERSIST_STAMP_BLOCKS][PERSIST_PHASES];
#define PERSIST_PHASE(k)                                           \
  if (threadIdx.x == 0) {                                          \
    const long long now = clock64();                               \
    ph[k] += now - last;                                           \
    last = now;                                                    \
  }
#define PERSIST_CLOCK_INIT long long ph[PERSIST_PHASES] = {}, last = clock64();
#define PERSIST_CLOCK_STORE                                        \
  if (threadIdx.x == 0 && blockIdx.x < PERSIST_STAMP_BLOCKS)       \
    for (int k = 0; k < PERSIST_PHASES; ++k)                       \
      persist_clocks[blockIdx.x][k] = ph[k];
#else
#define PERSIST_PHASE(k)
#define PERSIST_CLOCK_INIT
#define PERSIST_CLOCK_STORE
#endif

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void red_release_add(unsigned* p, unsigned v) {
  asm volatile("red.release.gpu.global.add.u32 [%0], %1;"
               :: "l"(p), "r"(v) : "memory");
}

// The grid barrier.  ``round`` counts the barriers this block has crossed
// in the launch (the same in every block).
__device__ __forceinline__ void grid_sync(unsigned* bar, unsigned& round) {
  __syncthreads();
  ++round;
  if (threadIdx.x == 0) {
    const unsigned target = round * gridDim.x;
    red_release_add(bar, 1u);
    while ((int)(ld_acquire(bar) - target) < 0) {
    }
  }
  __syncthreads();
}

// The grid's threads ask L2 for the [p, p + bytes) range, a 128-byte line
// each (read-only inputs of a later phase).
__device__ __forceinline__ void prefetch_l2(const void* p, int64_t bytes) {
  const char* c = static_cast<const char*>(p);
  const int64_t stride = (int64_t)gridDim.x * blockDim.x * 128;
  for (int64_t off = (((int64_t)threadIdx.x >> 5) * gridDim.x + blockIdx.x)
                     * 32 * 128 + (threadIdx.x & 31) * 128;
       off < bytes; off += stride)
    asm volatile("prefetch.global.L2 [%0];" :: "l"(c + off));
}

// W consecutive floats of a table (plain loads: the tables change during
// the launch).
template <int W>
__device__ __forceinline__ void ld(float (&r)[W], const float* p) {
  if constexpr (W == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    r[0] = t.x;
    r[1] = t.y;
    r[2] = t.z;
    r[3] = t.w;
  } else {
    r[0] = *p;
  }
}

// W floats added into a table by one reduction, red.global.add (its v4
// form where W = 4, sm_90).  atomicAdd with its result unused compiles to
// ATOMG, whose answer the warp waits for; red's REDG sends the sum and
// goes on (PERF.md section 5).
template <int W>
__device__ __forceinline__ void atomic_add(float* p, const float (&a)[W]) {
  if constexpr (W == 4)
    asm volatile("red.global.add.v4.f32 [%0], {%1, %2, %3, %4};"
                 :: "l"(p), "f"(a[0]), "f"(a[1]), "f"(a[2]), "f"(a[3])
                 : "memory");
  else
    asm volatile("red.global.add.f32 [%0], %1;" :: "l"(p), "f"(a[0])
                 : "memory");
}

// Sum over the 16 lanes of a half-warp.
__device__ __forceinline__ float half_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Adam's constants of the epoch, as adam_step rounds them; step s's bias
// corrections come from the wrapper's table bc [steps, 2], the numbers its
// plain version uses (ops/train.py _epoch_bias_corrections).
struct AdamBase {
  float lr, b1, c1, b2, c2, eps;
};

inline AdamBase adam_base(float lr, double b1, double b2, float eps) {
  return {lr, (float)b1, (float)(1.0 - b1), (float)b2, (float)(1.0 - b2), eps};
}

__device__ __forceinline__ AdamStep step_at(const AdamBase& b,
                                            const float* bc, int s) {
  return {b.lr, b.b1, b.c1, b.b2, b.c2, b.eps, __ldg(bc + 2 * s),
          __ldg(bc + 2 * s + 1)};
}

// Thread k of the grid in block-minor order by warps: a warp's 32 lanes
// stay on consecutive units (coalesced), consecutive warps of units go to
// consecutive blocks.
__device__ __forceinline__ int64_t grid_thread() {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  return ((int64_t)warp * gridDim.x + blockIdx.x) * 32 + lane;
}

__device__ __forceinline__ int grid_warp() {
  return (threadIdx.x >> 5) * gridDim.x + blockIdx.x;
}

// n floats at p set to zero by the grid: float4 stores where p is 16-byte
// aligned.
__device__ __forceinline__ void grid_zero(float* p, int64_t n) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  int64_t e = grid_thread();
  if ((reinterpret_cast<uintptr_t>(p) & 15) == 0) {
    const int64_t n4 = n / 4;
    for (int64_t k = e; k < n4; k += stride)
      reinterpret_cast<float4*>(p)[k] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int64_t k = 4 * n4 + e; k < n; k += stride) p[k] = 0.f;
  } else {
    for (int64_t k = e; k < n; k += stride) p[k] = 0.f;
  }
}

// The sum of n values p[0], p[stride], ..., in a fixed order: lane l adds
// p[l * stride], p[(l + 32) * stride], ... in turn, then an xor butterfly;
// every lane gets it.
__device__ __forceinline__ float slice_sum(const float* p, int64_t stride,
                                           int n) {
  const int lane = threadIdx.x & 31;
  float acc = 0.f;
#pragma unroll 8
  for (int k = lane; k < n; k += 32) acc += p[(int64_t)k * stride];
  return warp_sum(acc);
}

// After the last barrier: loss[s] is the sum of row s of part_loss
// [steps, blocks] in block order, a warp a step; the last warp to finish
// adds loss[0 .. steps) into loss[steps] (slice_sum's order).  done is a
// zeroed counter.
__device__ void finish_losses(const float* part_loss, float* loss, int steps,
                              unsigned* done) {
  const int lane = threadIdx.x & 31;
  const int warps = gridDim.x * (blockDim.x >> 5);
  const int gw = grid_warp();
  if (steps == 0) {
    if (gw == 0 && lane == 0) loss[0] = 0.f;
    return;
  }
  for (int s = gw; s < steps; s += warps) {
    const float l = slice_sum(part_loss + (int64_t)s * gridDim.x, 1,
                              gridDim.x);
    unsigned prev = 0;
    if (lane == 0) {
      loss[s] = l;
      __threadfence();
      prev = atomicAdd(done, 1u);
    }
    prev = __shfl_sync(0xffffffffu, prev, 0);
    if (prev == (unsigned)steps - 1) {
      __threadfence();
      float acc = 0.f;
      for (int k = lane; k < steps; k += 32) acc += __ldcg(loss + k);
      acc = warp_sum(acc);
      if (lane == 0) loss[steps] = acc;
    }
  }
}

// A persistent kernel and its threads a block.
struct PersistKernel {
  const void* fn;
  int threads;
};

// Launches ``k`` as one cooperative grid of ``blocks`` with ``smem`` bytes
// of dynamic shared memory on ``stream``, its barrier and done counters
// (bar[0], bar[1]) zeroed first; returns a cudaError_t.
inline int persist_launch(PersistKernel k, int blocks, void** args,
                          unsigned* bar, cudaStream_t stream,
                          size_t smem = 0) {
  cudaError_t err = cudaMemsetAsync(bar, 0, 2 * sizeof(unsigned), stream);
  if (err != cudaSuccess) return (int)err;
  err = cudaLaunchCooperativeKernel(k.fn, dim3(blocks), dim3(k.threads), args,
                                    smem, stream);
  return (int)err;
}

// The blocks of ``k`` an SM holds at once with ``smem`` bytes of dynamic
// shared memory each, and its threads a block.
inline int persist_occupancy(PersistKernel k, size_t smem, int* per_sm,
                             int* threads) {
  *threads = k.threads;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, k.fn, k.threads, smem);
}

#ifdef PERSIST_CLOCKS
// ``iters`` grid barriers and nothing else, one cooperative launch of
// ``blocks``: tools/epoch_ab.py --phases times it to give one barrier's
// cost at the epoch kernels' grid; with ``cg``, cooperative_groups'
// grid.sync() in place of grid_sync, to compare the two.
__global__ void __launch_bounds__(1024)
barrier_probe(unsigned* bar, int iters, int cg) {
  unsigned round = 0;
  if (cg) {
    const cooperative_groups::grid_group grid = cooperative_groups::this_grid();
    for (int k = 0; k < iters; ++k) grid.sync();
  } else {
    for (int k = 0; k < iters; ++k) grid_sync(bar, round);
  }
}
#endif

}  // namespace

#ifdef PERSIST_CLOCKS
// The phase cycles of the last launch: [1024 blocks][5] into host memory
// ``out``; returns 0 or a cudaError_t.
extern "C" int persist_read_clocks(long long* out) {
  return (int)cudaMemcpyFromSymbol(out, persist_clocks, sizeof(persist_clocks));
}

extern "C" int persist_barrier_probe(unsigned* bar, int blocks, int threads,
                                     int iters, int cg, cudaStream_t stream) {
  void* args[] = {&bar, &iters, &cg};
  return persist_launch({(const void*)barrier_probe, threads}, blocks, args,
                        bar, stream);
}
#endif
