// One-pass token sampling for Hopper (sm_90a), plain C entry point.
//
// Replaces: the Pallas TPU kernel `_fused_sample_kernel` in
//   src/repro/kernels/fused_sample/kernel.py (wrapper `fused_sample_bkgd`),
//   called once per generated token from the rollout engine's fused
//   sample-and-write step (`rl/engine/compiled.py`).
//
// Computes: per row, tok = argmax(lg + noise) with the EARLIEST index
//   winning ties, and lp = lg[tok] - logsumexp(lg) of the clean logits.
//
// What bounds it: bytes. Each logit and noise value is read once and used
//   for a handful of flops (one exp), so the floor is streaming the
//   (B, V) f32 logits and noise from device memory once.
//
// Design: one block of 1024 threads per row; threads stride over the vocab
//   (16-byte vector loads when the rows are aligned; scalar loads took
//   1.33x as long on an H100 at B=32, V=151936, and chip_smoke.py times
//   both) keeping five values:
//   running max m and sum l of exp(lg - m), best perturbed score, its index
//   and its clean logit. Because each thread visits its indices in
//   increasing order, a strict `>` keeps its earliest best; warp shuffles
//   and then shared memory merge (m, l) by logsumexp and the best by
//   (greater score, or equal score and smaller index), so the tie-break is
//   the global earliest index in any reduction order.
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;

struct State {
  float m, l, bs, bl;
  int bi;
};

__device__ __forceinline__ void visit(State& st, float x, float sc, int i) {
  if (x > st.m) {
    st.l = st.l * expf(st.m - x) + 1.f;
    st.m = x;
  } else {
    st.l += expf(x - st.m);
  }
  if (sc > st.bs) {
    st.bs = sc;
    st.bi = i;
    st.bl = x;
  }
}

__device__ __forceinline__ void merge(State& a, const State& o) {
  const float mn = fmaxf(a.m, o.m);
  a.l = (mn == -INFINITY) ? 0.f
                          : a.l * expf(a.m - mn) + o.l * expf(o.m - mn);
  a.m = mn;
  if (o.bs > a.bs || (o.bs == a.bs && o.bi < a.bi)) {
    a.bs = o.bs;
    a.bi = o.bi;
    a.bl = o.bl;
  }
}

__device__ __forceinline__ State shfl(const State& s, int o) {
  State r;
  r.m = __shfl_xor_sync(0xffffffffu, s.m, o);
  r.l = __shfl_xor_sync(0xffffffffu, s.l, o);
  r.bs = __shfl_xor_sync(0xffffffffu, s.bs, o);
  r.bl = __shfl_xor_sync(0xffffffffu, s.bl, o);
  r.bi = __shfl_xor_sync(0xffffffffu, s.bi, o);
  return r;
}

__device__ __forceinline__ void warp_merge(State& s) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) merge(s, shfl(s, o));
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
    fused_sample_kernel(const float* __restrict__ lg,
                        const float* __restrict__ noise, int* __restrict__ tok,
                        float* __restrict__ lp, int V) {
  __shared__ State part[kThreads / 32];
  const int b = blockIdx.x;
  const float* row = lg + static_cast<size_t>(b) * V;
  const float* nrow = noise + static_cast<size_t>(b) * V;
  State st{-INFINITY, 0.f, -INFINITY, -INFINITY, INT_MAX};
  if (kVec) {
    const float4* r4 = reinterpret_cast<const float4*>(row);
    const float4* n4 = reinterpret_cast<const float4*>(nrow);
    for (int i = threadIdx.x; i < V / 4; i += kThreads) {
      const float4 x = r4[i];
      const float4 z = n4[i];
      visit(st, x.x, x.x + z.x, 4 * i);
      visit(st, x.y, x.y + z.y, 4 * i + 1);
      visit(st, x.z, x.z + z.z, 4 * i + 2);
      visit(st, x.w, x.w + z.w, 4 * i + 3);
    }
  } else {
    for (int i = threadIdx.x; i < V; i += kThreads)
      visit(st, row[i], row[i] + nrow[i], i);
  }
  warp_merge(st);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) part[warp] = st;
  __syncthreads();
  if (warp == 0) {
    st = part[lane];
    warp_merge(st);
    if (lane == 0) {
      tok[b] = st.bi;
      lp[b] = st.bl - (st.m + logf(st.l));
    }
  }
}

}  // namespace

// lg, noise: (B, V) f32 contiguous; tok: (B,) int32; lp: (B,) f32.
// Returns the cudaError_t of the launch (0 = success).
extern "C" int fused_sample_launch(const void* lg, const void* noise,
                                   void* tok, void* lp, int B, int V,
                                   void* stream) {
  if (B == 0) return 0;
  if (V < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = (V % 4 == 0) &&
                   ((reinterpret_cast<uintptr_t>(lg) |
                     reinterpret_cast<uintptr_t>(noise)) % 16 == 0);
  if (vec) {
    fused_sample_kernel<true><<<B, kThreads, 0, s>>>(
        static_cast<const float*>(lg), static_cast<const float*>(noise),
        static_cast<int*>(tok), static_cast<float*>(lp), V);
  } else {
    fused_sample_kernel<false><<<B, kThreads, 0, s>>>(
        static_cast<const float*>(lg), static_cast<const float*>(noise),
        static_cast<int*>(tok), static_cast<float*>(lp), V);
  }
  return static_cast<int>(cudaGetLastError());
}
