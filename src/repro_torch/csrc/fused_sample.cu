// One-pass token sampling for Hopper (sm_90a), plain C entry point.
//
// Replaces: the Pallas TPU kernel `_fused_sample_kernel` in
//   src/repro/kernels/fused_sample/kernel.py:34 (wrapper
//   `fused_sample_bkgd`), called once per generated token from the rollout
//   engine's fused sample-and-write step (`rl/engine/compiled.py`).
//
// Computes: per row, tok = argmax(lg + noise) with the EARLIEST index
//   winning ties, and lp = lg[tok] - logsumexp(lg) of the clean logits.
//
// What bounds it: bytes. Each logit and noise value is read once and used
//   for a handful of flops (one exp), so the floor is streaming the
//   (B, V) f32 logits and noise from device memory once: 38.9 MB, 11.6 us
//   at B=32, V=151936 on an H100's 3.35 TB/s.
//
// Design: k blocks of 256 threads per row, one thread-block cluster (k <=
//   8, the portable size, from the wrapper's plan: at B=32, 8 blocks a row
//   on 132 SMs). The first design ran one block of 1024 threads per row,
//   so 32 rows kept 32 of 132 SMs busy. Block r streams slice r of the row
//   (a whole number of float4s, so every slice starts 16-byte aligned
//   when the row does), each thread keeping four 16-byte loads of each
//   input in flight (scalar loads when the rows are not 16-byte aligned;
//   they took 1.33x as long on an H100 at B=32, V=151936 in the first
//   design) and five values: running max m and sum l of exp(lg - m), best
//   perturbed score, its index and its clean logit. Four logits at a time
//   share one test against the running max (a rescale is rare once the
//   stream is under way), so the loop does little but four expf and the
//   adds. Each thread visits its indices in increasing order, so a strict
//   `>` keeps its earliest best; warp shuffles, then shared memory, merge
//   a block's (m, l) by logsumexp and its best by (greater score, or equal
//   score and smaller index). Each block then stores its five values
//   straight into block 0's shared memory (distributed shared memory, as
//   decode_attention.cu does), one cluster barrier makes them visible, and
//   block 0 merges the k partials by the same rule and writes the row.
//   The tie-break is the global earliest index in any reduction order, so
//   the token is the plain version's bit for bit. No workspace, no
//   atomics: the same inputs give the same bits on every launch.
//   chip_smoke.py's cluster probe times k = 8, 4, 2 and 1 at B=32.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 8;   // the portable cluster size
constexpr int kUnroll = 4;      // 16-byte loads of each input in flight

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

// Four consecutive logits from index i: one rescale when their max
// passes the running max (rare once the stream is under way), four
// exponentials, and the best score checked in index order.
__device__ __forceinline__ void visit4(State& st, float4 x, float4 z,
                                       int i) {
  const float mx = fmaxf(fmaxf(x.x, x.y), fmaxf(x.z, x.w));
  if (mx > st.m) {
    st.l *= expf(st.m - mx);
    st.m = mx;
  }
  st.l += (expf(x.x - st.m) + expf(x.y - st.m)) +
          (expf(x.z - st.m) + expf(x.w - st.m));
  const float s[4] = {x.x + z.x, x.y + z.y, x.z + z.z, x.w + z.w};
  const float v[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const bool better = s[e] > st.bs;
    st.bs = better ? s[e] : st.bs;
    st.bi = better ? i + e : st.bi;
    st.bl = better ? v[e] : st.bl;
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

// The two halves of a cluster barrier: arrive without waiting, and wait.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// grid k B along x, clusters of k: block r of row b is block b k + r and
// reads [r slice, (r+1) slice).
template <bool kVec>
__global__ void __launch_bounds__(kThreads, 4)
    fused_sample_kernel(const float* __restrict__ lg,
                        const float* __restrict__ noise, int* __restrict__ tok,
                        float* __restrict__ lp, int V, int k, int slice) {
  __shared__ State part[32];
  __shared__ State recv[kMaxBlocks];
  // Announce that this block has started: no block writes into another's
  // shared memory before the whole cluster has (cluster_wait below).
  cluster_arrive_relaxed();
  cg::cluster_group cluster = cg::this_cluster();
  const int r = blockIdx.x % k, b = blockIdx.x / k;
  const int lo = r * slice, hi = min(V, lo + slice);
  const float* row = lg + static_cast<size_t>(b) * V;
  const float* nrow = noise + static_cast<size_t>(b) * V;
  State st{-INFINITY, 0.f, -INFINITY, -INFINITY, INT_MAX};
  if (kVec) {
    // lo and hi are multiples of 4 (V is, and so is the slice)
    const float4* r4 = reinterpret_cast<const float4*>(row + lo);
    const float4* n4 = reinterpret_cast<const float4*>(nrow + lo);
    const int n = (hi - lo) / 4;
    for (int i0 = threadIdx.x; i0 < n; i0 += kUnroll * kThreads) {
      float4 x[kUnroll], z[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = i0 + u * kThreads;
        if (i < n) {
          x[u] = r4[i];
          z[u] = n4[i];
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = i0 + u * kThreads;
        if (i < n) visit4(st, x[u], z[u], lo + 4 * i);
      }
    }
  } else {
    for (int i0 = lo + threadIdx.x; i0 < hi; i0 += kUnroll * kThreads) {
      float x[kUnroll], z[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = i0 + u * kThreads;
        if (i < hi) {
          x[u] = row[i];
          z[u] = nrow[i];
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = i0 + u * kThreads;
        if (i < hi) visit(st, x[u], x[u] + z[u], i);
      }
    }
  }
  warp_merge(st);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) part[warp] = st;
  __syncthreads();
  if (warp == 0) {
    st = lane < kThreads / 32
             ? part[lane]
             : State{-INFINITY, 0.f, -INFINITY, -INFINITY, INT_MAX};
    warp_merge(st);
  }
  // push this block's partial into block 0, then one cluster barrier
  cluster_wait();
  if (threadIdx.x == 0) *cluster.map_shared_rank(&recv[r], 0) = st;
  cluster.sync();
  if (r == 0 && warp == 0) {
    State a = lane < k ? recv[lane]
                       : State{-INFINITY, 0.f, -INFINITY, -INFINITY, INT_MAX};
    warp_merge(a);
    if (lane == 0) {
      tok[b] = a.bi;
      lp[b] = a.bl - (a.m + logf(a.l));
    }
  }
}

}  // namespace

// lg, noise: (B, V) f32 contiguous; tok: (B,) int32; lp: (B,) f32. Each
// row is cut into k <= 8 slices of `slice` elements (none empty; a
// multiple of 4 when V is, which the 16-byte loads need), one block each,
// the k blocks of a row one cluster. Returns the cudaError_t of the launch
// (0 = success).
extern "C" int fused_sample_launch(const void* lg, const void* noise,
                                   void* tok, void* lp, int B, int V, int k,
                                   int slice, void* stream) {
  if (B == 0) return 0;
  if (V < 1 || k < 1 || k > kMaxBlocks || slice < 1 ||
      static_cast<long long>(slice) * k < V ||
      static_cast<long long>(slice) * (k - 1) >= V ||
      static_cast<long long>(k) * B > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = (V % 4 == 0) && (slice % 4 == 0) &&
                   ((reinterpret_cast<uintptr_t>(lg) |
                     reinterpret_cast<uintptr_t>(noise)) % 16 == 0);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(k * B, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = k;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const float* l = static_cast<const float*>(lg);
  const float* n = static_cast<const float*>(noise);
  int* t = static_cast<int*>(tok);
  float* p = static_cast<float*>(lp);
  cudaError_t e = vec ? cudaLaunchKernelEx(&cfg, fused_sample_kernel<true>,
                                           l, n, t, p, V, k, slice)
                      : cudaLaunchKernelEx(&cfg, fused_sample_kernel<false>,
                                           l, n, t, p, V, k, slice);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
