// Decode attention over a dense KV cache for Hopper (sm_90a), one launch
// per call, plain C entry point.
//
// Replaces: the Pallas TPU kernel `_decode_kernel` in
//   src/repro/kernels/decode_attention/kernel.py:28 (wrapper
//   `decode_attention_bkgd`), called once per layer per decoded token from
//   `models/layers.decode_attention` with attn_impl="pallas". On the TPU
//   the sequence axis is a sequential grid dimension carrying (m, l, acc)
//   in VMEM scratch; its docstring names the CUDA split-K flash-decode as
//   the form it replaced, and this is that form, merged inside one launch.
//
// Computes: for each row b and kv head h, the `group` query heads that
//   share h attend over the S cache slots of row b, (B, S, KV, hd) read by
//   stride, with a (B, S) validity mask (ring buffer, sliding window).
//   Masked keys score the finite -1e30 as in the JAX kernel, so a row with
//   no valid key outputs the mean of V over S (a softmax of equal logits).
//   q is f32 or bf16, K/V f32 or bf16 (they may differ: a bf16 cache under
//   f32 weights); all arithmetic is f32 and the output takes q's dtype.
//
// What bounds it: bytes. Each K/V element read feeds 4 flops per query
//   head of its GQA group (7 for qwen2-0.5b), far below the card's
//   operations-per-byte balance, so the floor is reading K and V once:
//   at B=32, S=256, 2 kv heads, hd 64 in bf16 that is 4.19 MB, 1.25 us at
//   3.35 TB/s. At that size what the card actually spends is latency: the
//   split-K design before this one took 24.7 us in two launches (pass 1
//   over 512 blocks of one 32-key tile, then a merge through a device
//   workspace allocated per call), with scalar 2-byte loads, a serial dot
//   product over a runtime hd per key, and a serial P.V loop per output
//   dimension; PERF.md gives its profile split.
//
// Design: one block per (chunk, kv head, row); the chunks of one (row, kv
//   head) form a thread-block cluster (at most 8, the portable size), and
//   the wrapper sizes the chunk, in whole 32-key tiles, so the grid holds
//   up to about four blocks per SM while each block walks two tiles or
//   more (at B=32, KV=2 on 132 SMs: S=256 gives 4 chunks of two tiles,
//   S=2048 8 chunks of eight). A block has one warp per query head of the
//   group.
//   - Mask first. The block reads the row's (B, S) mask bytes (one ballot
//     per 32 keys: bit j is key j of a tile) before any K/V. When the row
//     has a valid key, tiles with none are never loaded: each would add
//     exp(-1e30 - m) = 0. A row with no valid key loads every tile, all
//     scores -1e30, which gives the mean of V as the TPU kernel does.
//   - 16-byte loads. Tiles of K and V go to shared memory in their own
//     dtype by cp.async (16 bytes a thread, neighbouring threads on
//     neighbouring addresses), two tiles in flight, so a block walking
//     several tiles (longer S) computes one while the next arrives. A base
//     or stride that is not 16-byte aligned takes plain element copies.
//     The model's cache views are always aligned, so no caller of the
//     package reaches that branch; it is kept so that the wrapper goes on
//     taking any strided (B,S,KV,hd) view, as the earlier split-K kernel
//     did, rather than gaining a refusal.
//   - Short chains. hd is a template parameter. Each key's dot product is
//     spread over LPK = HD/8 lanes (4 x the largest power of two dividing
//     HD/32, so it divides 32), each holding 8 of q's dims per group of
//     8*LPK in registers, then a shuffle tree of log2(LPK) steps; a warp
//     scores 32/LPK keys at once. P.V reuses that mapping: each lane adds
//     its key's p * V into its own dims, and the lanes of different keys
//     are summed by shuffles once, at the end of the chunk. Only the
//     tile's max crosses lanes per tile.
//   - One launch. Head g of a (row, kv head) is merged by block
//     g mod n_chunks of its cluster. Each block stores its partial
//     (m, l, acc) per head straight into the merging block's shared
//     memory (distributed shared memory: stores, which need no reply,
//     where loads by the merger would wait on one remote round trip after
//     another); one cluster barrier makes them visible, and the merger
//     reads them locally, in chunk order, with weights exp(m_c - M) (0
//     for a chunk that saw no valid key, when the row has one), and writes
//     the output. No workspace, no atomics: the same inputs give the same
//     bits on every launch.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kTile = 32;         // keys per tile: one mask bit per lane
constexpr int kStages = 2;        // tiles in flight per block
constexpr int kMaxChunks = 8;     // the portable cluster size
constexpr int kMaxHd = 256;
constexpr int kMaxGroup = 32;     // one warp per query head

// Lane geometry for head width HD: LPK lanes share a key, each holding
// NG groups of 8 dims; a warp covers KPS keys per step, a tile in kSteps.
template <int HD>
struct Lanes {
  static constexpr int kM = HD / 32;
  static constexpr int kLPK = 4 * (kM & -kM);
  static constexpr int kNG = HD / (8 * kLPK);
  static constexpr int kKPS = 32 / kLPK;
  static constexpr int kSteps = kTile / kKPS;
  static_assert(HD % 32 == 0 && kNG * 8 * kLPK == HD, "hd a multiple of 32");
};

__device__ __forceinline__ void load8(const float* p, float (&x)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&x)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] = __uint_as_float(w[i] << 16);
    x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// 2^x in one MUFU instruction (relative error about 2^-22; 2^-inf = 0).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The two halves of a cluster barrier: arrive without waiting, and wait.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Words of the chunk's tile masks, rounded up to 16 bytes.
__host__ __device__ __forceinline__ int recv_offset(int chunk) {
  return (chunk / kTile + 3) & ~3;
}

// grid (n_chunks, KV, B), clusters of n_chunks along x, 32 * group threads.
template <typename KT, int HD>
__global__ void __launch_bounds__(1024)
    decode_attention_kernel(const void* __restrict__ q,
                            const KT* __restrict__ k,
                            const KT* __restrict__ v,
                            const uint8_t* __restrict__ valid,
                            void* __restrict__ out, int S, int KV,
                            int group, int chunk, long long k_sb,
                            long long k_ss, long long v_sb, long long v_ss,
                            float scale_log2, int q_bf16, int vec) {
  using G = Lanes<HD>;
  constexpr int kLPK = G::kLPK, kNG = G::kNG, kKPS = G::kKPS;
  constexpr int kTileElems = kTile * HD;
  extern __shared__ __align__(16) uint8_t smem[];
  KT* tiles = reinterpret_cast<KT*>(smem);    // [stage][K | V][key][HD]
  uint32_t* mask_s = reinterpret_cast<uint32_t*>(
      smem + kStages * 2 * kTileElems * sizeof(KT));  // [chunk / kTile]
  // the partials of the heads this block merges: [chunk c][head j][acc
  // (HD), m, l, pad]
  float* recv = reinterpret_cast<float*>(mask_s + recv_offset(chunk));

  // Announce that this block has started: no block writes into another's
  // shared memory before the whole cluster has (cluster_wait below).
  cluster_arrive_relaxed();
  cg::cluster_group cluster = cg::this_cluster();
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int n_chunks = gridDim.x;
  const int hpb = (group + n_chunks - 1) / n_chunks;  // heads per merger
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nthreads = blockDim.x;
  const int s0 = c * chunk, s_end = min(s0 + chunk, S);
  const int ct0 = s0 / kTile;
  const int n_ct = (s_end - s0 + kTile - 1) / kTile;   // tiles in the chunk
  const uint8_t* vrow = valid + static_cast<size_t>(b) * S;

  // This lane's dims of head `warp`: group i is 8 * (i * LPK + lane % LPK).
  // q's bits are loaded first, so they arrive while the mask is read.
  const int dl = 8 * (lane % kLPK);
  const int slot = lane / kLPK;                // key slot within a step
  uint32_t qbits[kNG * 8];
  {
    const size_t qoff =
        ((static_cast<size_t>(b) * KV + h) * group + warp) * HD + dl;
#pragma unroll
    for (int i = 0; i < kNG; ++i)
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const size_t idx = qoff + i * 8 * kLPK + e;
        qbits[i * 8 + e] =
            q_bf16 ? static_cast<const uint16_t*>(q)[idx]
                   : static_cast<const uint32_t*>(q)[idx];
      }
  }

  // The row's mask, one ballot per 32 keys: the chunk's tiles to shared
  // memory, and whether the chunk and the rest of the row hold a valid key.
  bool in_any = false, out_any = false;
  const int n_rt = (S + kTile - 1) / kTile;
  for (int rt = warp; rt < n_rt; rt += nthreads >> 5) {
    const int pos = rt * kTile + lane;
    const uint32_t bal = __ballot_sync(0xffffffffu, pos < S && vrow[pos]);
    if (rt >= ct0 && rt < ct0 + n_ct) {
      if (lane == 0) mask_s[rt - ct0] = bal;
      in_any |= bal != 0;
    } else {
      out_any |= bal != 0;
    }
  }
  const bool chunk_any = __syncthreads_or(in_any);
  const bool row_any = chunk_any || __syncthreads_or(out_any);

  // Scores in log2 units: s = q . k * scale * log2(e), p = exp2(s - m).
  float qr[kNG * 8], acc[kNG * 8];
#pragma unroll
  for (int e = 0; e < kNG * 8; ++e) {
    qr[e] = (q_bf16 ? __uint_as_float(qbits[e] << 16)
                    : __uint_as_float(qbits[e])) * scale_log2;
    acc[e] = 0.f;
  }

  float m_run = kNegInf, l_part = 0.f;

  const KT* kb = k + b * k_sb + static_cast<long long>(h) * HD;
  const KT* vb = v + b * v_sb + static_cast<long long>(h) * HD;
  // a tile is walked when the row has no valid key (all of them), or when
  // it holds one
  auto next_tile = [&](int t) {
    while (t < n_ct && row_any && mask_s[t] == 0) ++t;
    return t;
  };
  auto issue = [&](int t, int st) {
    if (t >= n_ct) return;
    const int t0 = s0 + t * kTile;
    const int n = min(kTile, s_end - t0);
    KT* dst = tiles + st * 2 * kTileElems;
    if (vec) {
      constexpr int kVpr = HD * sizeof(KT) / 16;      // 16 B vectors a row
      for (int i = threadIdx.x; i < 2 * n * kVpr; i += nthreads) {
        const int tsr = i / (n * kVpr), r = i - tsr * n * kVpr;
        const int key = r / kVpr, vv = r - key * kVpr;
        const KT* src = tsr ? vb + (t0 + key) * v_ss : kb + (t0 + key) * k_ss;
        cp_async16(reinterpret_cast<uint8_t*>(dst + tsr * kTileElems +
                                              key * HD) + vv * 16,
                   reinterpret_cast<const uint8_t*>(src) + vv * 16);
      }
    } else {
      for (int i = threadIdx.x; i < 2 * n * HD; i += nthreads) {
        const int tsr = i / (n * HD), r = i - tsr * n * HD;
        const int key = r / HD, d = r - key * HD;
        dst[tsr * kTileElems + key * HD + d] =
            tsr ? vb[(t0 + key) * v_ss + d] : kb[(t0 + key) * k_ss + d];
      }
    }
  };

  int cur = next_tile(0);
  int nxt = cur < n_ct ? next_tile(cur + 1) : n_ct;
  issue(cur, 0);
  cp_async_commit();
  issue(nxt, 1);
  cp_async_commit();
  for (int it = 0; cur < n_ct; ++it) {
    const int st = it & 1;
    cp_async_wait<1>();
    __syncthreads();
    const int t0 = s0 + cur * kTile;
    const int n = min(kTile, s_end - t0);
    const uint32_t vm = mask_s[cur];
    const KT* ks = tiles + st * 2 * kTileElems;
    const KT* vs = ks + kTileElems;
    float sc[G::kSteps];
    float mx = -INFINITY;
#pragma unroll
    for (int step = 0; step < G::kSteps; ++step) {
      const int kk = step * kKPS + slot;
      float dot = 0.f;
      if (kk < n) {
#pragma unroll
        for (int i = 0; i < kNG; ++i) {
          float x[8];
          load8(ks + kk * HD + i * 8 * kLPK + dl, x);
#pragma unroll
          for (int e = 0; e < 8; ++e) dot = fmaf(qr[i * 8 + e], x[e], dot);
        }
      }
#pragma unroll
      for (int o = kLPK / 2; o > 0; o >>= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, o);
      sc[step] = kk >= n ? -INFINITY : ((vm >> kk) & 1u) ? dot : kNegInf;
      mx = fmaxf(mx, sc[step]);
    }
#pragma unroll
    for (int o = kLPK; o < 32; o <<= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    const float m_new = fmaxf(m_run, mx);
    const float alpha = fast_exp2(m_run - m_new);
    m_run = m_new;
    l_part *= alpha;
#pragma unroll
    for (int e = 0; e < kNG * 8; ++e) acc[e] *= alpha;
#pragma unroll
    for (int step = 0; step < G::kSteps; ++step) {
      const int kk = step * kKPS + slot;
      const float p = fast_exp2(sc[step] - m_new);  // 0 past the tile's end
      l_part += p;
      if (kk < n) {
#pragma unroll
        for (int i = 0; i < kNG; ++i) {
          float x[8];
          load8(vs + kk * HD + i * 8 * kLPK + dl, x);
#pragma unroll
          for (int e = 0; e < 8; ++e)
            acc[i * 8 + e] = fmaf(p, x[e], acc[i * 8 + e]);
        }
      }
    }
    __syncthreads();   // every warp is done with stage st
    const int nn = nxt < n_ct ? next_tile(nxt + 1) : n_ct;
    issue(nn, st);
    cp_async_commit();
    cur = nxt;
    nxt = nn;
  }
  cp_async_wait<0>();

  // The lanes of a head's key slots hold partial sums of l and acc: sum
  // them (every lane ends with the totals of its dims).
#pragma unroll
  for (int o = kLPK; o < 32; o <<= 1) {
    l_part += __shfl_xor_sync(0xffffffffu, l_part, o);
#pragma unroll
    for (int e = 0; e < kNG * 8; ++e)
      acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], o);
  }
  // Head `warp` is merged by block warp mod n_chunks of the cluster: push
  // this chunk's partial into that block's shared memory (stores, which
  // need no reply), then one cluster barrier makes every push visible.
  cluster_wait();
  {
    float* dst = cluster.map_shared_rank(recv, warp % n_chunks) +
                 (c * hpb + warp / n_chunks) * (HD + 4);
    if (slot == 0) {
#pragma unroll
      for (int i = 0; i < kNG; ++i) {
        float* d = dst + i * 8 * kLPK + dl;
        *reinterpret_cast<float4*>(d) = make_float4(
            acc[i * 8], acc[i * 8 + 1], acc[i * 8 + 2], acc[i * 8 + 3]);
        *reinterpret_cast<float4*>(d + 4) =
            make_float4(acc[i * 8 + 4], acc[i * 8 + 5], acc[i * 8 + 6],
                        acc[i * 8 + 7]);
      }
    }
    if (lane == 0) {
      dst[HD] = m_run;
      dst[HD + 1] = l_part;
    }
  }
  cluster.sync();

  // The merge of head `warp` over the chunks in order, from this block's
  // own shared memory. l >= 1: the chunk holding the row's max adds
  // exp2(0) for that key.
  if (warp % n_chunks == c) {
    const float* src = recv + (warp / n_chunks) * (HD + 4);
    const int cs = hpb * (HD + 4);               // stride between chunks
    float M = kNegInf;
    for (int cc = 0; cc < n_chunks; ++cc) M = fmaxf(M, src[cc * cs + HD]);
    float l = 0.f, o[HD / 32];
#pragma unroll
    for (int i = 0; i < HD / 32; ++i) o[i] = 0.f;
    for (int cc = 0; cc < n_chunks; ++cc) {
      const float* pa = src + cc * cs;
      const float w = fast_exp2(pa[HD] - M);
      l = fmaf(w, pa[HD + 1], l);
#pragma unroll
      for (int i = 0; i < HD / 32; ++i) o[i] = fmaf(w, pa[lane + 32 * i], o[i]);
    }
    const size_t ooff =
        ((static_cast<size_t>(b) * KV + h) * group + warp) * HD + lane;
#pragma unroll
    for (int i = 0; i < HD / 32; ++i) {
      if (q_bf16)
        static_cast<__nv_bfloat16*>(out)[ooff + 32 * i] =
            __float2bfloat16(o[i] / l);
      else
        static_cast<float*>(out)[ooff + 32 * i] = o[i] / l;
    }
  }
}

template <typename KT, int HD>
int launch(const void* q, const void* k, const void* v, const void* valid,
           void* out, int B, int S, int KV, int group, int chunk,
           int n_chunks, long long k_sb, long long k_ss, long long v_sb,
           long long v_ss, int q_bf16, cudaStream_t stream) {
  const size_t esz = sizeof(KT);
  const auto aligned = [](long long x) { return x % 16 == 0; };
  const int vec =
      aligned(reinterpret_cast<uintptr_t>(k)) &&
      aligned(reinterpret_cast<uintptr_t>(v)) && aligned(k_sb * esz) &&
      aligned(k_ss * esz) && aligned(v_sb * esz) && aligned(v_ss * esz);
  const int hpb = (group + n_chunks - 1) / n_chunks;
  const size_t smem = kStages * 2 * kTile * HD * esz +
                      recv_offset(chunk) * sizeof(uint32_t) +
                      static_cast<size_t>(n_chunks) * hpb * (HD + 4) *
                          sizeof(float);
  auto kern = decode_attention_kernel<KT, HD>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_chunks, KV, B);
  cfg.blockDim = dim3(32 * group, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n_chunks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(
      &cfg, kern, q, static_cast<const KT*>(k), static_cast<const KT*>(v),
      static_cast<const uint8_t*>(valid), out, S, KV, group, chunk, k_sb,
      k_ss, v_sb, v_ss, 1.4426950408889634f / sqrtf(static_cast<float>(HD)),
      q_bf16, vec);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

template <typename KT>
int launch_hd(int hd, const void* q, const void* k, const void* v,
              const void* valid, void* out, int B, int S, int KV, int group,
              int chunk, int n_chunks, long long k_sb, long long k_ss,
              long long v_sb, long long v_ss, int q_bf16, cudaStream_t s) {
#define DA_CASE(HD)                                                        \
  case HD:                                                                 \
    return launch<KT, HD>(q, k, v, valid, out, B, S, KV, group, chunk,     \
                          n_chunks, k_sb, k_ss, v_sb, v_ss, q_bf16, s);
  switch (hd) {
    DA_CASE(32) DA_CASE(64) DA_CASE(96) DA_CASE(128)
    DA_CASE(160) DA_CASE(192) DA_CASE(224) DA_CASE(256)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef DA_CASE
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16. q (B, KV*group, hd) and out are
// contiguous; K/V rows and positions are strided (k_sb, k_ss elements),
// with kv heads and head dims contiguous inside a position; valid is
// (B, S) bytes. The keys are cut into n_chunks chunks of `chunk` keys (a
// multiple of 32, none empty, n_chunks <= 8), one cluster per (row, kv
// head). Returns the cudaError_t of the launch (0 = success).
extern "C" int decode_attention_launch(
    const void* q, const void* k, const void* v, const void* valid,
    void* out, int B, int S, int KV, int group, int hd, int chunk,
    int n_chunks, long long k_sb, long long k_ss, long long v_sb,
    long long v_ss, int q_dtype, int kv_dtype, void* stream) {
  if (B == 0 || KV == 0) return 0;
  if (group < 1 || group > kMaxGroup || hd % 32 != 0 || hd > kMaxHd ||
      S < 1 || chunk < 1 || chunk % kTile != 0 || n_chunks < 1 ||
      n_chunks > kMaxChunks ||
      static_cast<long long>(chunk) * n_chunks < S ||
      static_cast<long long>(chunk) * (n_chunks - 1) >= S ||
      (q_dtype != 0 && q_dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kv_dtype) {
    case 0:
      return launch_hd<float>(hd, q, k, v, valid, out, B, S, KV, group,
                              chunk, n_chunks, k_sb, k_ss, v_sb, v_ss,
                              q_dtype, s);
    case 1:
      return launch_hd<__nv_bfloat16>(hd, q, k, v, valid, out, B, S, KV,
                                      group, chunk, n_chunks, k_sb, k_ss,
                                      v_sb, v_ss, q_dtype, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
