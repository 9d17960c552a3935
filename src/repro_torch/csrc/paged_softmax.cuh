// The block body shared by the paged decode kernel (paged_attention.cu)
// and the speculative verify kernel (spec_verify.cu).
//
// A paged decode step is a verify chunk of one query: row b attends the
// positions < lens[b], which is query 0 of a chunk at pos = lens[b] - 1.
// So both kernels run `attend` below on the same plan, each with its own
// __global__ entry (the profiler tells them apart by name): the paged one
// passes K = 1 and len0 = lens[b], the verify one K queries and len0 =
// pos[b] + 1, query j attending the positions < len0 + j. A verify query j
// therefore runs exactly the operations, in exactly the order, that the
// paged kernel runs for lens = pos + j + 1: the same chunk boundaries
// (the wrappers' split_plan depends on neither lens nor pos), the same
// tiles skipped, the same lane map, fmaf chains, shuffle trees and expf,
// the same q prescale and the same merge. That is what makes every verify
// query bitwise equal to a sequential decode step, the contract
// speculative decoding rests on. Every multiply and add of the softmax is
// an explicit intrinsic (fmaf, __fmul_rn, __fadd_rn, __fsub_rn), so no
// contraction choice of the compiler can differ between the two; both
// sources are built with the same NVCC_FLAGS (no fast math).
//
// Design, for the H100 (the bound is bytes: each live K/V row is read
// once for the whole GQA group, 4*hd flops per (query head, key) pair):
//   - The page axis is split over a thread-block cluster. Grid (n_chunks,
//     KV, B), clusters of n_chunks <= 8 along x: block c takes the whole
//     pages [c*chunk, min((c+1)*chunk, NP)) of its (row, kv head). Each
//     block has one warp per query row (rows = K*group), or warps of R
//     rows each (launch_r says when).
//   - Block table first. A block reads its run of block_table[b, :] into
//     shared memory, then the 32-key tiles of its chunk as bitmasks of
//     mapped keys (one ballot per tile). A tile is loaded only if it holds
//     a mapped key below the last query's length, and only those keys'
//     K/V rows: unmapped pages and positions past the length cost no
//     bytes. Entries >= P read the last page, as ref.py clamps them.
//   - 16-byte loads. A key's K and V rows (hd contiguous elements in the
//     pool's dtype, rows strided by KV*hd) go to shared memory by cp.async
//     16 bytes a thread, neighbouring threads on neighbouring addresses,
//     two tiles in flight (four 16-token pages), the int8 scales beside
//     them by 4-byte cp.async. Elements are converted to f32 (and
//     dequantised) in registers at use.
//   - Every lane busy. hd is a template parameter. A key's dot product is
//     spread over LPK = HD/8 lanes (4 x the largest power of two dividing
//     HD/32, so it divides 32), each holding 8 of q's dims per group of
//     8*LPK in registers, then a shuffle tree of log2(LPK) steps; a warp
//     scores 32/LPK keys at once. P.V reuses that mapping: each lane adds
//     its key's p * V into its own dims, and the lanes of different keys
//     are summed by shuffles once, at the end of the chunk.
//   - One launch, deterministic. Query row r is merged by block
//     r mod n_chunks. When every block of the cluster has finished its
//     chunk (a cluster barrier), each pushes its f32 partial (m, l, acc)
//     per row into the merging block's shared memory with stores; one more
//     cluster barrier makes them visible and keeps every block alive until
//     they have landed. The merger reads them in chunk order with weights
//     exp(m_c - M). The partials reuse the memory of the tiles, which are
//     dead by then, so every shape the wrappers take fits (at most 133 KB:
//     128 rows, hd 256, 8 chunks). No workspace, no atomics: the same
//     inputs give the same bits on every launch.
//   - A row with no valid key loads nothing: every chunk's partial is
//     (kNegInf, 0, 0), so M = kNegInf, each weight exp(0) = 1, l = 0 is
//     taken as 1 and the row outputs exactly 0, as ref.py does. A chunk
//     with no valid key for a row that has one adds exp(kNegInf - M) * 0.
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace paged_softmax {

namespace cg = cooperative_groups;

constexpr float kNegInf = -1e30f;
constexpr int kTile = 32;         // keys per tile: one mask bit per lane
constexpr int kStages = 2;        // tiles in flight per block
constexpr int kMaxChunks = 8;     // the portable cluster size
constexpr int kMaxHd = 256;
constexpr int kMaxWarps = 32;

// Lane geometry for head width HD: LPK lanes share a key, each holding
// NG groups of 8 dims; a warp covers KPS keys per step, a tile in kSteps.
template <int HD>
struct Lanes {
  static constexpr int kM = HD / 32;
  static constexpr int kLPK = 4 * (kM & -kM);
  static constexpr int kNG = HD / (8 * kLPK);
  static constexpr int kKPS = 32 / kLPK;
  static constexpr int kSteps = kTile / kKPS;
  static constexpr int kDims = 8 * kNG;          // q / acc values a lane
  static_assert(HD % 32 == 0 && kNG * 8 * kLPK == HD, "hd a multiple of 32");
};

// What both kernels pass: `len` is lens (paged) or pos (verify).
struct Args {
  const void* q;
  const void* k;
  const void* v;
  const float* ks;
  const float* vs;
  const int* bt;
  const int* len;
  void* out;
  int K, KV, group, P, ps, NP, chunk;
  float scale;
  int q_bf16;
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

__device__ __forceinline__ void load8(const int8_t* p, float (&x)[8]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[i] = static_cast<float>(static_cast<int8_t>(u.x >> (8 * i)));
    x[4 + i] = static_cast<float>(static_cast<int8_t>(u.y >> (8 * i)));
  }
}

// The two halves of a cluster barrier (release, then acquire).
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
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
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
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

// Bits of the keys below n of a 32-key tile.
__device__ __forceinline__ uint32_t below(int n) {
  return n <= 0 ? 0u : n >= kTile ? 0xffffffffu : (1u << n) - 1u;
}

// Shared memory: the chunk's block-table run and tile masks (each rounded
// up to 16 bytes), then the tile stages, whose bytes the merge partials
// reuse. The same layout in every block of a cluster.
__host__ __device__ __forceinline__ int round4(int n) { return (n + 3) & ~3; }
__host__ __device__ __forceinline__ int header_words(int chunk, int ps) {
  return round4(chunk) + round4((chunk * ps + kTile - 1) / kTile);
}
template <typename KT, int HD>
__host__ __device__ __forceinline__ size_t stage_bytes() {
  return 2 * kTile * HD * sizeof(KT) +
         (std::is_same<KT, int8_t>::value ? 2 * kTile * sizeof(float) : 0);
}
template <typename KT, int HD>
__host__ __device__ __forceinline__ size_t smem_bytes(int chunk, int ps,
                                                      int rows,
                                                      int n_chunks) {
  const size_t stages = kStages * stage_bytes<KT, HD>();
  const size_t recv = static_cast<size_t>(n_chunks) *
                      ((rows + n_chunks - 1) / n_chunks) * (HD + 4) *
                      sizeof(float);
  return header_words(chunk, ps) * sizeof(int) +
         (stages > recv ? stages : recv);
}

// One warp folds one tile into the running (m, l, acc) of each of its R
// query rows; vm[i] holds row i's valid keys of the tile (a row whose vm
// is 0 is left as it is). l and acc are partial per key slot until the
// chunk ends. The rows share each K/V load and its conversion, and their
// chains are interleaved; each row's own operations, and their order, are
// those of R = 1: a row's bits do not depend on R or on its neighbours.
template <typename KT, int HD, int R>
__device__ __forceinline__ void tile_update(
    const float (&qr)[R][Lanes<HD>::kDims], const KT* kt, const KT* vt,
    const float* ksc, const float* vsc, const uint32_t (&vm)[R], int lane,
    float (&m_run)[R], float (&l_part)[R],
    float (&acc)[R][Lanes<HD>::kDims]) {
  using G = Lanes<HD>;
  constexpr int kLPK = G::kLPK, kNG = G::kNG, kKPS = G::kKPS;
  constexpr bool kQuant = std::is_same<KT, int8_t>::value;
  const int dl = 8 * (lane % kLPK);
  const int slot = lane / kLPK;
  uint32_t any_vm = 0;
#pragma unroll
  for (int r = 0; r < R; ++r) any_vm |= vm[r];
  float sc[R][G::kSteps], mx[R];
#pragma unroll
  for (int r = 0; r < R; ++r) mx[r] = -INFINITY;
#pragma unroll
  for (int step = 0; step < G::kSteps; ++step) {
    const int kk = step * kKPS + slot;
    float dot[R];
#pragma unroll
    for (int r = 0; r < R; ++r) dot[r] = 0.f;
    if ((any_vm >> kk) & 1u) {        // loaded: some row reads this key
#pragma unroll
      for (int i = 0; i < kNG; ++i) {
        float x[8];
        load8(kt + kk * HD + i * 8 * kLPK + dl, x);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float kx = kQuant ? __fmul_rn(x[e], ksc[kk]) : x[e];
#pragma unroll
          for (int r = 0; r < R; ++r)
            dot[r] = fmaf(qr[r][i * 8 + e], kx, dot[r]);
        }
      }
    }
#pragma unroll
    for (int o = kLPK / 2; o > 0; o >>= 1)
#pragma unroll
      for (int r = 0; r < R; ++r)
        dot[r] = __fadd_rn(dot[r], __shfl_xor_sync(0xffffffffu, dot[r], o));
#pragma unroll
    for (int r = 0; r < R; ++r) {
      sc[r][step] = ((vm[r] >> kk) & 1u) ? dot[r] : -INFINITY;
      mx[r] = fmaxf(mx[r], sc[r][step]);
    }
  }
#pragma unroll
  for (int o = kLPK; o < 32; o <<= 1)
#pragma unroll
    for (int r = 0; r < R; ++r)
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], o));
  float m_new[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m_new[r] = fmaxf(m_run[r], mx[r]);
    if (vm[r] == 0) continue;
    const float alpha = expf(__fsub_rn(m_run[r], m_new[r]));
    m_run[r] = m_new[r];
    l_part[r] = __fmul_rn(l_part[r], alpha);
#pragma unroll
    for (int e = 0; e < G::kDims; ++e)
      acc[r][e] = __fmul_rn(acc[r][e], alpha);
  }
#pragma unroll
  for (int step = 0; step < G::kSteps; ++step) {
    const int kk = step * kKPS + slot;
    if (!((any_vm >> kk) & 1u)) continue;
    float p[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      p[r] = 0.f;
      if ((vm[r] >> kk) & 1u) {
        p[r] = expf(__fsub_rn(sc[r][step], m_new[r]));
        l_part[r] = __fadd_rn(l_part[r], p[r]);
      }
    }
#pragma unroll
    for (int i = 0; i < kNG; ++i) {
      float x[8];
      load8(vt + kk * HD + i * 8 * kLPK + dl, x);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float vx = kQuant ? __fmul_rn(x[e], vsc[kk]) : x[e];
#pragma unroll
        for (int r = 0; r < R; ++r)
          if ((vm[r] >> kk) & 1u)
            acc[r][i * 8 + e] = fmaf(p[r], vx, acc[r][i * 8 + e]);
      }
    }
  }
}

// The block body: chunk blockIdx.x of (row blockIdx.z, kv head blockIdx.y)
// for the K*group query rows, row r = j*group + g (chunk position j, GQA
// member g), read from q (B, K, KV*group, HD) and written to out in place.
// Query j attends the mapped positions < len0 + j.
template <typename KT, int HD, int R>
__device__ __forceinline__ void attend(const Args& a, int len0) {
  using G = Lanes<HD>;
  constexpr int kLPK = G::kLPK, kNG = G::kNG, kDims = G::kDims;
  constexpr bool kQuant = std::is_same<KT, int8_t>::value;
  constexpr int kVpr = HD * static_cast<int>(sizeof(KT)) / 16;  // per row
  extern __shared__ __align__(16) uint8_t smem[];
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int n_chunks = gridDim.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5, nthreads = blockDim.x;
  const int K = a.K, KV = a.KV, group = a.group, ps = a.ps;
  const int rows = K * group, H = KV * group;
  const int p0 = c * a.chunk;
  const int n_keys = max(min(a.chunk, a.NP - p0), 0) * ps;
  const int n_ct = (n_keys + kTile - 1) / kTile;   // tiles in the chunk
  const int pos0 = p0 * ps;            // position of the chunk's first key
  const int load_len = len0 + K - 1;   // the last query's length
  int* bt_s = reinterpret_cast<int*>(smem);
  uint32_t* mask_s = reinterpret_cast<uint32_t*>(smem) + round4(a.chunk);
  uint8_t* region = smem + header_words(a.chunk, ps) * sizeof(int);
  cg::cluster_group cluster = cg::this_cluster();

  // The chunk's block-table run; q's bits arrive meanwhile.
  for (int i = threadIdx.x; i < n_keys / ps; i += nthreads)
    bt_s[i] = a.bt[static_cast<size_t>(b) * a.NP + p0 + i];

  const int dl = 8 * (lane % kLPK);
  const int slot = lane / kLPK;
  float qr[R][kDims], acc[R][kDims], m_run[R], l_part[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = warp + i * nwarps;
    const int j = r / group;
    const size_t qoff =
        (((static_cast<size_t>(b) * K + j) * H) + h * group + r - j * group) *
            HD + dl;
    m_run[i] = kNegInf;
    l_part[i] = 0.f;
#pragma unroll
    for (int ii = 0; ii < kNG; ++ii)
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const size_t idx = qoff + ii * 8 * kLPK + e;
        float x = 0.f;
        if (r < rows)
          x = a.q_bf16 ? __bfloat162float(
                             static_cast<const __nv_bfloat16*>(a.q)[idx])
                       : static_cast<const float*>(a.q)[idx];
        qr[i][ii * 8 + e] = __fmul_rn(x, a.scale);
        acc[i][ii * 8 + e] = 0.f;
      }
  }
  __syncthreads();

  // One ballot per tile: bit k is set when key k maps to a page.
  for (int t = warp; t < n_ct; t += nwarps) {
    const int kk = t * kTile + lane;
    const uint32_t bal =
        __ballot_sync(0xffffffffu, kk < n_keys && bt_s[kk / ps] >= 0);
    if (lane == 0) mask_s[t] = bal;
  }
  __syncthreads();

  // the keys of tile t that some query reads
  auto loads = [&](int t) {
    return mask_s[t] & below(load_len - pos0 - t * kTile);
  };
  auto next_tile = [&](int t) {
    while (t < n_ct && loads(t) == 0) ++t;
    return t;
  };
  // the pool row (page, position, kv head) of the chunk's key kk
  auto pool_row = [&](int kk) {
    const int pi = kk / ps;
    return (static_cast<size_t>(min(bt_s[pi], a.P - 1)) * ps + kk -
            pi * ps) * KV + h;
  };
  auto issue = [&](int t, int st) {
    if (t >= n_ct) return;
    const uint32_t lm = loads(t);
    uint8_t* dst = region + st * stage_bytes<KT, HD>();
    for (int i = threadIdx.x; i < 2 * kTile * kVpr; i += nthreads) {
      const int tsr = i / (kTile * kVpr), rr = i - tsr * kTile * kVpr;
      const int key = rr / kVpr, vv = rr - key * kVpr;
      if (!((lm >> key) & 1u)) continue;
      const KT* src = static_cast<const KT*>(tsr ? a.v : a.k) +
                      pool_row(t * kTile + key) * HD;
      cp_async16(dst + (tsr * kTile + key) * HD * sizeof(KT) + vv * 16,
                 reinterpret_cast<const uint8_t*>(src) + vv * 16);
    }
    if (kQuant) {
      float* sdst = reinterpret_cast<float*>(dst + 2 * kTile * HD *
                                             sizeof(KT));
      for (int i = threadIdx.x; i < 2 * kTile; i += nthreads) {
        const int tsr = i / kTile, key = i - tsr * kTile;
        if ((lm >> key) & 1u)
          cp_async4(sdst + i, (tsr ? a.vs : a.ks) + pool_row(t * kTile + key));
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
    const int t0 = pos0 + cur * kTile;
    const uint32_t mapped = mask_s[cur];
    const uint8_t* base = region + st * stage_bytes<KT, HD>();
    const KT* kt = reinterpret_cast<const KT*>(base);
    const KT* vt = kt + kTile * HD;
    const float* ksc = reinterpret_cast<const float*>(vt + kTile * HD);
    uint32_t vm[R], any_vm = 0;
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int r = warp + i * nwarps;
      vm[i] = r < rows ? mapped & below(len0 + r / group - t0) : 0u;
      any_vm |= vm[i];
    }
    if (any_vm)
      tile_update<KT, HD, R>(qr, kt, vt, ksc, ksc + kTile, vm, lane, m_run,
                             l_part, acc);
    __syncthreads();   // every warp is done with stage st
    const int nn = nxt < n_ct ? next_tile(nxt + 1) : n_ct;
    issue(nn, st);
    cp_async_commit();
    cur = nxt;
    nxt = nn;
  }
  cp_async_wait<0>();

  // The lanes of a row's key slots hold partial sums of l and acc: sum
  // them (every lane ends with the totals of its dims).
#pragma unroll
  for (int i = 0; i < R; ++i) {
    if (warp + i * nwarps >= rows) continue;
#pragma unroll
    for (int o = kLPK; o < 32; o <<= 1) {
      l_part[i] = __fadd_rn(l_part[i],
                            __shfl_xor_sync(0xffffffffu, l_part[i], o));
#pragma unroll
      for (int e = 0; e < kDims; ++e)
        acc[i][e] = __fadd_rn(acc[i][e],
                              __shfl_xor_sync(0xffffffffu, acc[i][e], o));
    }
  }

  // Every block of the cluster is done with its tiles (and has started):
  // push each row's partial into its merger's shared memory, where the
  // tiles were; the next barrier makes the pushes visible and keeps every
  // block's shared memory alive until they have landed.
  cluster_arrive();
  cluster_wait();
  float* recv = reinterpret_cast<float*>(region);
  const int rpb = (rows + n_chunks - 1) / n_chunks;   // rows per merger
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = warp + i * nwarps;
    if (r >= rows) continue;
    float* dst = cluster.map_shared_rank(recv, r % n_chunks) +
                 (c * rpb + r / n_chunks) * (HD + 4);
    if (slot == 0) {
#pragma unroll
      for (int ii = 0; ii < kNG; ++ii) {
        float* d = dst + ii * 8 * kLPK + dl;
        const float* s = acc[i] + ii * 8;
        *reinterpret_cast<float4*>(d) = make_float4(s[0], s[1], s[2], s[3]);
        *reinterpret_cast<float4*>(d + 4) =
            make_float4(s[4], s[5], s[6], s[7]);
      }
    }
    if (lane == 0) {
      dst[HD] = m_run[i];
      dst[HD + 1] = l_part[i];
    }
  }
  cluster.sync();

  // Row s*n_chunks + c merged over the chunks in order, from this block's
  // own shared memory; a row with no valid key outputs 0.
  for (int s = warp; s < rpb; s += nwarps) {
    const int r = s * n_chunks + c;
    if (r >= rows) break;
    const float* src = recv + s * (HD + 4);
    const int cs = rpb * (HD + 4);               // stride between chunks
    float M = kNegInf;
    for (int cc = 0; cc < n_chunks; ++cc) M = fmaxf(M, src[cc * cs + HD]);
    float l = 0.f, o[HD / 32];
#pragma unroll
    for (int i = 0; i < HD / 32; ++i) o[i] = 0.f;
    for (int cc = 0; cc < n_chunks; ++cc) {
      const float* pa = src + cc * cs;
      const float w = expf(__fsub_rn(pa[HD], M));
      l = fmaf(w, pa[HD + 1], l);
#pragma unroll
      for (int i = 0; i < HD / 32; ++i)
        o[i] = fmaf(w, pa[lane + 32 * i], o[i]);
    }
    if (l == 0.f) l = 1.f;
    const int j = r / group;
    const size_t ooff =
        (((static_cast<size_t>(b) * K + j) * H) + h * group + r - j * group) *
            HD + lane;
#pragma unroll
    for (int i = 0; i < HD / 32; ++i) {
      const float y = __fdiv_rn(o[i], l);
      if (a.q_bf16)
        static_cast<__nv_bfloat16*>(a.out)[ooff + 32 * i] =
            __float2bfloat16(y);
      else
        static_cast<float*>(a.out)[ooff + 32 * i] = y;
    }
  }
}

// Host side: launch Kern<KT, HD, R, kThreads>::fn() (a kernel of at most
// kThreads threads that calls `attend`) as one cluster of n_chunks blocks
// per (row, kv head).
template <template <typename, int, int, int> class Kern, typename KT,
          int HD, int R, int kThreads>
int launch(const Args& a, int B, int n_chunks, cudaStream_t stream) {
  const int rows = a.K * a.group;
  const int nwarps = (rows + R - 1) / R;
  if (32 * nwarps > kThreads) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes<KT, HD>(a.chunk, a.ps, rows, n_chunks);
  auto kern = Kern<KT, HD, R, kThreads>::fn();
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_chunks, a.KV, B);
  cfg.blockDim = dim3(32 * nwarps, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n_chunks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, kern, a);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// Rows per warp. One warp per row (the paged kernel, kMaxR = 1: up to 32
// rows). The verify kernel (kMaxR = 4) keeps that up to 8 rows, then
// gives each warp 2 rows that share each K/V load, at 64 registers so
// that two blocks share an SM (at its main shape, 28 rows on 14 warps;
// on an H100 that beat 28 warps of one row, one block an SM, and 7 warps
// of four rows); past 32 rows, up to 32 warps of 4 rows. The per-row
// arithmetic is the same under every choice.
template <template <typename, int, int, int> class Kern, int kMaxR,
          typename KT, int HD>
int launch_r(const Args& a, int B, int n_chunks, cudaStream_t s) {
  const int rows = a.K * a.group;
  if (kMaxR == 1 || rows <= 8)
    return launch<Kern, KT, HD, 1, 1024>(a, B, n_chunks, s);
  if constexpr (kMaxR >= 4) {
    if (rows <= 32) return launch<Kern, KT, HD, 2, 512>(a, B, n_chunks, s);
    return launch<Kern, KT, HD, 4, 1024>(a, B, n_chunks, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <template <typename, int, int, int> class Kern, int kMaxR,
          typename KT>
int launch_hd(int hd, const Args& a, int B, int n_chunks, cudaStream_t s) {
#define PS_CASE(HD) \
  case HD:          \
    return launch_r<Kern, kMaxR, KT, HD>(a, B, n_chunks, s);
  switch (hd) {
    PS_CASE(32) PS_CASE(64) PS_CASE(96) PS_CASE(128)
    PS_CASE(160) PS_CASE(192) PS_CASE(224) PS_CASE(256)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef PS_CASE
}

// The launch for pools of element type KT (q float32 or bfloat16, dtype
// code 0 or 1). Checks the plan (whole pages, none empty, at most
// kMaxChunks) and the shape.
template <template <typename, int, int, int> class Kern, int kMaxR,
          typename KT>
int launch_kv(Args a, int B, int hd, int n_chunks, int q_dtype,
              void* stream) {
  if (B == 0 || a.KV == 0 || a.K == 0) return 0;
  const int np = a.NP > 0 ? a.NP : 1;
  if (a.K < 0 || a.group < 1 || a.K * a.group > kMaxR * kMaxWarps ||
      hd % 32 != 0 || hd > kMaxHd || a.ps < 1 || a.chunk < 1 ||
      n_chunks < 1 || n_chunks > kMaxChunks ||
      static_cast<long long>(a.chunk) * n_chunks < np ||
      static_cast<long long>(a.chunk) * (n_chunks - 1) >= np ||
      (q_dtype != 0 && q_dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  a.scale = 1.0f / sqrtf(static_cast<float>(hd));
  a.q_bf16 = q_dtype;
  return launch_hd<Kern, kMaxR, KT>(hd, a, B, n_chunks,
                                    static_cast<cudaStream_t>(stream));
}

// dtype codes: 0 = float32, 1 = bfloat16, 2 = int8 (pools only).
template <template <typename, int, int, int> class Kern, int kMaxR>
int launch_all(Args a, int B, int hd, int n_chunks, int q_dtype,
               int kv_dtype, void* stream) {
  switch (kv_dtype) {
    case 0:
      return launch_kv<Kern, kMaxR, float>(a, B, hd, n_chunks, q_dtype,
                                           stream);
    case 1:
      return launch_kv<Kern, kMaxR, __nv_bfloat16>(a, B, hd, n_chunks,
                                                   q_dtype, stream);
    case 2:
      return launch_kv<Kern, kMaxR, int8_t>(a, B, hd, n_chunks, q_dtype,
                                            stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace paged_softmax
