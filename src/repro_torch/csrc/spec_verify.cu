// Speculative verify attention for Hopper (sm_90a), plain C entry point.
//
// Replaces: the Pallas TPU kernel `_spec_verify_kernel` in
//   src/repro/kernels/spec_verify/kernel.py:44 (wrapper
//   `spec_verify_attention_bkgd`), called once per layer per verify round
//   from `models/layers.spec_verify_chunk_attention`.
//
// Computes: for each row b and kv head h, the K chunk queries of the
//   `group` query heads that share h, numbered position-major as the JAX
//   wrapper flattens them (row r = j*group + g is chunk position j, GQA
//   member g; read in place from q (B, K, H, hd)). Query j attends the
//   pool positions <= pos[b] + j on mapped pages of the shared pool
//   (P, ps, KV, hd) read through block_table[b, :]: the committed context
//   plus the chunk's own causal prefix, whose K/V the caller has already
//   written into the pool. A query with no valid position outputs 0. Pools
//   are f32, bf16, or int8 dequantised by the (P, ps, KV) f32 scales. All
//   arithmetic is f32; the output takes q's dtype.
//
// What bounds it: operations, at the spec path's shapes. Each page of K/V
//   is read once for all K*group query rows (K times the paged kernel's
//   arithmetic on the same bytes): at B=32, K=4, 14/2 heads, hd 64 and a
//   256-token context that is 4*hd flops per (query head, key) pair,
//   117 MFLOP, 1.75 us at the f32 rate, against 4.19 MB of K/V, 1.25 us at
//   the HBM rate.
//
// Design: the paged kernel's, with K*group rows in place of group. One
//   block per (row, kv head); each page the longest query needs is loaded
//   once into shared memory (f32, dequantised) and shared by every query
//   row. Warps stride over the rows (min(K*group, 32) warps, up to 4 rows
//   each, their (m, l, acc) in registers); each row runs paged_softmax.cuh's
//   page_update, the paged kernel's own code, over exactly the pages the
//   paged kernel visits for lens = pos + j + 1 (a page past the query's
//   last one is skipped, as the paged kernel's loop bound skips it). So
//   every query row is bitwise the paged kernel's output at that length,
//   the contract speculative decoding rests on. The page axis is not split
//   yet: at B=32, KV=2 this is 64 blocks for 132 SMs, as in the paged
//   kernel; a split with a combine pass, wgmma for the K*group x ps score
//   tile and TMA page loads are the speed-ups to try.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "paged_softmax.cuh"

namespace {

using paged_softmax::kLaneD;
using paged_softmax::kMaxHd;
using paged_softmax::kNegInf;

constexpr int kMaxWarps = 32;
constexpr int kMaxRowsPerWarp = 4;
constexpr int kMaxRows = kMaxWarps * kMaxRowsPerWarp;   // K * group

__device__ __forceinline__ int pages_for(int len, int ps, int NP) {
  int n = (len + ps - 1) / ps;
  return n > NP ? NP : (n < 0 ? 0 : n);
}

template <typename QT, typename KT, int R>
__global__ void __launch_bounds__(kMaxWarps * 32) spec_verify_kernel(
    const QT* __restrict__ q, const KT* __restrict__ kp,
    const KT* __restrict__ vp, const float* __restrict__ ks,
    const float* __restrict__ vs, const int* __restrict__ bt,
    const int* __restrict__ pos, QT* __restrict__ out, int K, int KV,
    int group, int hd, int P, int ps, int NP, float scale) {
  extern __shared__ float smem[];
  const int b = blockIdx.x / KV;
  const int h = blockIdx.x - b * KV;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  const int nthreads = blockDim.x;
  const int stride = hd + 1;
  const int kq = K * group;
  const int H = KV * group;
  float* k_s = smem;                    // (ps, hd+1)
  float* v_s = k_s + ps * stride;       // (ps, hd+1)
  float* q_s = v_s + ps * stride;       // (K*group, hd), prescaled
  float* p_s = q_s + kq * hd;           // (nwarps, ps) scores / probs

  for (int i = threadIdx.x; i < kq * hd; i += nthreads) {
    const int r = i / hd;
    const int d = i - r * hd;
    const int j = r / group;
    const size_t qi =
        ((static_cast<size_t>(b) * K + j) * H + h * group + (r - j * group)) *
            hd + d;
    q_s[i] = paged_softmax::to_f(q[qi]) * scale;
  }

  const int base = pos[b];
  const int n_pages = pages_for(base + K, ps, NP);   // the last query's
  const int* btrow = bt + static_cast<size_t>(b) * NP;

  float m_run[R], l_run[R];
  float acc[R][kLaneD];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    m_run[i] = kNegInf;
    l_run[i] = 0.f;
#pragma unroll
    for (int e = 0; e < kLaneD; ++e) acc[i][e] = 0.f;
  }

  for (int pi = 0; pi < n_pages; ++pi) {
    const int page = btrow[pi];
    if (page < 0) continue;   // unmapped: fully masked, adds exactly 0
    const int pg = page < P ? page : P - 1;
    __syncthreads();          // the previous tile is fully consumed
    paged_softmax::load_page(kp, vp, ks, vs, pg, h, KV, hd, ps, k_s, v_s);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int r = warp + i * nwarps;
      const int len = base + r / group + 1;     // query j = r / group
      if (r < kq && pi < pages_for(len, ps, NP)) {
        paged_softmax::page_update(q_s + r * hd, k_s, v_s, p_s + warp * ps,
                                   ps, hd, lane, pi * ps, len, m_run[i],
                                   l_run[i], acc[i]);
        __syncwarp();         // the warp's scratch row is reused next
      }
    }
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = warp + i * nwarps;
    if (r < kq) {
      const int j = r / group;
      paged_softmax::store_row(
          out + ((static_cast<size_t>(b) * K + j) * H + h * group +
                 (r - j * group)) * hd,
          acc[i], l_run[i], hd, lane);
    }
  }
}

template <typename QT, typename KT, int R>
int launch(const void* q, const void* k, const void* v, const void* ks,
           const void* vs, const void* bt, const void* pos, void* out,
           int B, int K, int KV, int group, int hd, int P, int ps, int NP,
           int nwarps, cudaStream_t stream) {
  const size_t smem = (2 * static_cast<size_t>(ps) * (hd + 1) +
                       static_cast<size_t>(K) * group * hd +
                       static_cast<size_t>(nwarps) * ps) * sizeof(float);
  auto kern = spec_verify_kernel<QT, KT, R>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const float scale = 1.0f / sqrtf(static_cast<float>(hd));
  kern<<<B * KV, 32 * nwarps, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KT*>(k),
      static_cast<const KT*>(v), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int*>(bt),
      static_cast<const int*>(pos), static_cast<QT*>(out), K, KV, group, hd,
      P, ps, NP, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename QT, typename KT>
int launch_r(const void* q, const void* k, const void* v, const void* ks,
             const void* vs, const void* bt, const void* pos, void* out,
             int B, int K, int KV, int group, int hd, int P, int ps, int NP,
             cudaStream_t s) {
  const int kq = K * group;
  const int nwarps = kq < kMaxWarps ? kq : kMaxWarps;
  const int rows = (kq + nwarps - 1) / nwarps;   // rows per warp
  if (rows <= 1)
    return launch<QT, KT, 1>(q, k, v, ks, vs, bt, pos, out, B, K, KV, group,
                             hd, P, ps, NP, nwarps, s);
  if (rows <= 2)
    return launch<QT, KT, 2>(q, k, v, ks, vs, bt, pos, out, B, K, KV, group,
                             hd, P, ps, NP, nwarps, s);
  return launch<QT, KT, kMaxRowsPerWarp>(q, k, v, ks, vs, bt, pos, out, B, K,
                                         KV, group, hd, P, ps, NP, nwarps, s);
}

template <typename QT>
int launch_q(int kv_dtype, const void* q, const void* k, const void* v,
             const void* ks, const void* vs, const void* bt, const void* pos,
             void* out, int B, int K, int KV, int group, int hd, int P,
             int ps, int NP, cudaStream_t s) {
  switch (kv_dtype) {
    case 0:
      return launch_r<QT, float>(q, k, v, ks, vs, bt, pos, out, B, K, KV,
                                 group, hd, P, ps, NP, s);
    case 1:
      return launch_r<QT, __nv_bfloat16>(q, k, v, ks, vs, bt, pos, out, B, K,
                                         KV, group, hd, P, ps, NP, s);
    case 2:
      return launch_r<QT, int8_t>(q, k, v, ks, vs, bt, pos, out, B, K, KV,
                                  group, hd, P, ps, NP, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16, 2 = int8 (pools only).
// Returns the cudaError_t of the launch (0 = success); shapes the kernel
// does not take (K*group above 128 rows, hd not a multiple of 32 up to
// 256) return cudaErrorInvalidValue, and a tile set above the card's
// shared memory returns the error of cudaFuncSetAttribute.
extern "C" int spec_verify_launch(
    const void* q, const void* k, const void* v, const void* k_scales,
    const void* v_scales, const void* block_table, const void* pos,
    void* out, int B, int K, int KV, int group, int hd, int P, int ps,
    int NP, int q_dtype, int kv_dtype, void* stream) {
  if (B == 0 || KV == 0 || K == 0) return 0;
  if (K < 0 || group < 1 || K * group > kMaxRows || hd % 32 != 0 ||
      hd > kMaxHd || ps < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (q_dtype) {
    case 0:
      return launch_q<float>(kv_dtype, q, k, v, k_scales, v_scales,
                             block_table, pos, out, B, K, KV, group, hd, P,
                             ps, NP, s);
    case 1:
      return launch_q<__nv_bfloat16>(kv_dtype, q, k, v, k_scales, v_scales,
                                     block_table, pos, out, B, K, KV, group,
                                     hd, P, ps, NP, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
