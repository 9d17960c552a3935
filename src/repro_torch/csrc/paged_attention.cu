// Paged decode attention for Hopper (sm_90a), plain C entry point.
//
// Replaces: the Pallas TPU kernel `_paged_decode_kernel` in
//   src/repro/kernels/paged_attention/kernel.py (wrapper
//   `paged_decode_attention_bkgd`), called once per layer per decoded token
//   from `models/layers.paged_decode_attention`.
//
// Computes: for each row b and kv head h, the `group` query heads that
//   share h attend over the row's pages in the shared pool
//   (P, ps, KV, hd), read through block_table[b, :]. A position is valid
//   when idx < lens[b] and the page entry is >= 0; masked positions add
//   exactly 0 and a row with no valid position outputs 0. Pools are f32,
//   bf16, or int8 dequantised in registers by the (P, ps, KV) f32 scales.
//   All arithmetic is f32; the output takes q's dtype.
//
// What bounds it: bytes. A decode step does 4*group*hd flops per K/V
//   element it reads (GQA group 7, hd 64 for qwen2-0.5b), far below the
//   card's operations-per-byte balance, so the floor is reading each live
//   page once from device memory.
//
// Design: one block per (row, kv head); each page of the row is loaded
//   once into shared memory (converted to f32, dequantised) and shared by
//   the GQA group's query heads, one warp per head, each running an f32
//   online softmax with its output accumulator in registers (that per-row
//   arithmetic lives in paged_softmax.cuh, shared with spec_verify.cu).
//   Only the pages that hold positions < lens[b] are touched, and unmapped
//   entries are skipped. Tile rows are padded to hd+1 floats so the per-position
//   dot products read shared memory without bank conflicts. No split of
//   the page axis yet: at B=32, KV=2 this is 64 blocks for 132 SMs, so a
//   flash-decoding split with a combine pass is the first speed-up to try.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "paged_softmax.cuh"

namespace {

using paged_softmax::kLaneD;
using paged_softmax::kMaxHd;
using paged_softmax::kNegInf;

template <typename QT, typename KT>
__global__ void paged_decode_kernel(
    const QT* __restrict__ q, const KT* __restrict__ kp,
    const KT* __restrict__ vp, const float* __restrict__ ks,
    const float* __restrict__ vs, const int* __restrict__ bt,
    const int* __restrict__ lens, QT* __restrict__ out, int KV, int group,
    int hd, int P, int ps, int NP, float scale) {
  extern __shared__ float smem[];
  const int b = blockIdx.x / KV;
  const int h = blockIdx.x - b * KV;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nthreads = blockDim.x;
  const int stride = hd + 1;
  float* k_s = smem;                    // (ps, hd+1)
  float* v_s = k_s + ps * stride;       // (ps, hd+1)
  float* q_s = v_s + ps * stride;       // (group, hd), prescaled
  float* p_s = q_s + group * hd;        // (group, ps) scores / probs

  const QT* qrow = q + (static_cast<size_t>(b) * KV + h) * group * hd;
  for (int i = threadIdx.x; i < group * hd; i += nthreads)
    q_s[i] = paged_softmax::to_f(qrow[i]) * scale;

  const int len = lens[b];
  int n_pages = (len + ps - 1) / ps;
  n_pages = n_pages > NP ? NP : (n_pages < 0 ? 0 : n_pages);
  const int* btrow = bt + static_cast<size_t>(b) * NP;

  float m_run = kNegInf, l_run = 0.f;
  float acc[kLaneD];
#pragma unroll
  for (int i = 0; i < kLaneD; ++i) acc[i] = 0.f;

  for (int pi = 0; pi < n_pages; ++pi) {
    const int page = btrow[pi];
    if (page < 0) continue;   // unmapped: fully masked, adds exactly 0
    const int pg = page < P ? page : P - 1;
    __syncthreads();          // the previous tile is fully consumed
    paged_softmax::load_page(kp, vp, ks, vs, pg, h, KV, hd, ps, k_s, v_s);
    __syncthreads();
    if (warp < group)
      paged_softmax::page_update(q_s + warp * hd, k_s, v_s, p_s + warp * ps,
                                 ps, hd, lane, pi * ps, len, m_run, l_run,
                                 acc);
  }
  if (warp < group)
    paged_softmax::store_row(
        out + ((static_cast<size_t>(b) * KV + h) * group + warp) * hd, acc,
        l_run, hd, lane);
}

template <typename QT, typename KT>
int launch(const void* q, const void* k, const void* v, const void* ks,
           const void* vs, const void* bt, const void* lens, void* out,
           int B, int KV, int group, int hd, int P, int ps, int NP,
           cudaStream_t stream) {
  const size_t smem =
      (2 * static_cast<size_t>(ps) * (hd + 1) + group * hd + group * ps) *
      sizeof(float);
  auto kern = paged_decode_kernel<QT, KT>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const float scale = 1.0f / sqrtf(static_cast<float>(hd));
  kern<<<B * KV, 32 * group, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KT*>(k),
      static_cast<const KT*>(v), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int*>(bt),
      static_cast<const int*>(lens), static_cast<QT*>(out), KV, group, hd, P,
      ps, NP, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename QT>
int launch_q(int kv_dtype, const void* q, const void* k, const void* v,
             const void* ks, const void* vs, const void* bt,
             const void* lens, void* out, int B, int KV, int group, int hd,
             int P, int ps, int NP, cudaStream_t s) {
  switch (kv_dtype) {
    case 0:
      return launch<QT, float>(q, k, v, ks, vs, bt, lens, out, B, KV, group,
                               hd, P, ps, NP, s);
    case 1:
      return launch<QT, __nv_bfloat16>(q, k, v, ks, vs, bt, lens, out, B, KV,
                                       group, hd, P, ps, NP, s);
    case 2:
      return launch<QT, int8_t>(q, k, v, ks, vs, bt, lens, out, B, KV, group,
                                hd, P, ps, NP, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16, 2 = int8 (pools only).
// Returns the cudaError_t of the launch (0 = success).
extern "C" int paged_attention_launch(
    const void* q, const void* k, const void* v, const void* k_scales,
    const void* v_scales, const void* block_table, const void* lens,
    void* out, int B, int KV, int group, int hd, int P, int ps, int NP,
    int q_dtype, int kv_dtype, void* stream) {
  if (B == 0 || KV == 0) return 0;
  if (group < 1 || group > 32 || hd % 32 != 0 || hd > kMaxHd || ps < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (q_dtype) {
    case 0:
      return launch_q<float>(kv_dtype, q, k, v, k_scales, v_scales,
                             block_table, lens, out, B, KV, group, hd, P, ps,
                             NP, s);
    case 1:
      return launch_q<__nv_bfloat16>(kv_dtype, q, k, v, k_scales, v_scales,
                                     block_table, lens, out, B, KV, group, hd,
                                     P, ps, NP, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
