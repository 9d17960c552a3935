// The per-query-row arithmetic shared by the paged decode kernel
// (paged_attention.cu) and the speculative verify kernel (spec_verify.cu).
//
// One warp runs one query row's f32 online softmax over one page tile held
// in shared memory. Both kernels call the same functions, so a verify query
// j processes exactly the operations, in exactly the order, that the paged
// kernel runs for that row with lens = pos + j + 1: the same lane map
// (key j on lane j % 32, output dim lane + 32 i), the same fmaf chains, the
// same warp_max / warp_sum trees and the same expf. That is what makes
// every verify query bitwise equal to a sequential decode step. Both
// sources are built with the same NVCC_FLAGS (no fast math).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace paged_softmax {

constexpr float kNegInf = -1e30f;
constexpr int kMaxHd = 256;
constexpr int kLaneD = kMaxHd / 32;   // output dims owned by one lane

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(int8_t x) { return static_cast<float>(x); }

__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Loads page `pg` of kv head `h` into the (ps, hd+1) f32 tiles k_s / v_s,
// dequantising int8 by the (P, ps, KV) scales when ks is not null. All
// threads of the block take part; the caller syncs before and after.
template <typename KT>
__device__ __forceinline__ void load_page(
    const KT* __restrict__ kp, const KT* __restrict__ vp,
    const float* __restrict__ ks, const float* __restrict__ vs, int pg,
    int h, int KV, int hd, int ps, float* k_s, float* v_s) {
  const int stride = hd + 1;
  const size_t base = static_cast<size_t>(pg) * ps * KV * hd;
  for (int i = threadIdx.x; i < ps * hd; i += blockDim.x) {
    const int j = i / hd;
    const int d = i - j * hd;
    const size_t off = base + (static_cast<size_t>(j) * KV + h) * hd + d;
    float kx = to_f(kp[off]);
    float vx = to_f(vp[off]);
    if (ks != nullptr) {
      const size_t so = (static_cast<size_t>(pg) * ps + j) * KV + h;
      kx *= ks[so];
      vx *= vs[so];
    }
    k_s[j * stride + d] = kx;
    v_s[j * stride + d] = vx;
  }
}

// One warp folds one page into one query row's running (m, l, acc).
// qg: the row's prescaled query (hd floats); pw: ps floats of scratch
// owned by the warp; pos0: the absolute position of the tile's first key;
// len: the row attends positions < len.
__device__ __forceinline__ void page_update(
    const float* qg, const float* k_s, const float* v_s, float* pw, int ps,
    int hd, int lane, int pos0, int len, float& m_run, float& l_run,
    float (&acc)[kLaneD]) {
  const int stride = hd + 1;
  float smax = kNegInf;
  for (int j = lane; j < ps; j += 32) {
    float s = kNegInf;
    if (pos0 + j < len) {
      const float* kj = k_s + j * stride;
      float dot = 0.f;
      for (int d = 0; d < hd; ++d) dot = fmaf(qg[d], kj[d], dot);
      s = dot;
    }
    pw[j] = s;
    smax = fmaxf(smax, s);
  }
  smax = warp_max(smax);
  const float m_new = fmaxf(m_run, smax);
  float psum = 0.f;
  for (int j = lane; j < ps; j += 32) {
    const float p = (pos0 + j < len) ? expf(pw[j] - m_new) : 0.f;
    pw[j] = p;
    psum += p;
  }
  psum = warp_sum(psum);
  const float alpha = expf(m_run - m_new);
  __syncwarp();
#pragma unroll
  for (int i = 0; i < kLaneD; ++i) {
    const int d = lane + 32 * i;
    if (d < hd) {
      float a = acc[i] * alpha;
      for (int j = 0; j < ps; ++j) a = fmaf(pw[j], v_s[j * stride + d], a);
      acc[i] = a;
    }
  }
  l_run = alpha * l_run + psum;
  m_run = m_new;
}

// Writes acc / l for one row (a row with no valid position outputs 0).
template <typename QT>
__device__ __forceinline__ void store_row(QT* orow, const float (&acc)[kLaneD],
                                          float l_run, int hd, int lane) {
  const float l = (l_run == 0.f) ? 1.f : l_run;
#pragma unroll
  for (int i = 0; i < kLaneD; ++i) {
    const int d = lane + 32 * i;
    if (d < hd) store_f(&orow[d], acc[i] / l);
  }
}

}  // namespace paged_softmax
