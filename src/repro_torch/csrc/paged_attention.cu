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
//   online softmax with its output accumulator in registers. Only the
//   pages that hold positions < lens[b] are touched, and unmapped entries
//   are skipped. Tile rows are padded to hd+1 floats so the per-position
//   dot products read shared memory without bank conflicts. No split of
//   the page axis yet: at B=32, KV=2 this is 64 blocks for 132 SMs, so a
//   flash-decoding split with a combine pass is the first speed-up to try.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

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
    q_s[i] = to_f(qrow[i]) * scale;

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
    const size_t base = static_cast<size_t>(pg) * ps * KV * hd;
    for (int i = threadIdx.x; i < ps * hd; i += nthreads) {
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
    __syncthreads();
    if (warp < group) {
      float* pw = p_s + warp * ps;
      const float* qg = q_s + warp * hd;
      float smax = kNegInf;
      for (int j = lane; j < ps; j += 32) {
        float s = kNegInf;
        if (pi * ps + j < len) {
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
        const float p = (pi * ps + j < len) ? expf(pw[j] - m_new) : 0.f;
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
  }
  if (warp < group) {
    const float l = (l_run == 0.f) ? 1.f : l_run;   // fully masked row -> 0
    QT* orow = out + ((static_cast<size_t>(b) * KV + h) * group + warp) * hd;
#pragma unroll
    for (int i = 0; i < kLaneD; ++i) {
      const int d = lane + 32 * i;
      if (d < hd) store_f(&orow[d], acc[i] / l);
    }
  }
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
