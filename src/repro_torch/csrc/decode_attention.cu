// Split-K decode attention over a dense KV cache for Hopper (sm_90a),
// plain C entry point.
//
// Replaces: the Pallas TPU kernel `_decode_kernel` in
//   src/repro/kernels/decode_attention/kernel.py:28 (wrapper
//   `decode_attention_bkgd`), called once per layer per decoded token from
//   `models/layers.decode_attention` with attn_impl="pallas". On the TPU
//   the sequence axis is a sequential grid dimension carrying (m, l, acc)
//   in VMEM scratch; its docstring names the CUDA split-K flash-decode as
//   the form it replaced, and this is that form.
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
//   3.35 TB/s.
//
// Design: (row, kv head) pairs alone are 64 blocks at B=32 for 132 SMs, so
//   the S axis is split into chunks of whole 32-key tiles (the wrapper
//   picks the chunk so the grid holds about four blocks per SM). Pass 1:
//   one block per (chunk, kv head, row) loads each K/V tile once into
//   shared memory for the whole GQA group, one warp per query head runs an
//   f32 online softmax over the chunk (one key per lane for the scores,
//   lanes own output dims for P.V) and writes its partial (m, l, acc) to a
//   workspace. A chunk with no valid key carries m = -1e30 and l = its
//   length. Pass 2: one block per (row, kv head) merges the partials with
//   weights exp(m_i - M), which wipes such chunks whenever the row has a
//   valid key and keeps them all when it has none. Keys past S (the
//   ragged last tile) add exactly 0. Tile rows are padded to hd+1 floats
//   so the per-key dot products read shared memory without bank conflicts.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kTile = 32;             // keys per tile: one per lane
constexpr int kMaxHd = 256;
constexpr int kLaneD = kMaxHd / 32;   // output dims owned by one lane

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

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

// Pass 1: grid (n_chunks, KV, B), 32 * group threads.
template <typename QT, typename KT>
__global__ void decode_split_kernel(
    const QT* __restrict__ q, const KT* __restrict__ k,
    const KT* __restrict__ v, const uint8_t* __restrict__ valid,
    float* __restrict__ ws_m, float* __restrict__ ws_l,
    float* __restrict__ ws_acc, int S, int KV, int group, int hd, int chunk,
    int n_chunks, long long k_sb, long long k_ss, long long v_sb,
    long long v_ss, float scale) {
  extern __shared__ float smem[];
  const int c = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nthreads = blockDim.x;
  const int stride = hd + 1;
  float* k_s = smem;                    // (kTile, hd+1)
  float* v_s = k_s + kTile * stride;    // (kTile, hd+1)
  float* q_s = v_s + kTile * stride;    // (group, hd), prescaled
  float* p_s = q_s + group * hd;        // (group, kTile) probabilities

  const QT* qrow = q + (static_cast<size_t>(b) * KV + h) * group * hd;
  for (int i = threadIdx.x; i < group * hd; i += nthreads)
    q_s[i] = to_f(qrow[i]) * scale;

  const KT* kb = k + b * k_sb + static_cast<long long>(h) * hd;
  const KT* vb = v + b * v_sb + static_cast<long long>(h) * hd;
  const uint8_t* vrow = valid + static_cast<size_t>(b) * S;
  const int s0 = c * chunk;
  const int s_end = min(s0 + chunk, S);

  float m_run = kNegInf, l_run = 0.f;
  float acc[kLaneD];
#pragma unroll
  for (int i = 0; i < kLaneD; ++i) acc[i] = 0.f;

  for (int t0 = s0; t0 < s_end; t0 += kTile) {
    const int n = min(kTile, s_end - t0);
    __syncthreads();          // the previous tile is fully consumed
    for (int i = threadIdx.x; i < n * hd; i += nthreads) {
      const int j = i / hd;
      const int d = i - j * hd;
      k_s[j * stride + d] = to_f(kb[(t0 + j) * k_ss + d]);
      v_s[j * stride + d] = to_f(vb[(t0 + j) * v_ss + d]);
    }
    __syncthreads();
    if (warp < group) {
      float* pw = p_s + warp * kTile;
      const float* qg = q_s + warp * hd;
      const bool in_range = lane < n;
      float s = kNegInf;
      if (in_range && vrow[t0 + lane]) {
        const float* kj = k_s + lane * stride;
        float dot = 0.f;
        for (int d = 0; d < hd; ++d) dot = fmaf(qg[d], kj[d], dot);
        s = dot;
      }
      const float m_new = fmaxf(m_run, warp_max(s));
      const float p = in_range ? expf(s - m_new) : 0.f;
      pw[lane] = p;
      const float psum = warp_sum(p);
      const float alpha = expf(m_run - m_new);
      __syncwarp();
#pragma unroll
      for (int i = 0; i < kLaneD; ++i) {
        const int d = lane + 32 * i;
        if (d < hd) {
          float a = acc[i] * alpha;
          for (int j = 0; j < n; ++j) a = fmaf(pw[j], v_s[j * stride + d], a);
          acc[i] = a;
        }
      }
      l_run = alpha * l_run + psum;
      m_run = m_new;
    }
  }
  if (warp < group) {
    const size_t idx =
        ((static_cast<size_t>(b) * KV + h) * n_chunks + c) * group + warp;
    if (lane == 0) {
      ws_m[idx] = m_run;
      ws_l[idx] = l_run;
    }
    float* arow = ws_acc + idx * hd;
#pragma unroll
    for (int i = 0; i < kLaneD; ++i) {
      const int d = lane + 32 * i;
      if (d < hd) arow[d] = acc[i];
    }
  }
}

// Pass 2: grid B * KV, 32 * group threads; warp g merges head g's chunks.
template <typename QT>
__global__ void decode_combine_kernel(const float* __restrict__ ws_m,
                                      const float* __restrict__ ws_l,
                                      const float* __restrict__ ws_acc,
                                      QT* __restrict__ out, int KV, int group,
                                      int hd, int n_chunks) {
  const int pair = blockIdx.x;          // b * KV + h
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= group) return;
  const size_t base = static_cast<size_t>(pair) * n_chunks * group + warp;
  float M = kNegInf;
  for (int c = 0; c < n_chunks; ++c) M = fmaxf(M, ws_m[base + c * group]);
  float l = 0.f;
  float acc[kLaneD];
#pragma unroll
  for (int i = 0; i < kLaneD; ++i) acc[i] = 0.f;
  for (int c = 0; c < n_chunks; ++c) {
    const size_t idx = base + static_cast<size_t>(c) * group;
    const float w = expf(ws_m[idx] - M);
    l = fmaf(w, ws_l[idx], l);
    const float* arow = ws_acc + idx * hd;
#pragma unroll
    for (int i = 0; i < kLaneD; ++i) {
      const int d = lane + 32 * i;
      if (d < hd) acc[i] = fmaf(w, arow[d], acc[i]);
    }
  }
  // l >= 1: the chunk holding the row's max contributes exp(0) per key
  QT* orow = out + (static_cast<size_t>(pair) * group + warp) * hd;
#pragma unroll
  for (int i = 0; i < kLaneD; ++i) {
    const int d = lane + 32 * i;
    if (d < hd) store_f(&orow[d], acc[i] / l);
  }
}

template <typename QT, typename KT>
int launch(const void* q, const void* k, const void* v, const void* valid,
           void* ws_m, void* ws_l, void* ws_acc, void* out, int B, int S,
           int KV, int group, int hd, int chunk, int n_chunks,
           long long k_sb, long long k_ss, long long v_sb, long long v_ss,
           cudaStream_t stream) {
  const size_t smem =
      (2 * static_cast<size_t>(kTile) * (hd + 1) + group * hd +
       group * kTile) * sizeof(float);
  auto split = decode_split_kernel<QT, KT>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        split, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const float scale = 1.0f / sqrtf(static_cast<float>(hd));
  split<<<dim3(n_chunks, KV, B), 32 * group, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KT*>(k),
      static_cast<const KT*>(v), static_cast<const uint8_t*>(valid),
      static_cast<float*>(ws_m), static_cast<float*>(ws_l),
      static_cast<float*>(ws_acc), S, KV, group, hd, chunk, n_chunks, k_sb,
      k_ss, v_sb, v_ss, scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  decode_combine_kernel<QT><<<B * KV, 32 * group, 0, stream>>>(
      static_cast<const float*>(ws_m), static_cast<const float*>(ws_l),
      static_cast<const float*>(ws_acc), static_cast<QT*>(out), KV, group,
      hd, n_chunks);
  return static_cast<int>(cudaGetLastError());
}

template <typename QT>
int launch_q(int kv_dtype, const void* q, const void* k, const void* v,
             const void* valid, void* ws_m, void* ws_l, void* ws_acc,
             void* out, int B, int S, int KV, int group, int hd, int chunk,
             int n_chunks, long long k_sb, long long k_ss, long long v_sb,
             long long v_ss, cudaStream_t s) {
  switch (kv_dtype) {
    case 0:
      return launch<QT, float>(q, k, v, valid, ws_m, ws_l, ws_acc, out, B, S,
                               KV, group, hd, chunk, n_chunks, k_sb, k_ss,
                               v_sb, v_ss, s);
    case 1:
      return launch<QT, __nv_bfloat16>(q, k, v, valid, ws_m, ws_l, ws_acc,
                                       out, B, S, KV, group, hd, chunk,
                                       n_chunks, k_sb, k_ss, v_sb, v_ss, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16. q (B, KV*group, hd) and out are
// contiguous; K/V rows and positions are strided (k_sb, k_ss elements),
// with kv heads and head dims contiguous inside a position; valid is
// (B, S) bytes. The workspace holds n_chunks partials per (row, head):
// ws_m and ws_l (B*KV*n_chunks*group) f32, ws_acc that times hd.
// Returns the cudaError_t of the launches (0 = success).
extern "C" int decode_attention_launch(
    const void* q, const void* k, const void* v, const void* valid,
    void* ws_m, void* ws_l, void* ws_acc, void* out, int B, int S, int KV,
    int group, int hd, int chunk, int n_chunks, long long k_sb,
    long long k_ss, long long v_sb, long long v_ss, int q_dtype,
    int kv_dtype, void* stream) {
  if (B == 0 || KV == 0) return 0;
  if (group < 1 || group > 32 || hd % 32 != 0 || hd > kMaxHd || S < 1 ||
      chunk < 1 || chunk % kTile != 0 ||
      static_cast<long long>(chunk) * n_chunks < S ||
      static_cast<long long>(chunk) * (n_chunks - 1) >= S)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (q_dtype) {
    case 0:
      return launch_q<float>(kv_dtype, q, k, v, valid, ws_m, ws_l, ws_acc,
                             out, B, S, KV, group, hd, chunk, n_chunks, k_sb,
                             k_ss, v_sb, v_ss, s);
    case 1:
      return launch_q<__nv_bfloat16>(kv_dtype, q, k, v, valid, ws_m, ws_l,
                                     ws_acc, out, B, S, KV, group, hd, chunk,
                                     n_chunks, k_sb, k_ss, v_sb, v_ss, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
