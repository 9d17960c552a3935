// Flash attention forward for Hopper (sm_90a), plain C entry point.
//
// Replaces: the Pallas TPU kernel `_fa_kernel` in
//   src/repro/kernels/flash_attention/kernel.py (wrapper
//   `flash_attention_bhsd`, reached through `ops.flash_attention` from
//   `models/layers.self_attention`): the full-sequence forward of training
//   (Update), of its remat recompute and of the reference pass (ExpPrep).
//
// Computes: for each row b, query head h and query position i,
//   O[b,i,h] = softmax_j(scale * q[b,i,h] . k[b,j,h/group]) v[b,j,h/group]
//   over the keys j allowed by the mask (j < Sk; j <= i when causal;
//   j > i - window when window > 0), and L[b,h,i] = m + log l, the
//   row's softmax normaliser that the backward recomputes P from. Masked
//   scores are the finite NEG_INF = -1e30 of the JAX kernel: a slab with no
//   allowed key adds p = exp(0) = 1 until an allowed key arrives, and then
//   alpha = exp(-1e30 - m) = 0 wipes it. Slabs above the causal diagonal
//   or before the window are skipped: every row of a tile finds its
//   allowed keys inside the walked range, so the result is the same.
//   Inputs are read in the model layout (B,S,H,hd) and (B,Sk,KV,hd) by
//   stride; O is written in that layout, L as (B,H,S) f32. All arithmetic
//   is f32; O takes q's dtype (f32 or bf16).
//
// What bounds it: at the update's shapes (B=32, S=256, 14/2 heads, hd 64,
//   bf16) the causal forward does 3.8e9 flops on 34 MB, 112 flops a byte:
//   below the tensor cores' balance (about 295 bf16 flops a byte), so the
//   floor is the bytes, about 10 us. This first kernel runs its products
//   as f32 FMAs in shared memory, whose 67 TFLOP/s make 57 us the floor
//   of this design; wgmma and TMA tiles are the next step.
//
// Design: one block of 256 threads per (b, q head, 64-row q tile). The q
//   tile is loaded once (pre-scaled, f32); K/V slabs of 64 keys stream
//   through shared memory. Each thread owns a 4x4 block of the 64x64 score
//   tile (rows ty+16a, keys tx+16c) and a 4 x hd/16 block of the output
//   accumulator; four lanes own each row's running (m, l). Tile rows are
//   padded by one float so the strided reads hit distinct banks. Rows
//   and keys past S / Sk are masked, so any S works.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kBQ = 64;       // query rows per tile
constexpr int kBK = 64;       // keys per slab
constexpr int kThreads = 256; // 16 x 16

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// The mask of `_fa_kernel`, plus the ragged edges the TPU grid never had.
__device__ __forceinline__ bool allowed(int qp, int kp, int S, int Sk,
                                        int causal, int window) {
  if (qp >= S || kp >= Sk) return false;
  if (causal && kp > qp) return false;
  if (window > 0 && kp <= qp - window) return false;
  return true;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
    fa_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, T* __restrict__ o,
                  float* __restrict__ Lout, int S, int Sk, int H, int KV,
                  int causal, int window, float scale) {
  constexpr int P = HD + 1;     // padded row stride of the q/k/v tiles
  constexpr int PS = kBK + 1;   // padded row stride of the score tile
  constexpr int CJ = HD / 16;   // output columns per thread
  extern __shared__ float smem[];
  float* q_s = smem;                   // (BQ, HD+1), pre-scaled
  float* k_s = q_s + kBQ * P;          // (BK, HD+1)
  float* v_s = k_s + kBK * P;          // (BK, HD+1)
  float* p_s = v_s + kBK * P;          // (BQ, BK+1) scores, then probs
  float* alpha_s = p_s + kBQ * PS;     // (BQ) rescale of this slab
  float* l_s = alpha_s + kBQ;          // (BQ) final l
  float* m_s = l_s + kBQ;              // (BQ) final m

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int sr = tid >> 2, sl = tid & 3;   // softmax: row sr, lane sl of 4

  for (int i = tid; i < kBQ * HD; i += kThreads) {
    const int r = i / HD, d = i - r * HD, s = q0 + r;
    q_s[r * P + d] =
        s < S ? to_f(q[(static_cast<size_t>(b) * S + s) * H * HD + h * HD +
                       d]) * scale
              : 0.f;
  }

  // the slabs holding an allowed key of some row of this tile
  const int q_last = min(q0 + kBQ, S) - 1;
  const int hi = causal ? min(Sk, q_last + 1) : Sk;
  const int lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int j0 = lo / kBK, j1 = (hi + kBK - 1) / kBK;

  float m_run = kNegInf, l_run = 0.f;
  float acc[4][CJ];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < CJ; ++c) acc[a][c] = 0.f;

  for (int j = j0; j < j1; ++j) {
    const int k0 = j * kBK;
    __syncthreads();   // the previous slab is fully consumed
    for (int i = tid; i < kBK * HD; i += kThreads) {
      const int r = i / HD, d = i - r * HD, s = k0 + r;
      float kx = 0.f, vx = 0.f;
      if (s < Sk) {
        const size_t off =
            (static_cast<size_t>(b) * Sk + s) * KV * HD + kvh * HD + d;
        kx = to_f(k[off]);
        vx = to_f(v[off]);
      }
      k_s[r * P + d] = kx;
      v_s[r * P + d] = vx;
    }
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) sc[a][c] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float qa[4], kc[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) qa[a] = q_s[(ty + 16 * a) * P + d];
#pragma unroll
      for (int c = 0; c < 4; ++c) kc[c] = k_s[(tx + 16 * c) * P + d];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) sc[a][c] = fmaf(qa[a], kc[c], sc[a][c]);
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int r = ty + 16 * a, cc = tx + 16 * c;
        p_s[r * PS + cc] =
            allowed(q0 + r, k0 + cc, S, Sk, causal, window) ? sc[a][c]
                                                            : kNegInf;
      }
    __syncthreads();

    {  // online softmax of row sr over this slab
      float* pr = p_s + sr * PS;
      float mx = kNegInf;
      for (int c = sl; c < kBK; c += 4) mx = fmaxf(mx, pr[c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run, mx);
      float sum = 0.f;
      for (int c = sl; c < kBK; c += 4) {
        const float p = expf(pr[c] - m_new);
        pr[c] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const float alpha = expf(m_run - m_new);
      l_run = alpha * l_run + sum;
      m_run = m_new;
      if (sl == 0) alpha_s[sr] = alpha;
    }
    __syncthreads();

#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const float al = alpha_s[ty + 16 * a];
#pragma unroll
      for (int c = 0; c < CJ; ++c) acc[a][c] *= al;
    }
#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float pa[4], vc[CJ];
#pragma unroll
      for (int a = 0; a < 4; ++a) pa[a] = p_s[(ty + 16 * a) * PS + kk];
#pragma unroll
      for (int c = 0; c < CJ; ++c) vc[c] = v_s[kk * P + tx + 16 * c];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < CJ; ++c) acc[a][c] = fmaf(pa[a], vc[c], acc[a][c]);
    }
  }

  if (sl == 0) {
    l_s[sr] = (l_run == 0.f) ? 1.f : l_run;   // fully masked row -> 0
    m_s[sr] = m_run;
  }
  __syncthreads();
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = ty + 16 * a, s = q0 + r;
    if (s < S) {
      const float l = l_s[r];
      T* orow = o + (static_cast<size_t>(b) * S + s) * H * HD + h * HD;
#pragma unroll
      for (int c = 0; c < CJ; ++c) store_f(&orow[tx + 16 * c], acc[a][c] / l);
    }
  }
  if (tid < kBQ && q0 + tid < S)
    Lout[(static_cast<size_t>(b) * H + h) * S + q0 + tid] =
        m_s[tid] + logf(l_s[tid]);
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, void* L,
           int B, int S, int Sk, int H, int KV, int causal, int window,
           cudaStream_t stream) {
  constexpr int P = HD + 1;
  const size_t smem =
      (static_cast<size_t>(kBQ) * P + 2 * kBK * P + kBQ * (kBK + 1) +
       3 * kBQ) * sizeof(float);
  auto kern = fa_fwd_kernel<T, HD>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(L),
      S, Sk, H, KV, causal, window, 1.0f / sqrtf(static_cast<float>(HD)));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_hd(int hd, const void* q, const void* k, const void* v, void* o,
              void* L, int B, int S, int Sk, int H, int KV, int causal,
              int window, cudaStream_t s) {
  switch (hd) {
    case 32:
      return launch<T, 32>(q, k, v, o, L, B, S, Sk, H, KV, causal, window, s);
    case 64:
      return launch<T, 64>(q, k, v, o, L, B, S, Sk, H, KV, causal, window, s);
    case 128:
      return launch<T, 128>(q, k, v, o, L, B, S, Sk, H, KV, causal, window,
                            s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16 (q, k, v and O share it).
// head_dim 32, 64 or 128. Returns the cudaError_t of the launch.
extern "C" int flash_attention_fwd_launch(const void* q, const void* k,
                                          const void* v, void* o, void* L,
                                          int B, int S, int Sk, int H, int KV,
                                          int hd, int causal, int window,
                                          int dtype, void* stream) {
  if (B == 0 || S == 0 || H == 0) return 0;
  if (KV < 1 || H % KV != 0 || Sk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_hd<float>(hd, q, k, v, o, L, B, S, Sk, H, KV, causal,
                              window, s);
    case 1:
      return launch_hd<__nv_bfloat16>(hd, q, k, v, o, L, B, S, Sk, H, KV,
                                      causal, window, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
