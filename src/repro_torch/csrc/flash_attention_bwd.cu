// Flash attention backward for Hopper (sm_90a): the dq and dk/dv passes,
// plain C entry points.
//
// Replaces: the Pallas TPU kernels `_dq_kernel` and `_dkv_kernel` in
//   src/repro/kernels/flash_attention/bwd_kernel.py (wrapper
//   `flash_attention_bwd_bhsd`), the backward of every full-sequence
//   attention in the Update step.
//
// Computes: the two-pass formula of that file. With L = m + log l saved
//   by the forward and D = rowsum(dO o O) computed by the caller,
//     P  = exp(scale * q k^T - L)   (0 where the mask disallows the key)
//     dS = P o (dO V^T - D)
//     dq = scale * dS K             (pass 1: one block per q tile)
//     dk = scale * dS^T Q,  dv = P^T dO
//                                   (pass 2: one block per kv tile,
//                                    summed over the `group` q heads that
//                                    share the kv head)
//   The mask is the forward's: j < Sk, j <= i when causal, j > i - window
//   when window > 0. q, k, v, dO are read in the model layout (B,S,H,hd)
//   and (B,Sk,KV,hd); L and D are (B,H,S) f32; dq, dk, dv are written in
//   the layouts and dtypes of q, k, v. All arithmetic is f32.
//
// What bounds it: at the update's shapes (B=32, S=256, 14/2 heads, hd 64,
//   bf16) dq does 5.6e9 causal flops on 49 MB and dk/dv 7.5e9 on 39 MB:
//   both below the tensor cores' balance, so bytes set the floor (15 and
//   12 us). Like the forward, this first version runs its products as f32
//   FMAs in shared memory (67 TFLOP/s: 84 and 112 us floors of this
//   design).
//
// Design: 256 threads per block; each thread owns a 4x4 block of the
//   64x64 score tile and a 4 x hd/16 block of its accumulators, in
//   registers. dq walks the kv slabs a causal / windowed q tile can see.
//   dk/dv walks every (head in group, q tile) pair that can see its kv
//   tile and keeps both accumulators in registers: no atomics, so the
//   result is deterministic, as in `_dkv_kernel`. Rows and keys past S /
//   Sk are masked, so any S works.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;       // query rows per tile
constexpr int kBK = 64;       // keys per tile
constexpr int kThreads = 256; // 16 x 16
static_assert(kBQ == 64 && kBK == 64, "load_tile and the 4x4 thread blocks "
              "assume 64-row tiles");

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ bool allowed(int qp, int kp, int S, int Sk,
                                        int causal, int window) {
  if (qp >= S || kp >= Sk) return false;
  if (causal && kp > qp) return false;
  if (window > 0 && kp <= qp - window) return false;
  return true;
}

// Load `rows` rows of one head from a (B, n, heads, HD) tensor into a
// (rows, HD+1) f32 tile; rows past n are zero.
template <typename T, int HD>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src,
                                          int b, int r0, int n, int heads,
                                          int head) {
  constexpr int P = HD + 1;
  for (int i = threadIdx.x; i < 64 * HD; i += kThreads) {
    const int r = i / HD, d = i - r * HD, s = r0 + r;
    dst[r * P + d] =
        s < n ? to_f(src[(static_cast<size_t>(b) * n + s) * heads * HD +
                         head * HD + d])
              : 0.f;
  }
}

// P and dS of one (q tile, kv tile) pair for this thread's 4x4 block:
// rows ty+16a of q_s/do_s against rows tx+16c of k_s/v_s.
template <int HD>
__device__ __forceinline__ void p_and_ds(
    const float* q_s, const float* do_s, const float* k_s, const float* v_s,
    const float* L_s, const float* D_s, int q0, int k0, int S, int Sk,
    int causal, int window, float scale, float (&p)[4][4],
    float (&ds)[4][4]) {
  constexpr int P = HD + 1;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float sc[4][4], dp[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) sc[a][c] = dp[a][c] = 0.f;
#pragma unroll 8
  for (int d = 0; d < HD; ++d) {
    float qa[4], oa[4], kc[4], vc[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      qa[a] = q_s[(ty + 16 * a) * P + d];
      oa[a] = do_s[(ty + 16 * a) * P + d];
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      kc[c] = k_s[(tx + 16 * c) * P + d];
      vc[c] = v_s[(tx + 16 * c) * P + d];
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        sc[a][c] = fmaf(qa[a], kc[c], sc[a][c]);
        dp[a][c] = fmaf(oa[a], vc[c], dp[a][c]);
      }
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = ty + 16 * a;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const bool ok = allowed(q0 + r, k0 + tx + 16 * c, S, Sk, causal, window);
      p[a][c] = ok ? expf(sc[a][c] * scale - L_s[r]) : 0.f;
      ds[a][c] = p[a][c] * (dp[a][c] - D_s[r]);
    }
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
    fa_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout,
                 const float* __restrict__ L, const float* __restrict__ D,
                 T* __restrict__ dq, int S, int Sk, int H, int KV,
                 int causal, int window, float scale) {
  constexpr int P = HD + 1;
  constexpr int PS = kBK + 1;
  constexpr int CJ = HD / 16;
  extern __shared__ float smem[];
  float* q_s = smem;                 // (BQ, HD+1)
  float* do_s = q_s + kBQ * P;       // (BQ, HD+1)
  float* k_s = do_s + kBQ * P;       // (BK, HD+1)
  float* v_s = k_s + kBK * P;        // (BK, HD+1)
  float* ds_s = v_s + kBK * P;       // (BQ, BK+1)
  float* L_s = ds_s + kBQ * PS;      // (BQ)
  float* D_s = L_s + kBQ;            // (BQ)

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;

  load_tile<T, HD>(q_s, q, b, q0, S, H, h);
  load_tile<T, HD>(do_s, dout, b, q0, S, H, h);
  if (tid < kBQ) {
    const int s = q0 + tid;
    const size_t off = (static_cast<size_t>(b) * H + h) * S + s;
    L_s[tid] = s < S ? L[off] : 0.f;
    D_s[tid] = s < S ? D[off] : 0.f;
  }

  const int q_last = min(q0 + kBQ, S) - 1;
  const int hi = causal ? min(Sk, q_last + 1) : Sk;
  const int lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int j0 = lo / kBK, j1 = (hi + kBK - 1) / kBK;

  float acc[4][CJ];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < CJ; ++c) acc[a][c] = 0.f;

  for (int j = j0; j < j1; ++j) {
    const int k0 = j * kBK;
    __syncthreads();   // the previous slab is fully consumed
    load_tile<T, HD>(k_s, k, b, k0, Sk, KV, kvh);
    load_tile<T, HD>(v_s, v, b, k0, Sk, KV, kvh);
    __syncthreads();
    float p[4][4], ds[4][4];
    p_and_ds<HD>(q_s, do_s, k_s, v_s, L_s, D_s, q0, k0, S, Sk, causal,
                 window, scale, p, ds);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        ds_s[(ty + 16 * a) * PS + tx + 16 * c] = ds[a][c];
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float da[4], kc[CJ];
#pragma unroll
      for (int a = 0; a < 4; ++a) da[a] = ds_s[(ty + 16 * a) * PS + kk];
#pragma unroll
      for (int c = 0; c < CJ; ++c) kc[c] = k_s[kk * P + tx + 16 * c];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < CJ; ++c) acc[a][c] = fmaf(da[a], kc[c], acc[a][c]);
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int s = q0 + ty + 16 * a;
    if (s < S) {
      T* row = dq + (static_cast<size_t>(b) * S + s) * H * HD + h * HD;
#pragma unroll
      for (int c = 0; c < CJ; ++c)
        store_f(&row[tx + 16 * c], acc[a][c] * scale);
    }
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
    fa_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const T* __restrict__ dout,
                  const float* __restrict__ L, const float* __restrict__ D,
                  T* __restrict__ dk, T* __restrict__ dv, int S, int Sk,
                  int H, int KV, int causal, int window, float scale) {
  constexpr int P = HD + 1;
  constexpr int PS = kBK + 1;
  constexpr int CJ = HD / 16;
  extern __shared__ float smem[];
  float* k_s = smem;                 // (BK, HD+1)
  float* v_s = k_s + kBK * P;        // (BK, HD+1)
  float* q_s = v_s + kBK * P;        // (BQ, HD+1)
  float* do_s = q_s + kBQ * P;       // (BQ, HD+1)
  float* p_s = do_s + kBQ * P;       // (BQ, BK+1)
  float* ds_s = p_s + kBQ * PS;      // (BQ, BK+1)
  float* L_s = ds_s + kBQ * PS;      // (BQ)
  float* D_s = L_s + kBQ;            // (BQ)

  const int k0 = blockIdx.x * kBK;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int group = H / KV;
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;

  load_tile<T, HD>(k_s, k, b, k0, Sk, KV, kvh);
  load_tile<T, HD>(v_s, v, b, k0, Sk, KV, kvh);

  // the q tiles with a row that may see a key of this tile
  const int k_last = min(k0 + kBK, Sk) - 1;
  const int n_qt = (S + kBQ - 1) / kBQ;
  const int i0 = causal ? min(k0, S) / kBQ : 0;
  const int i1 =
      window > 0 ? min(n_qt, (k_last + window - 1) / kBQ + 1) : n_qt;

  float acc_k[4][CJ], acc_v[4][CJ];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < CJ; ++c) acc_k[a][c] = acc_v[a][c] = 0.f;

  for (int g = 0; g < group; ++g) {
    const int h = kvh * group + g;
    for (int i = i0; i < i1; ++i) {
      const int q0 = i * kBQ;
      __syncthreads();   // the previous q tile is fully consumed
      load_tile<T, HD>(q_s, q, b, q0, S, H, h);
      load_tile<T, HD>(do_s, dout, b, q0, S, H, h);
      if (tid < kBQ) {
        const int s = q0 + tid;
        const size_t off = (static_cast<size_t>(b) * H + h) * S + s;
        L_s[tid] = s < S ? L[off] : 0.f;
        D_s[tid] = s < S ? D[off] : 0.f;
      }
      __syncthreads();
      float p[4][4], ds[4][4];
      p_and_ds<HD>(q_s, do_s, k_s, v_s, L_s, D_s, q0, k0, S, Sk, causal,
                   window, scale, p, ds);
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int idx = (ty + 16 * a) * PS + tx + 16 * c;
          p_s[idx] = p[a][c];
          ds_s[idx] = ds[a][c];
        }
      __syncthreads();
      // this thread's kv rows ty+16a, columns tx+16c: sum over q rows
#pragma unroll 4
      for (int rr = 0; rr < kBQ; ++rr) {
        float pa[4], da[4], oc[CJ], qc[CJ];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          pa[a] = p_s[rr * PS + ty + 16 * a];
          da[a] = ds_s[rr * PS + ty + 16 * a];
        }
#pragma unroll
        for (int c = 0; c < CJ; ++c) {
          oc[c] = do_s[rr * P + tx + 16 * c];
          qc[c] = q_s[rr * P + tx + 16 * c];
        }
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < CJ; ++c) {
            acc_v[a][c] = fmaf(pa[a], oc[c], acc_v[a][c]);
            acc_k[a][c] = fmaf(da[a], qc[c], acc_k[a][c]);
          }
      }
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int s = k0 + ty + 16 * a;
    if (s < Sk) {
      const size_t off = (static_cast<size_t>(b) * Sk + s) * KV * HD + kvh * HD;
#pragma unroll
      for (int c = 0; c < CJ; ++c) {
        store_f(&dk[off + tx + 16 * c], acc_k[a][c] * scale);
        store_f(&dv[off + tx + 16 * c], acc_v[a][c]);
      }
    }
  }
}

template <typename Kern>
cudaError_t set_smem(Kern kern, size_t smem) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <typename T, int HD>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* L, const void* D, void* dq, int B, int S, int Sk,
              int H, int KV, int causal, int window, cudaStream_t stream) {
  constexpr int P = HD + 1;
  const size_t smem = (2 * static_cast<size_t>(kBQ) * P + 2 * kBK * P +
                       kBQ * (kBK + 1) + 2 * kBQ) * sizeof(float);
  auto kern = fa_dq_kernel<T, HD>;
  cudaError_t e = set_smem(kern, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(L), static_cast<const float*>(D),
      static_cast<T*>(dq), S, Sk, H, KV, causal, window,
      1.0f / sqrtf(static_cast<float>(HD)));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* L, const void* D, void* dk, void* dv, int B, int S,
               int Sk, int H, int KV, int causal, int window,
               cudaStream_t stream) {
  constexpr int P = HD + 1;
  const size_t smem = (2 * static_cast<size_t>(kBK) * P + 2 * kBQ * P +
                       2 * kBQ * (kBK + 1) + 2 * kBQ) * sizeof(float);
  auto kern = fa_dkv_kernel<T, HD>;
  cudaError_t e = set_smem(kern, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((Sk + kBK - 1) / kBK, KV, B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(L), static_cast<const float*>(D),
      static_cast<T*>(dk), static_cast<T*>(dv), S, Sk, H, KV, causal, window,
      1.0f / sqrtf(static_cast<float>(HD)));
  return static_cast<int>(cudaGetLastError());
}

// Dispatch on (dtype code, head_dim) to FN<T, HD>(args...).
#define FA_DISPATCH(FN, ...)                                             \
  switch (dtype * 1000 + hd) {                                           \
    case 32: return FN<float, 32>(__VA_ARGS__);                          \
    case 64: return FN<float, 64>(__VA_ARGS__);                          \
    case 128: return FN<float, 128>(__VA_ARGS__);                        \
    case 1032: return FN<__nv_bfloat16, 32>(__VA_ARGS__);                \
    case 1064: return FN<__nv_bfloat16, 64>(__VA_ARGS__);                \
    case 1128: return FN<__nv_bfloat16, 128>(__VA_ARGS__);               \
    default: return static_cast<int>(cudaErrorInvalidValue);             \
  }

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16 (q, k, v, dO and the gradients
// share it); head_dim 32, 64 or 128. Each returns the cudaError_t of its
// launch.
extern "C" int flash_attention_dq_launch(const void* q, const void* k,
                                         const void* v, const void* dout,
                                         const void* L, const void* D,
                                         void* dq, int B, int S, int Sk,
                                         int H, int KV, int hd, int causal,
                                         int window, int dtype,
                                         void* stream) {
  if (B == 0 || S == 0 || H == 0) return 0;
  if (KV < 1 || H % KV != 0 || Sk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  FA_DISPATCH(launch_dq, q, k, v, dout, L, D, dq, B, S, Sk, H, KV, causal,
              window, s)
}

extern "C" int flash_attention_dkv_launch(const void* q, const void* k,
                                          const void* v, const void* dout,
                                          const void* L, const void* D,
                                          void* dk, void* dv, int B, int S,
                                          int Sk, int H, int KV, int hd,
                                          int causal, int window, int dtype,
                                          void* stream) {
  if (B == 0 || Sk == 0 || KV == 0) return 0;
  if (H % KV != 0 || S < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  FA_DISPATCH(launch_dkv, q, k, v, dout, L, D, dk, dv, B, S, Sk, H, KV,
              causal, window, s)
}
