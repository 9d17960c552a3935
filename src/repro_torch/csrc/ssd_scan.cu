// Mamba2 SSD chunked scan for Hopper (sm_90a), plain C entry point.
//
// Replaces: the Pallas TPU kernel `_ssd_kernel` in
//   src/repro/kernels/ssd_scan/kernel.py (wrapper `ssd_scan_bhcp`, reached
//   through `ops.ssd_scan` from `models/mamba.mamba_mixer` with
//   attn_impl="pallas" and no initial state): the full-sequence pass of
//   the ssm family from zero state, which ExpPrep's standalone reference
//   scoring runs once per layer.
//
// Computes: for each row b and head h (B and C of group g = h / (H/G)),
//   walking the chunks of Q positions in order with the (P, N) f32 state
//   carried inside the block:
//     cs    = cumsum(dA) over the chunk
//     W     = (C B^T) o L o dt,   L[i,j] = exp(cs_i - cs_j) for j <= i, else 0
//     y     = W x + (C o exp(cs)) state^T
//     state = exp(cs_last) state + x^T (B o exp(cs_last - cs) dt)
//   and after the last chunk writes the final state (b, h, P, N) f32.
//   x (b,S,H,P), B and C (b,S,G,N) are read in the model layout by stride
//   (their last dim contiguous); dt and dA are contiguous (b,S,H) f32; y is
//   written contiguous (b,S,H,P) in x's dtype (f32 or bf16). S is a whole
//   number of chunks (the wrapper pads with dt = 0). All arithmetic is
//   f32, as the TPU kernel's: W is not rounded to x's dtype, which the
//   model's plain chunked form does, so in bf16 the two differ by that
//   rounding as well as by the order of their sums.
//
// What bounds it: at the ssm_score shapes (b=32, S=512, 32 heads, P=64,
//   N=128, Q=256, bf16) the function moves 180 MB (0.054 ms at 3.35 TB/s)
//   and, counting only the causal half of each chunk's Gram, does 43 GFLOP;
//   on the tensor cores that is bound by the bytes. This first kernel runs
//   every product as f32 FMAs from shared memory, whose 67 TFLOP/s make
//   0.64 ms the floor of this design; mma/wgmma tiles (and sharing C B^T
//   across the heads of a group, which this kernel recomputes per head, as
//   the TPU kernel does) are the next step.
//
// Design: one block of 256 threads per (head, row): 1,024 blocks at the
//   ssm_score shapes, so the sequential chunk walk stays inside a block
//   (blocks run in no order on Hopper, and nothing carries between them).
//   A Q = 256 chunk's (Q, Q) f32 Gram alone is 256 KB, over the 227 KB a
//   block may use, so the chunk is tiled flash-style: for each 64-row
//   i-tile, the carried-state term from the state in shared memory, then
//   the 64-column j-tiles with j <= i (tiles wholly above the diagonal are
//   skipped), each forming its W tile from C_i, B_j, cs and dt_j in shared
//   memory and accumulating W x_j into registers (4 rows x P/16 columns a
//   thread). The mask is applied before the exponential: above the
//   diagonal cs_i - cs_j > 0 may overflow, and inf * 0 would be NaN. After
//   every i-tile of the chunk the state is updated once: each thread owns
//   one column n of P/2 state rows in registers. Shared memory: the state
//   (P x N+1), C_i and B_j (64 x N+1 each), x_j (64 x P+1), W (64 x 65)
//   and cs, dt and the decay weights (Q each): 135 KB at P=64, N=128,
//   Q=256, so one block per SM; rows are padded by one float so the
//   strided reads hit distinct banks. Takes P in {16, 32, 64, 128}, any
//   N <= 128 and any Q whose tiles fit (ragged tiles are masked).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // 16 x 16
constexpr int kT = 64;          // rows of an i-tile, columns of a j-tile
constexpr int kMaxN = 128;      // the state update's >= 2 rows per pass
constexpr size_t kMaxSmem = 232448;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

size_t smem_floats(int P, int N, int Q) {
  return static_cast<size_t>(P) * (N + 1) + 2 * kT * (N + 1) +
         kT * (P + 1) + kT * (kT + 1) + 3 * static_cast<size_t>(Q);
}

template <typename T, int P>
__global__ void __launch_bounds__(kThreads)
    ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ dA, const T* __restrict__ Bm,
                    const T* __restrict__ Cm, T* __restrict__ y,
                    float* __restrict__ state_out, int S, int H, int G,
                    int N, int Q, long long xsb, long long xss,
                    long long xsh, long long bsb, long long bss,
                    long long bsg, long long csb, long long css,
                    long long csg) {
  constexpr int CP = P / 16;   // y columns per thread
  constexpr int KS = P / 2;    // state rows per thread (N <= 128)
  constexpr int WP = kT + 1;   // padded row stride of the W tile
  constexpr int XP = P + 1;    // padded row stride of the x tile
  const int NP = N + 1;        // padded row stride of the N-wide tiles
  extern __shared__ float smem[];
  float* st = smem;               // (P, N+1) the carried state
  float* ci = st + P * NP;        // (kT, N+1) C rows of the i-tile
  float* bj = ci + kT * NP;       // (kT, N+1) B rows of the j-tile
  float* xj = bj + kT * NP;       // (kT, P+1) x rows of the j-tile
  float* w = xj + kT * XP;        // (kT, kT+1) the W tile
  float* cs = w + kT * WP;        // (Q) cumsum of dA over the chunk
  float* dts = cs + Q;            // (Q) dt
  float* wd = dts + Q;            // (Q) exp(cs_last - cs_j) dt_j

  const int h = blockIdx.x, b = blockIdx.y;
  const int g = h / (H / G);
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const T* xb = x + b * xsb + h * xsh;
  const T* Bb = Bm + b * bsb + g * bsg;
  const T* Cb = Cm + b * csb + g * csg;
  const float* dtb = dt + static_cast<size_t>(b) * S * H + h;
  const float* dAb = dA + static_cast<size_t>(b) * S * H + h;
  T* yb = y + (static_cast<size_t>(b) * S * H + h) * P;

  // the state update's map: column nn_s of rows pp0 + rp k; threads with
  // pp0 >= rp (when N does not divide 256) sit it out
  const int rp = kThreads / N;
  const int nn_s = tid % N, pp0 = tid / N;

  for (int e = tid; e < P * NP; e += kThreads) st[e] = 0.f;

  const int n_chunks = S / Q;
  const int n_tiles = (Q + kT - 1) / kT;
  for (int c = 0; c < n_chunks; ++c) {
    const int t0 = c * Q;
    __syncthreads();   // the previous chunk's state writes are done
    for (int i = tid; i < Q; i += kThreads) {
      dts[i] = dtb[static_cast<size_t>(t0 + i) * H];
      cs[i] = dAb[static_cast<size_t>(t0 + i) * H];
    }
    __syncthreads();
    if (tid == 0) {   // sequential f32 cumsum, the order of torch's on CPU
      float run = 0.f;
      for (int i = 0; i < Q; ++i) {
        run += cs[i];
        cs[i] = run;
      }
    }
    __syncthreads();
    const float cs_last = cs[Q - 1];
    for (int i = tid; i < Q; i += kThreads)
      wd[i] = expf(cs_last - cs[i]) * dts[i];

    for (int it = 0; it < n_tiles; ++it) {
      const int i0 = it * kT;
      __syncthreads();   // the previous tile's ci/bj/xj/w are consumed
      for (int e = tid; e < kT * N; e += kThreads) {
        const int r = e / N, k = e - r * N, i = i0 + r;
        ci[r * NP + k] =
            i < Q ? to_f(Cb[static_cast<long long>(t0 + i) * css + k]) : 0.f;
      }
      __syncthreads();

      // the carried-in state: acc = exp(cs_i) (C_i . state^T)
      float acc[4][CP];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int cc = 0; cc < CP; ++cc) acc[a][cc] = 0.f;
      for (int k = 0; k < N; ++k) {
        float cv[4], sv[CP];
#pragma unroll
        for (int a = 0; a < 4; ++a) cv[a] = ci[(ty + 16 * a) * NP + k];
#pragma unroll
        for (int cc = 0; cc < CP; ++cc) sv[cc] = st[(tx + 16 * cc) * NP + k];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int cc = 0; cc < CP; ++cc)
            acc[a][cc] = fmaf(cv[a], sv[cc], acc[a][cc]);
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int i = i0 + ty + 16 * a;
        const float e = i < Q ? expf(cs[i]) : 0.f;
#pragma unroll
        for (int cc = 0; cc < CP; ++cc) acc[a][cc] *= e;
      }

      // the intra-chunk (dual) form over the j-tiles on or below the
      // diagonal
      for (int jt = 0; jt <= it; ++jt) {
        const int j0 = jt * kT;
        __syncthreads();   // the previous j-tile's bj/xj/w are consumed
        for (int e = tid; e < kT * N; e += kThreads) {
          const int r = e / N, k = e - r * N, j = j0 + r;
          bj[r * NP + k] =
              j < Q ? to_f(Bb[static_cast<long long>(t0 + j) * bss + k])
                    : 0.f;
        }
        for (int e = tid; e < kT * P; e += kThreads) {
          const int r = e / P, d = e - r * P, j = j0 + r;
          xj[r * XP + d] =
              j < Q ? to_f(xb[static_cast<long long>(t0 + j) * xss + d])
                    : 0.f;
        }
        __syncthreads();
        float sc[4][4];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) sc[a][cc] = 0.f;
        for (int k = 0; k < N; ++k) {
          float cv[4], bv[4];
#pragma unroll
          for (int a = 0; a < 4; ++a) cv[a] = ci[(ty + 16 * a) * NP + k];
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) bv[cc] = bj[(tx + 16 * cc) * NP + k];
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int cc = 0; cc < 4; ++cc)
              sc[a][cc] = fmaf(cv[a], bv[cc], sc[a][cc]);
        }
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) {
            const int r = ty + 16 * a, s = tx + 16 * cc;
            const int i = i0 + r, j = j0 + s;
            // masked before the exponential (cs_i - cs_j > 0 above it)
            w[r * WP + s] = (j <= i && i < Q)
                                ? sc[a][cc] * expf(cs[i] - cs[j]) * dts[j]
                                : 0.f;
          }
        __syncthreads();
        const int jn = min(kT, Q - j0);
        for (int s = 0; s < jn; ++s) {
          float wv[4], xv[CP];
#pragma unroll
          for (int a = 0; a < 4; ++a) wv[a] = w[(ty + 16 * a) * WP + s];
#pragma unroll
          for (int cc = 0; cc < CP; ++cc) xv[cc] = xj[s * XP + tx + 16 * cc];
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int cc = 0; cc < CP; ++cc)
              acc[a][cc] = fmaf(wv[a], xv[cc], acc[a][cc]);
        }
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int i = i0 + ty + 16 * a;
        if (i < Q) {
          T* yr = yb + static_cast<size_t>(t0 + i) * H * P;
#pragma unroll
          for (int cc = 0; cc < CP; ++cc)
            store_f(&yr[tx + 16 * cc], acc[a][cc]);
        }
      }
    }

    // the state update, once per chunk: x^T (B o wd) into registers
    float sacc[KS];
#pragma unroll
    for (int k = 0; k < KS; ++k) sacc[k] = 0.f;
    for (int j0 = 0; j0 < Q; j0 += kT) {
      __syncthreads();   // the y pass (or the previous j-tile) is done
      for (int e = tid; e < kT * N; e += kThreads) {
        const int r = e / N, k = e - r * N, j = j0 + r;
        bj[r * NP + k] =
            j < Q ? to_f(Bb[static_cast<long long>(t0 + j) * bss + k]) : 0.f;
      }
      for (int e = tid; e < kT * P; e += kThreads) {
        const int r = e / P, d = e - r * P, j = j0 + r;
        xj[r * XP + d] =
            j < Q ? to_f(xb[static_cast<long long>(t0 + j) * xss + d]) * wd[j]
                  : 0.f;
      }
      __syncthreads();
      if (pp0 < rp) {
        const int jn = min(kT, Q - j0);
        for (int s = 0; s < jn; ++s) {
          const float bv = bj[s * NP + nn_s];
#pragma unroll
          for (int k = 0; k < KS; ++k) {
            const int pp = pp0 + rp * k;
            if (pp < P) sacc[k] = fmaf(xj[s * XP + pp], bv, sacc[k]);
          }
        }
      }
    }
    // every (pp, nn) has one owner, and every read of this chunk's state
    // happened before the barriers above
    if (pp0 < rp) {
      const float dl = expf(cs_last);
#pragma unroll
      for (int k = 0; k < KS; ++k) {
        const int pp = pp0 + rp * k;
        if (pp < P) st[pp * NP + nn_s] = dl * st[pp * NP + nn_s] + sacc[k];
      }
    }
  }
  __syncthreads();
  float* so = state_out + (static_cast<size_t>(b) * H + h) * P * N;
  for (int e = tid; e < P * N; e += kThreads) {
    const int pp = e / N, k = e - pp * N;
    so[e] = st[pp * NP + k];
  }
}

template <typename T, int P>
int launch(const void* x, const void* dt, const void* dA, const void* Bm,
           const void* Cm, void* y, void* state, int batch, int S, int H,
           int G, int N, int Q, long long xsb, long long xss, long long xsh,
           long long bsb, long long bss, long long bsg, long long csb,
           long long css, long long csg, cudaStream_t stream) {
  const size_t smem = smem_floats(P, N, Q) * sizeof(float);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  auto kern = ssd_scan_kernel<T, P>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(H, batch);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(dA), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<T*>(y),
      static_cast<float*>(state), S, H, G, N, Q, xsb, xss, xsh, bsb, bss,
      bsg, csb, css, csg);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_p(int P, const void* x, const void* dt, const void* dA,
             const void* Bm, const void* Cm, void* y, void* state, int batch,
             int S, int H, int G, int N, int Q, long long xsb, long long xss,
             long long xsh, long long bsb, long long bss, long long bsg,
             long long csb, long long css, long long csg, cudaStream_t s) {
#define SSD_LAUNCH(PV)                                                    \
  launch<T, PV>(x, dt, dA, Bm, Cm, y, state, batch, S, H, G, N, Q, xsb,   \
                xss, xsh, bsb, bss, bsg, csb, css, csg, s)
  switch (P) {
    case 16:
      return SSD_LAUNCH(16);
    case 32:
      return SSD_LAUNCH(32);
    case 64:
      return SSD_LAUNCH(64);
    case 128:
      return SSD_LAUNCH(128);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef SSD_LAUNCH
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16 (x, B, C and y share it; dt, dA
// and the state are float32). S must be a multiple of Q; P in {16, 32, 64,
// 128}; 1 <= N <= 128; H % G == 0. Strides are in elements. Returns the
// cudaError_t of the launch.
extern "C" int ssd_scan_launch(const void* x, const void* dt, const void* dA,
                               const void* Bm, const void* Cm, void* y,
                               void* state, int batch, int S, int H, int G,
                               int P, int N, int Q, long long xsb,
                               long long xss, long long xsh, long long bsb,
                               long long bss, long long bsg, long long csb,
                               long long css, long long csg, int dtype,
                               void* stream) {
  if (batch == 0 || S == 0 || H == 0) return 0;
  if (G < 1 || H % G != 0 || N < 1 || N > kMaxN || Q < 1 || S % Q != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_p<float>(P, x, dt, dA, Bm, Cm, y, state, batch, S, H, G,
                             N, Q, xsb, xss, xsh, bsb, bss, bsg, csb, css,
                             csg, s);
    case 1:
      return launch_p<__nv_bfloat16>(P, x, dt, dA, Bm, Cm, y, state, batch, S,
                                     H, G, N, Q, xsb, xss, xsh, bsb, bss, bsg,
                                     csb, css, csg, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
