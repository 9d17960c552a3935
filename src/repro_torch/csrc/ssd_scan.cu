// Mamba2 SSD chunked scan for Hopper (sm_90a), plain C entry point.
//
// Replaces: the Pallas TPU kernel `_ssd_kernel` in
//   src/repro/kernels/ssd_scan/kernel.py:31 (wrapper `ssd_scan_bhcp`,
//   reached through `ops.ssd_scan` from `models/mamba.mamba_mixer` with
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
//   number of chunks (the wrapper pads with dt = 0). W is never rounded to
//   x's dtype, as in the TPU kernel (the model's plain chunked form rounds
//   it), so in bf16 the two differ by that rounding as well as by the
//   order of their sums.
//
// What bounds it: at the ssm_score shapes (b=32, S=512, 32 heads, P=64,
//   N=128, Q=256, 1 group, bf16) the function moves 180 MB (0.054 ms at
//   3.35 TB/s). Counting the causal half of each chunk's Gram once per
//   (row, group, chunk), since B and C are per group, W x over the same
//   pairs, and the state term and update per head, it does 26 GFLOP (43
//   with the Gram per head): on the tensor cores (989 TFLOP/s) the bytes
//   bound it.
//
// Two routes, one launch each; the wrapper's plan picks the route and the
// head tile (`kernels/ssd_scan/ops.py:plan`).
//
// Tensor-core route (`ssd_tc_kernel`, bf16, P in {64, 128}, N in {32, 64,
//   128}, x, B and C 16-byte aligned views; tile machinery in
//   flash_sm90.cuh). One block per (row, head tile of ht heads of one
//   group): a warpgroup per (head, 64 columns of P), two at most, so 256
//   threads. The chunk walk stays in the block; blocks carry nothing.
//   - TMA from the model layout. x, B and C arrive as 64-row tiles through
//     4-D tensor maps over their strided views (B and C are views of the
//     mixer's xbc: rows 4,608 B apart at mamba2-370m), into a two-stage
//     ring of {B_j, x_j of each head} completed on mbarriers, and a
//     two-slot ring of C_i tiles. Thread 0 refills a stage after the
//     block's barrier at the end of the step that used it, so the next
//     step's tiles land while this one computes. Past S, TMA fills zeros;
//     a chunk shorter than a tile (Q < 64) reads the next chunk's rows,
//     which W and the state update mask out and which are never stored.
//   - The Gram once per block. Each step (i-tile, j-tile <= i) forms the
//     64 x 64 f32 tile C_i B_j^T once for all ht heads: each warpgroup one
//     column slice (wgmma m64n64 or m64n32, both operands K-major, like
//     flash's S = Q K^T), written to shared memory in fragment order (a
//     float4 per lane, no bank conflicts). At the ssm_score shape the head
//     tile is 2, so the Gram is formed 16 times per (row, chunk) tile pair
//     where the first kernel formed it 32 times; a tile of all 32 heads
//     would leave 32 blocks for 132 SMs.
//   - y on the tensor cores. Each warpgroup reads the Gram, forms its
//     head's W = G o exp(cs_i - cs_j) dt_j (masked before the exponential,
//     which is one MUFU ex2) in registers, splits it into bf16 hi + lo (one
//     bf16 rounding of W would put 2^-9 of |W x| on y) and adds W x_j with
//     x as an MN-major operand (wgmma m64n64, like flash's P V). The
//     carried-state term C_i state^T runs first in each i-tile from the
//     state's bf16 terms (below), then its rows are scaled by exp(cs_i).
//     y leaves as bf16 pairs from registers, rows past Q skipped.
//   - The state. Between chunks each warpgroup keeps its 64 x N slice of
//     the f32 state in shared memory as three bf16 terms, hi + mid + lo,
//     which carry all 24 bits of each f32 value (8 + 8 + 8): exactly the
//     f32 state, in a form wgmma reads as a K-major operand. y's state
//     term takes hi + mid (about 2^-17 of the state: y is gated at bf16).
//     The update x^T (B o wd) takes the A operand from registers,
//     (wd_j x_j)^T in three bf16 terms again (two carry about 2^-17 of
//     each operand, at the edge of the final state's 2^-18 gate), and
//     B_j as an MN-major operand (wgmma m64nN), into an f32 accumulator
//     that starts at zero; at the chunk's end each thread adds exp(cs_last)
//     (hi + mid + lo) of its own elements and splits the sum into three
//     terms again, or writes it out f32 after the last chunk.
//   - The cumsum stays sequential, one thread per head, in the order the
//     first kernel used (exp(cs_i - cs_j) carries its rounding), while
//     the chunk's first tiles load.
//   Shared memory at the ssm_score shape: C ring 32 KB, stage ring 64 KB,
//   Gram 16 KB, state terms 96 KB, cs/dt/wd 6 KB: 215 KB, one block of
//   two warpgroups per SM, 512 blocks.
//
// f32 route (`ssd_simt_kernel`: fp32 inputs, every bf16 shape the
//   tensor-core route does not take, and misaligned views). f32 FMAs from
//   shared memory (TF32 would miss the fp32 gate of 2^-18 of the output
//   scale). One block of 256 threads per (row, head tile of one or two
//   heads): the chunk is tiled flash-style (64-row i-tiles; 64-column
//   j-tiles with j <= i), the Gram tile C_i B_j^T is formed once in
//   registers and turned into each head's W in turn, and W x accumulates
//   in registers per head; the state update runs once per chunk and head,
//   each thread owning one column n of P/2 state rows. fp32 tiles arrive
//   by cp.async, a 4-byte copy per element (any stride), every copy of a
//   thread in flight at once: an i-tile's first B and x tiles land while
//   its carried-state term runs, and each j-tile's x tiles while its Gram
//   tile is formed. bf16 tiles (shapes or views the tensor cores do not
//   take) are loaded eight elements a thread at a time and converted to
//   f32. Rows are padded by one float so the strided reads hit distinct
//   banks. The head tile is a template parameter (1 or 2), so a one-head
//   block keeps no second head's accumulators. Takes P in {16, 32, 64,
//   128}, any N <= 128 and any Q whose tiles fit (ragged tiles masked).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_sm90.cuh"

namespace {

constexpr int kT = 64;          // rows of an i-tile, columns of a j-tile
constexpr int kMaxN = 128;
constexpr size_t kMaxSmem = 232448;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// ---- f32 route -------------------------------------------------------------
constexpr int kThreads = 256;   // 16 x 16
constexpr int kLoadU = 8;       // bf16 loads in flight per thread

size_t simt_smem_bytes(int P, int N, int Q, int ht) {
  return sizeof(float) *
         (static_cast<size_t>(ht) * P * (N + 1) + 2 * kT * (N + 1) +
          static_cast<size_t>(ht) * kT * (P + 1) + kT * (kT + 1) +
          3 * static_cast<size_t>(ht) * Q);
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   fa_sm90::smem_addr(dst)),
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

// Rows r < kT of a tile of `cols` columns into dst (row stride ds) from
// src (row stride ss); rows r >= valid are zero. f32 by cp.async, every
// copy of the thread in flight until cp_async_wait; bf16 by kLoadU loads
// in flight per thread, converted to f32 in registers.
__device__ __forceinline__ void load_tile(float* dst, int ds,
                                          const float* src, long long ss,
                                          int cols, int valid, int tid) {
  for (int e = tid; e < kT * cols; e += kThreads) {
    const int r = e / cols, k = e - r * cols;
    if (r < valid)
      cp_async4(dst + r * ds + k, src + r * ss + k);
    else
      dst[r * ds + k] = 0.f;
  }
}
__device__ __forceinline__ void load_tile(float* dst, int ds,
                                          const __nv_bfloat16* src,
                                          long long ss, int cols, int valid,
                                          int tid) {
  const int total = kT * cols;
  for (int e0 = tid; e0 < total; e0 += kLoadU * kThreads) {
    float v[kLoadU];
#pragma unroll
    for (int u = 0; u < kLoadU; ++u) {
      const int e = e0 + u * kThreads, r = e / cols, k = e - r * cols;
      v[u] = e < total && r < valid ? to_f(src[r * ss + k]) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kLoadU; ++u) {
      const int e = e0 + u * kThreads, r = e / cols, k = e - r * cols;
      if (e < total) dst[r * ds + k] = v[u];
    }
  }
}

template <typename T, int P, int HT>
__global__ void __launch_bounds__(kThreads)
    ssd_simt_kernel(const T* __restrict__ x, const float* __restrict__ dt,
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
  constexpr int XP = P + 1;    // padded row stride of the x tiles
  const int NP = N + 1;        // padded row stride of the N-wide tiles
  extern __shared__ float smem[];
  float* st = smem;                   // (HT, P, N+1) the carried states
  float* ci = st + HT * P * NP;       // (kT, N+1) C rows of the i-tile
  float* bj = ci + kT * NP;           // (kT, N+1) B rows of the j-tile
  float* xj = bj + kT * NP;           // (HT, kT, P+1) x rows of the j-tile
  float* w = xj + HT * kT * XP;       // (kT, kT+1) a head's W tile
  float* cs = w + kT * WP;            // (HT, Q) cumsum of dA over the chunk
  float* dts = cs + HT * Q;           // (HT, Q) dt
  float* wd = dts + HT * Q;           // (HT, Q) exp(cs_last - cs_j) dt_j

  const int h0 = blockIdx.x * HT, b = blockIdx.y;
  const int g = h0 / (H / G);
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const T* Bb = Bm + b * bsb + g * bsg;
  const T* Cb = Cm + b * csb + g * csg;
  const T* xb = x + b * xsb + h0 * xsh;

  // the state update's map: column nn_s of rows pp0 + rp k; threads with
  // pp0 >= rp (when N does not divide 256) sit it out
  const int rp = kThreads / N;
  const int nn_s = tid % N, pp0 = tid / N;

  for (int e = tid; e < HT * P * NP; e += kThreads) st[e] = 0.f;

  const int n_chunks = S / Q;
  const int n_tiles = (Q + kT - 1) / kT;
  for (int c = 0; c < n_chunks; ++c) {
    const int t0 = c * Q;
    // the B rows, then each head's x rows, of j-tile j0: two copy groups
    auto load_j = [&](int j0) {
      const int valid = min(kT, Q - j0);
      load_tile(bj, NP, Bb + (t0 + j0) * bss, bss, N, valid, tid);
      cp_async_commit();
#pragma unroll
      for (int hl = 0; hl < HT; ++hl)
        load_tile(xj + hl * kT * XP, XP, xb + (t0 + j0) * xss + hl * xsh,
                  xss, P, valid, tid);
      cp_async_commit();
    };
    __syncthreads();   // the previous chunk's state writes are done
    for (int e = tid; e < Q * HT; e += kThreads) {
      const int i = e / HT, j = e - i * HT;
      const size_t off = (static_cast<size_t>(b) * S + t0 + i) * H + h0 + j;
      dts[j * Q + i] = dt[off];
      cs[j * Q + i] = dA[off];
    }
    __syncthreads();
    if (tid < HT) {   // sequential f32 cumsum per head
      float* c_h = cs + tid * Q;
      float run = 0.f;
      for (int i = 0; i < Q; ++i) {
        run += c_h[i];
        c_h[i] = run;
      }
    }
    __syncthreads();
    for (int e = tid; e < Q * HT; e += kThreads)
      wd[e] = expf(cs[(e / Q) * Q + Q - 1] - cs[e]) * dts[e];

    for (int it = 0; it < n_tiles; ++it) {
      const int i0 = it * kT;
      __syncthreads();   // the previous tile's ci/bj/xj/w are consumed
      load_tile(ci, NP, Cb + (t0 + i0) * css, css, N, min(kT, Q - i0), tid);
      cp_async_commit();
      load_j(0);         // lands while the carried-in term runs
      cp_async_wait<2>();
      __syncthreads();

      // the carried-in state: acc = exp(cs_i) (C_i . state^T), per head
      float acc[HT][4][CP];
#pragma unroll
      for (int hl = 0; hl < HT; ++hl) {
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int cc = 0; cc < CP; ++cc) acc[hl][a][cc] = 0.f;
        if (c == 0) continue;
        const float* sth = st + hl * P * NP;
        for (int k = 0; k < N; ++k) {
          float cv[4], sv[CP];
#pragma unroll
          for (int a = 0; a < 4; ++a) cv[a] = ci[(ty + 16 * a) * NP + k];
#pragma unroll
          for (int cc = 0; cc < CP; ++cc)
            sv[cc] = sth[(tx + 16 * cc) * NP + k];
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int cc = 0; cc < CP; ++cc)
              acc[hl][a][cc] = fmaf(cv[a], sv[cc], acc[hl][a][cc]);
        }
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int i = i0 + ty + 16 * a;
          const float e = i < Q ? expf(cs[hl * Q + i]) : 0.f;
#pragma unroll
          for (int cc = 0; cc < CP; ++cc) acc[hl][a][cc] *= e;
        }
      }

      // the intra-chunk (dual) form over the j-tiles on or below the
      // diagonal: the Gram tile once while the x rows land, then each
      // head's W x
      for (int jt = 0; jt <= it; ++jt) {
        const int j0 = jt * kT;
        if (jt > 0) {
          __syncthreads();   // the previous j-tile's bj/xj/w are consumed
          load_j(j0);
        }
        cp_async_wait<1>();
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
        cp_async_wait<0>();   // the barrier below publishes the x rows
        const int jn = min(kT, Q - j0);
#pragma unroll
        for (int hl = 0; hl < HT; ++hl) {
          if (hl > 0) __syncthreads();   // the previous head's W is read
          const float* c_h = cs + hl * Q;
          const float* d_h = dts + hl * Q;
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int cc = 0; cc < 4; ++cc) {
              const int r = ty + 16 * a, s = tx + 16 * cc;
              const int i = i0 + r, j = j0 + s;
              // masked before the exponential (cs_i - cs_j > 0 above it)
              w[r * WP + s] = (j <= i && i < Q)
                                  ? sc[a][cc] * expf(c_h[i] - c_h[j]) * d_h[j]
                                  : 0.f;
            }
          __syncthreads();
          const float* xh = xj + hl * kT * XP;
          for (int s = 0; s < jn; ++s) {
            float wv[4], xv[CP];
#pragma unroll
            for (int a = 0; a < 4; ++a) wv[a] = w[(ty + 16 * a) * WP + s];
#pragma unroll
            for (int cc = 0; cc < CP; ++cc) xv[cc] = xh[s * XP + tx + 16 * cc];
#pragma unroll
            for (int a = 0; a < 4; ++a)
#pragma unroll
              for (int cc = 0; cc < CP; ++cc)
                acc[hl][a][cc] = fmaf(wv[a], xv[cc], acc[hl][a][cc]);
          }
        }
      }
#pragma unroll
      for (int hl = 0; hl < HT; ++hl) {
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int i = i0 + ty + 16 * a;
          if (i < Q) {
            T* yr = y + ((static_cast<size_t>(b) * S + t0 + i) * H + h0 +
                         hl) * P;
#pragma unroll
            for (int cc = 0; cc < CP; ++cc)
              store_f(&yr[tx + 16 * cc], acc[hl][a][cc]);
          }
        }
      }
    }

    // the state update, once per chunk and head: x^T (B o wd) into
    // registers
#pragma unroll
    for (int hl = 0; hl < HT; ++hl) {
      const float* wd_h = wd + hl * Q;
      float sacc[KS];
#pragma unroll
      for (int k = 0; k < KS; ++k) sacc[k] = 0.f;
      for (int j0 = 0; j0 < Q; j0 += kT) {
        const int jn = min(kT, Q - j0);
        __syncthreads();   // the y pass (or the previous j-tile) is done
        load_tile(bj, NP, Bb + (t0 + j0) * bss, bss, N, jn, tid);
        load_tile(xj, XP, xb + (t0 + j0) * xss + hl * xsh, xss, P, jn, tid);
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
        if (pp0 < rp) {
          for (int s = 0; s < jn; ++s) {
            const float bv = bj[s * NP + nn_s] * wd_h[j0 + s];
#pragma unroll
            for (int k = 0; k < KS; ++k) {
              const int pp = pp0 + rp * k;
              if (pp < P) sacc[k] = fmaf(xj[s * XP + pp], bv, sacc[k]);
            }
          }
        }
      }
      // every (pp, nn) has one owner, and every read of this chunk's
      // state happened before the barriers above
      if (pp0 < rp) {
        const float dl = expf(cs[hl * Q + Q - 1]);
        float* sth = st + hl * P * NP;
#pragma unroll
        for (int k = 0; k < KS; ++k) {
          const int pp = pp0 + rp * k;
          if (pp < P)
            sth[pp * NP + nn_s] = dl * sth[pp * NP + nn_s] + sacc[k];
        }
      }
    }
  }
  __syncthreads();
  for (int e = tid; e < HT * P * N; e += kThreads) {
    const int hl = e / (P * N), rem = e - hl * P * N;
    const int pp = rem / N, k = rem - pp * N;
    state_out[(static_cast<size_t>(b) * H + h0 + hl) * P * N + rem] =
        st[(hl * P + pp) * NP + k];
  }
}

template <typename T, int P, int HT>
int launch_simt_ht(const void* x, const void* dt, const void* dA,
                   const void* Bm, const void* Cm, void* y, void* state,
                   int batch, int S, int H, int G, int N, int Q,
                   long long xsb, long long xss, long long xsh,
                   long long bsb, long long bss, long long bsg,
                   long long csb, long long css, long long csg,
                   cudaStream_t stream) {
  const size_t smem = simt_smem_bytes(P, N, Q, HT);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  auto kern = ssd_simt_kernel<T, P, HT>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(H / HT, batch);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(dA), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<T*>(y),
      static_cast<float*>(state), S, H, G, N, Q, xsb, xss, xsh, bsb, bss,
      bsg, csb, css, csg);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int P>
int launch_simt(const void* x, const void* dt, const void* dA, const void* Bm,
                const void* Cm, void* y, void* state, int batch, int S, int H,
                int G, int N, int Q, int ht, long long xsb, long long xss,
                long long xsh, long long bsb, long long bss, long long bsg,
                long long csb, long long css, long long csg,
                cudaStream_t stream) {
  switch (ht) {
    case 1:
      return launch_simt_ht<T, P, 1>(x, dt, dA, Bm, Cm, y, state, batch, S,
                                     H, G, N, Q, xsb, xss, xsh, bsb, bss,
                                     bsg, csb, css, csg, stream);
    case 2:
      return launch_simt_ht<T, P, 2>(x, dt, dA, Bm, Cm, y, state, batch, S,
                                     H, G, N, Q, xsb, xss, xsh, bsb, bss,
                                     bsg, csb, css, csg, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ---- tensor-core route -----------------------------------------------------
constexpr int kStages = 2;      // {B_j, x_j per head} stages in flight
constexpr int kMaxWg = 2;       // warpgroups per block

size_t tc_smem_bytes(int P, int N, int Q, int ht) {
  const size_t tb = static_cast<size_t>(kT) * N * 2;   // a B, C or state tile
  const size_t tx = static_cast<size_t>(kT) * P * 2;   // an x tile
  return fa_sm90::kAlignSlack + 2 * tb + kStages * (tb + ht * tx) +
         kT * kT * sizeof(float) +
         static_cast<size_t>(ht) * (P / 64) * 3 * tb +
         (2 + kStages) * sizeof(uint64_t) +
         3 * static_cast<size_t>(ht) * Q * sizeof(float);
}

// The j-tile of local step `s` of a chunk with nt tiles: the y steps (it,
// jt <= it) in order, then the nt state-update steps.
__device__ __forceinline__ int step_jt(int s, int nt) {
  const int ny = nt * (nt + 1) / 2;
  if (s >= ny) return s - ny;
  int it = 0;
  while ((it + 1) * (it + 2) / 2 <= s) ++it;
  return s - it * (it + 1) / 2;
}

__device__ __forceinline__ uint32_t bf16_bits(float v) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16(v)));
}
__device__ __forceinline__ float bf16_val(uint32_t u) {
  return __uint_as_float(u << 16);
}

// v = hi + mid + lo, each bf16: the three carry all 24 bits of v.
__device__ __forceinline__ void split3(float v, uint32_t& hi, uint32_t& mid,
                                       uint32_t& lo) {
  hi = bf16_bits(v);
  const float r = v - bf16_val(hi);
  mid = bf16_bits(r);
  lo = bf16_bits(r - bf16_val(mid));
}

// bf16 pair (a, b) at element (row, col) of a swizzled tile, col even.
template <int W>
__device__ __forceinline__ uint32_t* pair_at(uint8_t* tile, int row, int col) {
  return reinterpret_cast<uint32_t*>(tile +
                                     fa_sm90::tile_offset<W>(row, col));
}

template <int P, int N>
__global__ void __launch_bounds__(128 * kMaxWg, 1)
    ssd_tc_kernel(const __grid_constant__ CUtensorMap tm_x,
                  const __grid_constant__ CUtensorMap tm_b,
                  const __grid_constant__ CUtensorMap tm_c,
                  const float* __restrict__ dt, const float* __restrict__ dA,
                  __nv_bfloat16* __restrict__ y,
                  float* __restrict__ state_out, int S, int H, int G, int Q,
                  int ht) {
  using namespace fa_sm90;
  constexpr int kSl = P / 64;                 // warpgroups per head
  constexpr int kTB = Tile<N>::kBytes, kTX = Tile<P>::kBytes;
  constexpr int kNA = N / 2;                  // update accumulators
  extern __shared__ uint8_t smem_raw[];
  uint8_t* c_s = align_1024(smem_raw);        // [2] C_i tiles
  uint8_t* stage_s = c_s + 2 * kTB;           // [kStages] {B_j, x_j ...}
  const int stage_bytes = kTB + ht * kTX;
  float* g_s = reinterpret_cast<float*>(stage_s + kStages * stage_bytes);
  uint8_t* st_s = reinterpret_cast<uint8_t*>(g_s + kT * kT);
  uint64_t* bar_c = reinterpret_cast<uint64_t*>(st_s + ht * kSl * 3 * kTB);
  uint64_t* bar_st = bar_c + 2;
  float* cs_s = reinterpret_cast<float*>(bar_st + kStages);   // [ht][Q]
  float* dt_s = cs_s + ht * Q;                                // [ht][Q]
  float* wd_s = dt_s + ht * Q;                                // [ht][Q]

  const int h0 = blockIdx.x * ht, b = blockIdx.y;
  const int g = h0 / (H / G);
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int nwg = nthreads >> 7;
  const int wg = tid >> 7, hl = wg / kSl, m = wg % kSl;
  const int w = (tid >> 5) & 3, gq = (tid & 31) >> 2, t = tid & 3;
  const int h = h0 + hl;
  uint8_t* st_own = st_s + wg * 3 * kTB;      // this warpgroup's state terms

  const int nt = (Q + kT - 1) / kT;
  const int n_chunks = S / Q;
  const int ns = nt * (nt + 1) / 2 + nt;      // steps per chunk
  const int K = n_chunks * ns, U = n_chunks * nt;

  if (tid == 0) {
    tma_prefetch(&tm_x);
    tma_prefetch(&tm_b);
    tma_prefetch(&tm_c);
    for (int i = 0; i < 2; ++i) mbar_init(&bar_c[i], 1);
    for (int i = 0; i < kStages; ++i) mbar_init(&bar_st[i], 1);
    mbar_init_fence();
  }
  __syncthreads();
  auto load_step = [&](int k) {
    const int c = k / ns, jt = step_jt(k - c * ns, nt);
    const int row0 = c * Q + jt * kT;
    uint8_t* dst = stage_s + (k % kStages) * stage_bytes;
    uint64_t* bar = &bar_st[k % kStages];
    mbar_expect_tx(bar, stage_bytes);
    tma_load_tile<N>(dst, &tm_b, bar, g, row0, b);
    for (int j = 0; j < ht; ++j)
      tma_load_tile<P>(dst + kTB + j * kTX, &tm_x, bar, h0 + j, row0, b);
  };
  auto load_c = [&](int u) {
    const int c = u / nt, it = u - c * nt;
    mbar_expect_tx(&bar_c[u & 1], kTB);
    tma_load_tile<N>(c_s + (u & 1) * kTB, &tm_c, &bar_c[u & 1], g,
                     c * Q + it * kT, b);
  };
  if (tid == 0) {
    load_c(0);
    for (int k = 0; k < min(kStages, K); ++k) load_step(k);
  }

  const float* cs_h = cs_s + hl * Q;
  const float* dt_h = dt_s + hl * Q;
  const float* wd_h = wd_s + hl * Q;
  int k = 0, u = 0;                           // global step, i-tile
  for (int c = 0; c < n_chunks; ++c) {
    const int t0 = c * Q;
    // dt and dA of the chunk, and the sequential cumsum per head, while
    // the chunk's first tiles load
    __syncthreads();   // the previous chunk's reads of cs/dt/wd are done
    for (int e = tid; e < Q * ht; e += nthreads) {
      const int i = e / ht, j = e - i * ht;
      const size_t off = (static_cast<size_t>(b) * S + t0 + i) * H + h0 + j;
      dt_s[j * Q + i] = dt[off];
      cs_s[j * Q + i] = dA[off];
    }
    __syncthreads();
    if (tid < ht) {
      float* c_h = cs_s + tid * Q;
      float run = 0.f;
      for (int i = 0; i < Q; ++i) {
        run += c_h[i];
        c_h[i] = run;
      }
    }
    __syncthreads();
    for (int e = tid; e < Q * ht; e += nthreads)
      wd_s[e] = expf(cs_s[(e / Q) * Q + Q - 1] - cs_s[e]) * dt_s[e];
    // (wd is first read after the barriers of the y steps)

    for (int it = 0; it < nt; ++it, ++u) {
      // C_{u+1} goes to the slot i-tile u-1 used: every step of it has
      // passed its closing barrier
      if (tid == 0 && u + 1 < U) load_c(u + 1);
      mbar_wait(&bar_c[u & 1], (u >> 1) & 1);
      const uint32_t c_addr = smem_addr(c_s + (u & 1) * kTB);
      const int i_base = it * kT + 16 * w + gq;   // + 8 i: this thread's rows

      // the carried-in state: exp(cs_i) (C_i . (hi + mid)^T)
      float acc[32];
#pragma unroll
      for (int r = 0; r < 32; ++r) acc[r] = 0.f;
      if (c > 0) {
        const uint32_t s_addr = smem_addr(st_own);
        wgmma_fence();
#pragma unroll
        for (int term = 0; term < 2; ++term)
#pragma unroll
          for (int kk = 0; kk < N / 16; ++kk)
            wgmma_ss(acc, desc_k<N>(c_addr, kk),
                     desc_k<N>(s_addr + term * kTB, kk), 1);
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(acc);
#pragma unroll
        for (int ii = 0; ii < 2; ++ii) {
          const int i = i_base + 8 * ii;
          const float e = i < Q ? expf(cs_h[i]) : 0.f;
#pragma unroll
          for (int n = 0; n < 8; ++n) {
            acc[4 * n + 2 * ii] *= e;
            acc[4 * n + 2 * ii + 1] *= e;
          }
        }
      }

      for (int jt = 0; jt <= it; ++jt, ++k) {
        const int stg = k % kStages;
        uint8_t* stage = stage_s + stg * stage_bytes;
        mbar_wait(&bar_st[stg], (k / kStages) & 1);
        // this warpgroup's column slice of the Gram tile C_i B_j^T, to
        // shared memory in fragment order: float4 q of lane l of warp w at
        // ((w * 8 + q) * 32 + l)
        const uint32_t b_addr = smem_addr(stage);
        float4* g4 = reinterpret_cast<float4*>(g_s);
        if (nwg == 1) {
          float gp[32];
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < N / 16; ++kk)
            wgmma_ss(gp, desc_k<N>(c_addr, kk), desc_k<N>(b_addr, kk),
                     kk > 0);
          wgmma_commit();
          wgmma_wait_all();
          fence_regs(gp);
#pragma unroll
          for (int q = 0; q < 8; ++q)
            g4[(w * 8 + q) * 32 + (tid & 31)] =
                make_float4(gp[4 * q], gp[4 * q + 1], gp[4 * q + 2],
                            gp[4 * q + 3]);
        } else {
          float gp[16];
          const uint32_t rows = 32 * wg * Tile<N>::kSwizzle;
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < N / 16; ++kk)
            wgmma_ss(gp, desc_k<N>(c_addr, kk),
                     desc_k<N>(b_addr + rows, kk), kk > 0);
          wgmma_commit();
          wgmma_wait_all();
          fence_regs(gp);
#pragma unroll
          for (int q = 0; q < 4; ++q)
            g4[(w * 8 + 4 * wg + q) * 32 + (tid & 31)] =
                make_float4(gp[4 * q], gp[4 * q + 1], gp[4 * q + 2],
                            gp[4 * q + 3]);
        }
        __syncthreads();

        // W = G o exp(cs_i - cs_j) dt_j, masked before the exponential;
        // one MUFU ex2 per element (about 2^-22 relative, plus the
        // rounding of (cs_i - cs_j) log2(e): far below the bf16 gate on
        // y). With expf here the kernel took 0.45 ms at the ssm_score
        // shape on an NVIDIA H100 80GB HBM3 at 700 W, with ex2 0.32
        // (chip_smoke.py's kernels phase; PERF.md section 6).
        float wv[32];
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const float4 v = g4[(w * 8 + q) * 32 + (tid & 31)];
          wv[4 * q] = v.x;
          wv[4 * q + 1] = v.y;
          wv[4 * q + 2] = v.z;
          wv[4 * q + 3] = v.w;
        }
#pragma unroll
        for (int r = 0; r < 32; ++r) {
          const int i = i_base + 8 * ((r >> 1) & 1);
          const int j = jt * kT + 8 * (r >> 2) + 2 * t + (r & 1);
          wv[r] = (j <= i && i < Q)
                      ? wv[r] * fast_exp2((cs_h[i] - cs_h[j]) * kLog2e) *
                            dt_h[j]
                      : 0.f;
        }
        uint32_t w_hi[4][4], w_lo[4][4];
        split_frags(wv, w_hi, w_lo);
        const uint32_t x_addr =
            smem_addr(stage + kTB + hl * kTX + m * Tile<P>::kChunkBytes);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_rs(acc, w_hi[kk], desc_mn<64>(x_addr, kk));
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_rs(acc, w_lo[kk], desc_mn<64>(x_addr, kk));
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(acc);
        fence_regs(w_hi);
        fence_regs(w_lo);

        __syncthreads();   // stage stg and the Gram tile are free
        if (tid == 0 && k + kStages < K) load_step(k + kStages);
      }

      // y rows of the chunk, as bf16 pairs
#pragma unroll
      for (int ii = 0; ii < 2; ++ii) {
        const int i = i_base + 8 * ii;
        if (i < Q) {
          __nv_bfloat16* yr =
              y + ((static_cast<size_t>(b) * S + t0 + i) * H + h) * P +
              64 * m + 2 * t;
#pragma unroll
          for (int n = 0; n < 8; ++n)
            *reinterpret_cast<__nv_bfloat162*>(yr + 8 * n) =
                __floats2bfloat162_rn(acc[4 * n + 2 * ii],
                                      acc[4 * n + 2 * ii + 1]);
        }
      }
    }

    // the state update: ua = sum_j (wd_j x_j)^T B_j over the chunk's
    // j-tiles, rows p = 64 m + 16 w + gq (+8) of this warpgroup's slice
    float ua[kNA];
#pragma unroll
    for (int r = 0; r < kNA; ++r) ua[r] = 0.f;
    for (int jt = 0; jt < nt; ++jt, ++k) {
      const int stg = k % kStages;
      uint8_t* stage = stage_s + stg * stage_bytes;
      mbar_wait(&bar_st[stg], (k / kStages) & 1);
      uint8_t* xt = stage + kTB + hl * kTX;
      // A fragments: register r of k-step kk holds rows p_r = 16 w + gq +
      // 8 (r & 1), columns j = 16 kk + 8 (r >> 1) + 2 t (+1)
      uint32_t fa[4][3][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int p = 64 * m + 16 * w + gq + 8 * (r & 1);
          const int jl = 16 * kk + 8 * (r >> 1) + 2 * t;
          const int j = jt * kT + jl;
          float v[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float xv = __bfloat162float(
                *reinterpret_cast<const __nv_bfloat16*>(
                    xt + tile_offset<P>(jl + e, p)));
            v[e] = j + e < Q ? xv * wd_h[j + e] : 0.f;
          }
          uint32_t h0b, m0b, l0b, h1b, m1b, l1b;
          split3(v[0], h0b, m0b, l0b);
          split3(v[1], h1b, m1b, l1b);
          fa[kk][0][r] = h0b | (h1b << 16);
          fa[kk][1][r] = m0b | (m1b << 16);
          fa[kk][2][r] = l0b | (l1b << 16);
        }
      const uint32_t b_addr = smem_addr(stage);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int term = 0; term < 3; ++term)
          wgmma_rs(ua, fa[kk][term], desc_mn<N>(b_addr, kk));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(ua);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        fence_regs(fa[kk]);

      __syncthreads();   // stage stg is free
      if (tid == 0 && k + kStages < K) load_step(k + kStages);
    }

    // state = exp(cs_last) (hi + mid + lo) + ua, element by element; kept
    // as three bf16 terms, or written out f32 after the last chunk
    const float dl = expf(cs_h[Q - 1]);
    const bool last = c + 1 == n_chunks;
#pragma unroll
    for (int r = 0; r < kNA; r += 2) {
      const int row = 16 * w + gq + 8 * ((r >> 1) & 1);
      const int col = 8 * (r >> 2) + 2 * t;
      float v0 = ua[r], v1 = ua[r + 1];
      if (c > 0) {
        float s0 = 0.f, s1 = 0.f;
#pragma unroll
        for (int term = 0; term < 3; ++term) {
          const uint32_t pr = *pair_at<N>(st_own + term * kTB, row, col);
          s0 += bf16_val(pr & 0xffffu);
          s1 += bf16_val(pr >> 16);
        }
        v0 = fmaf(dl, s0, v0);
        v1 = fmaf(dl, s1, v1);
      }
      if (last) {
        float* so = state_out +
                    ((static_cast<size_t>(b) * H + h) * P + 64 * m + row) * N +
                    col;
        *reinterpret_cast<float2*>(so) = make_float2(v0, v1);
      } else {
        uint32_t a0, a1, a2, b0, b1, b2;
        split3(v0, a0, a1, a2);
        split3(v1, b0, b1, b2);
        *pair_at<N>(st_own, row, col) = a0 | (b0 << 16);
        *pair_at<N>(st_own + kTB, row, col) = a1 | (b1 << 16);
        *pair_at<N>(st_own + 2 * kTB, row, col) = a2 | (b2 << 16);
      }
    }
    fence_async_smem();   // the next chunk's wgmma reads the state terms
  }
}

template <int P, int N>
int launch_tc(const void* x, const void* dt, const void* dA, const void* Bm,
              const void* Cm, void* y, void* state, int batch, int S, int H,
              int G, int Q, int ht, long long xsb, long long xss,
              long long xsh, long long bsb, long long bss, long long bsg,
              long long csb, long long css, long long csg,
              cudaStream_t stream) {
  const size_t smem = tc_smem_bytes(P, N, Q, ht);
  if (ht < 1 || ht * (P / 64) > kMaxWg || smem > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tx, tb, tcm;
  if (!fa_sm90::make_tile_map_strided<P>(&tx, x, batch, S, H, xsh, xss,
                                         xsb) ||
      !fa_sm90::make_tile_map_strided<N>(&tb, Bm, batch, S, G, bsg, bss,
                                         bsb) ||
      !fa_sm90::make_tile_map_strided<N>(&tcm, Cm, batch, S, G, csg, css,
                                         csb))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kern = ssd_tc_kernel<P, N>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(H / ht, batch);
  kern<<<grid, 128 * ht * (P / 64), smem, stream>>>(
      tx, tb, tcm, static_cast<const float*>(dt),
      static_cast<const float*>(dA), static_cast<__nv_bfloat16*>(y),
      static_cast<float*>(state), S, H, G, Q, ht);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Shared memory in bytes of one block of a route (0: f32, 1: tensor
// cores) and head tile, for the wrapper's plan.
extern "C" long long ssd_scan_smem_bytes(int route, int P, int N, int Q,
                                         int ht) {
  return static_cast<long long>(route == 1 ? tc_smem_bytes(P, N, Q, ht)
                                           : simt_smem_bytes(P, N, Q, ht));
}

// dtype codes: 0 = float32, 1 = bfloat16 (x, B, C and y share it; dt, dA
// and the state are float32). route 0 = f32 (P in {16, 32, 64, 128},
// ht in {1, 2}), route 1 = tensor cores (bf16, P in {64, 128}, N in {32,
// 64, 128}, ht (P/64) <= 2, x, B and C 16-byte aligned with strides in
// whole 16 bytes). S must be a multiple of Q; 1 <= N <= 128; H % G == 0;
// ht divides H/G. Strides are in elements. Returns the cudaError_t of the
// launch.
extern "C" int ssd_scan_launch(const void* x, const void* dt, const void* dA,
                               const void* Bm, const void* Cm, void* y,
                               void* state, int batch, int S, int H, int G,
                               int P, int N, int Q, long long xsb,
                               long long xss, long long xsh, long long bsb,
                               long long bss, long long bsg, long long csb,
                               long long css, long long csg, int dtype,
                               int route, int ht, void* stream) {
  if (batch == 0 || S == 0 || H == 0) return 0;
  if (G < 1 || H % G != 0 || N < 1 || N > kMaxN || Q < 1 || S % Q != 0 ||
      ht < 1 || (H / G) % ht != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SSD_ARGS                                                          \
  x, dt, dA, Bm, Cm, y, state, batch, S, H, G
#define SSD_STRIDES xsb, xss, xsh, bsb, bss, bsg, csb, css, csg, s
  if (route == 1) {
    if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
    switch (P * 1000 + N) {
      case 64032: return launch_tc<64, 32>(SSD_ARGS, Q, ht, SSD_STRIDES);
      case 64064: return launch_tc<64, 64>(SSD_ARGS, Q, ht, SSD_STRIDES);
      case 64128: return launch_tc<64, 128>(SSD_ARGS, Q, ht, SSD_STRIDES);
      case 128032: return launch_tc<128, 32>(SSD_ARGS, Q, ht, SSD_STRIDES);
      case 128064: return launch_tc<128, 64>(SSD_ARGS, Q, ht, SSD_STRIDES);
      case 128128: return launch_tc<128, 128>(SSD_ARGS, Q, ht, SSD_STRIDES);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (route != 0) return static_cast<int>(cudaErrorInvalidValue);
  switch (dtype * 1000 + P) {
    case 16: return launch_simt<float, 16>(SSD_ARGS, N, Q, ht, SSD_STRIDES);
    case 32: return launch_simt<float, 32>(SSD_ARGS, N, Q, ht, SSD_STRIDES);
    case 64: return launch_simt<float, 64>(SSD_ARGS, N, Q, ht, SSD_STRIDES);
    case 128: return launch_simt<float, 128>(SSD_ARGS, N, Q, ht, SSD_STRIDES);
    case 1016:
      return launch_simt<__nv_bfloat16, 16>(SSD_ARGS, N, Q, ht, SSD_STRIDES);
    case 1032:
      return launch_simt<__nv_bfloat16, 32>(SSD_ARGS, N, Q, ht, SSD_STRIDES);
    case 1064:
      return launch_simt<__nv_bfloat16, 64>(SSD_ARGS, N, Q, ht, SSD_STRIDES);
    case 1128:
      return launch_simt<__nv_bfloat16, 128>(SSD_ARGS, N, Q, ht, SSD_STRIDES);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef SSD_ARGS
#undef SSD_STRIDES
}
