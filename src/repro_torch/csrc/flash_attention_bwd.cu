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
//   the layouts and dtypes of q, k, v. Both passes are deterministic: no
//   atomics, every sum is owned by one block and taken in a fixed order,
//   as in the TPU kernels.
//
// What bounds it: at the update's shapes (B=32, S=256, 14/2 heads, hd 64,
//   bf16) dq does 5.6e9 causal flops on 49 MB and dk/dv 7.5e9 on 39 MB:
//   both below the tensor cores' balance (about 295 bf16 flops a byte), so
//   bytes set the floor (15 and 12 us). At a long context (B=4, S=2048)
//   dq does 45 GFLOP on 12 MB: there the tensor cores set the floor
//   (46 us; 61 us for the products this design issues, below).
//
// dq in bf16 (`fa_dq_wgmma_kernel`, tile machinery in flash_sm90.cuh): the
//   forward's shape with two score products and no online softmax. One
//   warpgroup (128 threads) per (q head, b, 64-row q tile), the q tile
//   slowest in the grid and walked from the last tile down, so under a
//   causal mask the tiles with the most slabs start first. Thread 0 loads
//   the Q and dO tiles once by TMA, and streams the K/V slabs the tile can
//   see (those above the causal diagonal or before the window are skipped)
//   through a two-stage TMA ring completed on mbarriers, so slab j+1 is in
//   flight while slab j is multiplied. The L and D rows of the thread's
//   two accumulator rows (16w + g and +8) sit in registers. Per slab:
//     S = Q K^T and dP = dO V^T   (one wgmma chain each, both operands
//                                  K-major, f32 accumulators),
//     P and dS in registers       (P = exp2(s scale log2e - L log2e), 0
//                                  where masked; a slab wholly inside the
//                                  mask skips it; dS = P o (dP - D)),
//     dQ += dS K                  (A = dS from registers, B = the K slab
//                                  MN-major, N = HD: the forward's P V).
//   The scale multiplies the f32 accumulator at the end, and dQ leaves
//   through the Q tile's shared memory and one TMA store, which clips rows
//   past S. One owner block per dq tile and a fixed slab order: no
//   atomics, the same bits on every run.
//   Precision: dS is f32 as in the TPU kernel. One bf16 rounding of it
//   puts about 2^-9 of each term on dq against a 2^-14 s gate (chip_smoke
//   reports the error that would give as `one_rounding_err_over_tol`), so
//   dS is split into hi = bf16(dS) and lo = bf16(dS - hi) and both go
//   through the tensor cores into one accumulator (about 2^-17 of dS):
//   four products per slab where three would do.
//   Occupancy: as in the forward, blocks at S = 256 walk only 1-4 slabs,
//   so latency and the number of resident blocks set the pace. The S, dP
//   and dQ accumulators are 32 + 32 + HD/2 registers a thread, and S is
//   dead once dS exists: at hd 64 the kernel takes 122 registers (106 at
//   hd 32, 154 at hd 128; no spills) and 50 KB of shared
//   memory, so four blocks fit on an SM.
//   Left for later: a 128-row tile over two warpgroups for the long
//   context, where the products set the pace, and a producer warp with
//   setmaxnreg.
//
// dk/dv in bf16 (`fa_dkv_wgmma_kernel`): one block of two warpgroups per
//   (kv head, b, 64-key tile), the key tile slowest in the grid and walked
//   from tile 0 up, so under a causal mask the tiles that see the most q
//   tiles start first. The K and V tiles stay resident in shared memory.
//   The (head in group, q tile) pairs that can see them (the loop that
//   `fori_loop` ran on the TPU) are dealt alternately to the two
//   warpgroups; each streams its pairs' q and dO tiles by TMA through its
//   own two-stage ring on mbarriers, and stages each pair's L and D rows in
//   shared memory one pair ahead. The products are transposed, so each A
//   operand is already in registers:
//     S^T = K Q^T and dP^T = V dO^T   (wgmma, both operands K-major),
//     P^T and dS^T in registers       (L and D index their columns; a
//                                      pair wholly inside the mask skips
//                                      it),
//     dV += P^T dO and dK += dS^T Q   (A from registers, B MN-major).
//   Each warpgroup keeps its dK and dV sums in f32 registers for its whole
//   walk; at the end warpgroup 1 hands them to warpgroup 0 through shared
//   memory, which adds them in a fixed order and writes dK and dV with TMA
//   stores. No atomics: the same sums in the same order on every run. Two
//   warpgroups halve the walk of the busiest tile (28 pairs at the
//   update's shape), which is what sets the kernel's time: 256 blocks, one
//   per SM (212 registers a thread at hd 64).
//   Precision: P^T and dS^T are split hi + lo as dS is in dq.
//   Left for later: a producer warp with setmaxnreg, overlapping the
//   products of one pair with the softmax of the next, and the long
//   context, where the products set the pace.
//
// fp32 dq and dk/dv keep the first SIMT design. 256 threads per block;
//   each thread owns a 4x4 block of the 64x64 score tile and a 4 x hd/16
//   block of its accumulators, in registers; products are f32 FMAs from
//   padded shared-memory tiles (67 TFLOP/s: an 84 us floor for dq at the
//   update's shape). dq walks the kv slabs a causal / windowed q tile can
//   see; dk/dv walks every (head in group, q tile) pair that can see its
//   kv tile. Rows and keys past S / Sk are masked, so any S works. TF32
//   tensor cores would break the fp32 gate, and fp32 is off the main
//   path.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "flash_sm90.cuh"

namespace {

constexpr int kBQ = 64;       // query rows per tile
constexpr int kBK = 64;       // keys per tile
constexpr int kThreads = 256; // 16 x 16
static_assert(kBQ == 64 && kBK == 64, "load_tile and the 4x4 thread blocks "
              "assume 64-row tiles");

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }

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

// ---- dk/dv in bf16: wgmma + TMA ----------------------------------------------
constexpr int kStages = 2;    // (q, dO) tile pairs in flight per warpgroup

// K, V; then per warpgroup a ring of (q, dO) stages and two L/D buffers;
// then the mbarriers.
template <int HD>
constexpr size_t dkv_wgmma_smem() {
  return fa_sm90::kAlignSlack + (2 + 2 * 2 * kStages) * fa_sm90::Tile<HD>::kBytes +
         2 * 2 * 2 * kBQ * sizeof(float) + (1 + 2 * kStages) * sizeof(uint64_t);
}

template <int HD>
__global__ void __launch_bounds__(256, 1)
    fa_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                        const __grid_constant__ CUtensorMap tm_k,
                        const __grid_constant__ CUtensorMap tm_v,
                        const __grid_constant__ CUtensorMap tm_do,
                        const __grid_constant__ CUtensorMap tm_dk,
                        const __grid_constant__ CUtensorMap tm_dv,
                        const float* __restrict__ L,
                        const float* __restrict__ D, int S, int Sk, int H,
                        int KV, int causal, int window, float scale) {
  using namespace fa_sm90;
  constexpr int kTile = Tile<HD>::kBytes;
  extern __shared__ uint8_t smem_raw[];
  const int tid = threadIdx.x;
  const int wg = tid >> 7, tl = tid & 127;   // warpgroup, thread in it
  const int w = tl >> 5, g = (tl & 31) >> 2, t = tl & 3;
  uint8_t* k_s = align_1024(smem_raw);
  uint8_t* v_s = k_s + kTile;
  uint8_t* ring = v_s + kTile + wg * 2 * kStages * kTile;  // stage: q, dO
  float* ld_s = reinterpret_cast<float*>(v_s + kTile + 2 * 2 * kStages * kTile)
                + wg * 2 * 2 * kBQ;                        // [2][L | D]
  uint64_t* bar_kv = reinterpret_cast<uint64_t*>(
      reinterpret_cast<float*>(v_s + kTile + 2 * 2 * kStages * kTile) +
      2 * 2 * 2 * kBQ);
  uint64_t* bar_q = bar_kv + 1 + wg * kStages;

  const int kvh = blockIdx.x, b = blockIdx.y;
  const int k0 = blockIdx.z * kBK;
  const int group = H / KV;

  // the q tiles with a row that may see a key of this tile
  const int k_last = min(k0 + kBK, Sk) - 1;
  const int n_qt = (S + kBQ - 1) / kBQ;
  const int i0 = causal ? min(k0, S) / kBQ : 0;
  const int i1 =
      window > 0 ? min(n_qt, (k_last + window - 1) / kBQ + 1) : n_qt;
  const int nq = max(0, i1 - i0);
  const int n_it = group * nq;             // (head in group, q tile) pairs
  // warpgroup wg takes pairs wg, wg + 2, ...: local pair li is 2 li + wg
  const int n_loc = (n_it + 1 - wg) / 2;

  if (tid == 0) {
    tma_prefetch(&tm_q);
    tma_prefetch(&tm_k);
    tma_prefetch(&tm_v);
    tma_prefetch(&tm_do);
    mbar_init(bar_kv, 1);
    for (int i = 0; i < 2 * kStages; ++i) mbar_init(bar_kv + 1 + i, 1);
    mbar_init_fence();
  }
  __syncthreads();
  const CUtensorMap* map_q = &tm_q;
  const CUtensorMap* map_do = &tm_do;
  auto pair_head = [&](int li) { return kvh * group + (2 * li + wg) / nq; };
  auto pair_q0 = [&](int li) { return (i0 + (2 * li + wg) % nq) * kBQ; };
  auto load_pair = [&](int li) {
    uint8_t* dst = ring + (li % kStages) * 2 * kTile;
    uint64_t* bar = &bar_q[li % kStages];
    mbar_expect_tx(bar, 2 * kTile);
    tma_load_tile<HD>(dst, map_q, bar, pair_head(li), pair_q0(li), b);
    tma_load_tile<HD>(dst + kTile, map_do, bar, pair_head(li), pair_q0(li),
                      b);
  };
  // L * log2(e) (threads 0-63) and D (64-127) of local pair li
  auto load_ld = [&](int li) {
    const int s_pos = pair_q0(li) + (tl & (kBQ - 1));
    const size_t off = (static_cast<size_t>(b) * H + pair_head(li)) * S;
    float x = 0.f;
    if (s_pos < S) x = tl < kBQ ? L[off + s_pos] * kLog2e : D[off + s_pos];
    ld_s[(li & 1) * 2 * kBQ + tl] = x;
  };
  if (tid == 0 && n_it > 0) {
    mbar_expect_tx(bar_kv, 2 * kTile);
    tma_load_tile<HD>(k_s, &tm_k, bar_kv, kvh, k0, b);
    tma_load_tile<HD>(v_s, &tm_v, bar_kv, kvh, k0, b);
  }
  if (tl == 0)
    for (int li = 0; li < min(kStages, n_loc); ++li) load_pair(li);
  if (n_loc > 0) load_ld(0);
  __syncthreads();

  // This thread's keys 16w + g + 8i (i = 0, 1) hold dK, dV rows in f32;
  // its q columns are 8n + 2t + j. A key kp sees q rows [kp (causal),
  // kp + window - 1] below S; kept less 2t.
  int q_lo[2], q_hi[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int kp = k0 + 16 * w + g + 8 * i;
    q_lo[i] = (causal ? kp : 0) - 2 * t;
    q_hi[i] = (kp < Sk ? (window > 0 ? min(S - 1, kp + window - 1) : S - 1)
                       : -1) - 2 * t;
  }
  const float sl2 = scale * kLog2e;
  float acc_k[HD / 2], acc_v[HD / 2];
#pragma unroll
  for (int r = 0; r < HD / 2; ++r) acc_k[r] = acc_v[r] = 0.f;
  const uint32_t k_addr = smem_addr(k_s), v_addr = smem_addr(v_s);
  const uint32_t ring_addr = smem_addr(ring);
  if (n_loc > 0) mbar_wait(bar_kv, 0);

  for (int li = 0; li < n_loc; ++li) {
    const int st = li % kStages;
    const int q0 = pair_q0(li);
    if (li + 1 < n_loc) load_ld(li + 1);   // read after the loop's barrier
    const uint32_t q_addr = ring_addr + st * 2 * kTile;
    const uint32_t do_addr = q_addr + kTile;
    mbar_wait(&bar_q[st], (li / kStages) & 1);

    float s[32], dp[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss(s, desc_k<HD>(k_addr, kk), desc_k<HD>(q_addr, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss(dp, desc_k<HD>(v_addr, kk), desc_k<HD>(do_addr, kk), kk > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    fence_regs(dp);

    // P^T = exp2(s * scale * log2(e) - L log2(e)), 0 where masked; a pair
    // whose every (key, q row) is allowed skips the mask (warpgroup
    // uniform). dS^T = P^T o (dP^T - D).
    const float* L_s = ld_s + (li & 1) * 2 * kBQ;
    const float* D_s = L_s + kBQ;
    const bool full = q0 + kBQ <= S && k0 + kBK <= Sk &&
                      (!causal || q0 >= k0 + kBK - 1) &&
                      (window <= 0 || q0 + kBQ - 1 < k0 + window);
#pragma unroll
    for (int r = 0; r < 32; ++r) {
      const int i = (r >> 1) & 1, col = 8 * (r >> 2) + (r & 1);
      const int c = col + 2 * t;                      // q row in the tile
      float p = fast_exp2(fmaf(s[r], sl2, -L_s[c]));
      if (!full && !(q0 + col >= q_lo[i] && q0 + col <= q_hi[i])) p = 0.f;
      s[r] = p;
      dp[r] = p * (dp[r] - D_s[c]);
    }

    uint32_t a_hi[4][4], a_lo[4][4];
    split_frags(s, a_hi, a_lo);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs(acc_v, a_hi[kk], desc_mn<HD>(do_addr, kk));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs(acc_v, a_lo[kk], desc_mn<HD>(do_addr, kk));
    wgmma_commit();
    if (HD == 128) {          // free P's fragments before dS's
      wgmma_wait_all();
      fence_regs(acc_v);
      fence_regs(a_hi);
      fence_regs(a_lo);
    }
    uint32_t b_hi[4][4], b_lo[4][4];
    split_frags(dp, b_hi, b_lo);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs(acc_k, b_hi[kk], desc_mn<HD>(q_addr, kk));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs(acc_k, b_lo[kk], desc_mn<HD>(q_addr, kk));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc_v);
    fence_regs(acc_k);
    fence_regs(a_hi);
    fence_regs(a_lo);
    fence_regs(b_hi);
    fence_regs(b_lo);

    warpgroup_sync(1 + wg);   // stage st and L/D buffer li & 1 are free
    if (tl == 0 && li + kStages < n_loc) load_pair(li + kStages);
  }

  // Warpgroup 1 hands its sums to warpgroup 0 through its own (now idle)
  // ring, which adds them in a fixed order: deterministic.
  float* red = reinterpret_cast<float*>(ring);    // [HD][128] per warpgroup
  static_assert(HD * 128 * sizeof(float) <= 2 * kStages * kTile,
                "the ring holds one warpgroup's dK and dV");
  __syncthreads();
  if (wg == 1) {
#pragma unroll
    for (int r = 0; r < HD / 2; ++r) {
      red[r * 128 + tl] = acc_k[r];
      red[(HD / 2 + r) * 128 + tl] = acc_v[r];
    }
  }
  __syncthreads();
  if (wg == 0) {
    red += 2 * kStages * kTile / sizeof(float);     // warpgroup 1's ring
#pragma unroll
    for (int r = 0; r < HD / 2; ++r) {
      acc_k[r] += red[r * 128 + tl];
      acc_v[r] += red[(HD / 2 + r) * 128 + tl];
    }
    // dK and dV go out through warpgroup 0's idle ring and two TMA
    // stores, which skip rows past Sk.
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = 16 * w + g + 8 * i;
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        const uint32_t off = tile_offset<HD>(row, 8 * n + 2 * t);
        const int r = 4 * n + 2 * i;
        *reinterpret_cast<__nv_bfloat162*>(ring + off) =
            __floats2bfloat162_rn(acc_k[r] * scale, acc_k[r + 1] * scale);
        *reinterpret_cast<__nv_bfloat162*>(ring + kTile + off) =
            __floats2bfloat162_rn(acc_v[r], acc_v[r + 1]);
      }
    }
    fence_async_smem();
    warpgroup_sync(1);
    if (tl == 0) {
      tma_store_tile<HD>(ring, &tm_dk, kvh, k0, b);
      tma_store_tile<HD>(ring + kTile, &tm_dv, kvh, k0, b);
    }
  }
}

template <int HD>
int launch_dkv_wgmma(const void* q, const void* k, const void* v,
                     const void* dout, const void* L, const void* D, void* dk,
                     void* dv, int B, int S, int Sk, int H, int KV,
                     int causal, int window, cudaStream_t stream) {
  CUtensorMap tq, tk, tv, tdo, tdk, tdv;
  if (!fa_sm90::make_tile_map<HD>(&tq, q, B, S, H) ||
      !fa_sm90::make_tile_map<HD>(&tk, k, B, Sk, KV) ||
      !fa_sm90::make_tile_map<HD>(&tv, v, B, Sk, KV) ||
      !fa_sm90::make_tile_map<HD>(&tdo, dout, B, S, H) ||
      !fa_sm90::make_tile_map<HD>(&tdk, dk, B, Sk, KV) ||
      !fa_sm90::make_tile_map<HD>(&tdv, dv, B, Sk, KV))
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr size_t smem = dkv_wgmma_smem<HD>();
  auto kern = fa_dkv_wgmma_kernel<HD>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(KV, B, (Sk + kBK - 1) / kBK);
  kern<<<grid, 256, smem, stream>>>(
      tq, tk, tv, tdo, tdk, tdv, static_cast<const float*>(L),
      static_cast<const float*>(D), S, Sk, H, KV, causal, window,
      1.0f / sqrtf(static_cast<float>(HD)));
  return static_cast<int>(cudaGetLastError());
}

// ---- dq in bf16: wgmma + TMA -------------------------------------------------
constexpr int kDqStages = 2;  // K/V slabs in flight

// Q, dO; the ring of K/V slabs; the mbarriers.
template <int HD>
constexpr size_t dq_wgmma_smem() {
  return fa_sm90::kAlignSlack +
         (2 + 2 * kDqStages) * fa_sm90::Tile<HD>::kBytes +
         (1 + kDqStages) * sizeof(uint64_t);
}

template <int HD>
__global__ void __launch_bounds__(128, HD == 128 ? 2 : 3)
    fa_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       const __grid_constant__ CUtensorMap tm_do,
                       const __grid_constant__ CUtensorMap tm_dq,
                       const float* __restrict__ L,
                       const float* __restrict__ D, int S, int Sk, int H,
                       int group, int causal, int window, float scale) {
  using namespace fa_sm90;
  constexpr int kTile = Tile<HD>::kBytes;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* q_s = align_1024(smem_raw);
  uint8_t* do_s = q_s + kTile;
  uint8_t* kv_s = do_s + kTile;            // stage st: K, then V
  uint64_t* bar_q = reinterpret_cast<uint64_t*>(kv_s + 2 * kDqStages * kTile);
  uint64_t* bar_kv = bar_q + 1;

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBQ;   // longest tiles first
  const int kvh = h / group;
  const int tid = threadIdx.x;
  const int w = tid >> 5, g = (tid & 31) >> 2, t = tid & 3;

  // the slabs holding an allowed key of some row of this tile
  const int q_last = min(q0 + kBQ, S) - 1;
  const int hi = causal ? min(Sk, q_last + 1) : Sk;
  const int lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int j0 = lo / kBK;
  const int n_slabs = (hi + kBK - 1) / kBK - j0;

  if (tid == 0) {
    tma_prefetch(&tm_q);
    tma_prefetch(&tm_k);
    tma_prefetch(&tm_v);
    tma_prefetch(&tm_do);
    mbar_init(bar_q, 1);
    for (int st = 0; st < kDqStages; ++st) mbar_init(&bar_kv[st], 1);
    mbar_init_fence();
  }
  __syncthreads();
  const CUtensorMap* map_k = &tm_k;
  const CUtensorMap* map_v = &tm_v;
  auto load_slab = [&](int it) {
    uint8_t* dst = kv_s + (it % kDqStages) * 2 * kTile;
    uint64_t* bar = &bar_kv[it % kDqStages];
    mbar_expect_tx(bar, 2 * kTile);
    tma_load_tile<HD>(dst, map_k, bar, kvh, (j0 + it) * kBK, b);
    tma_load_tile<HD>(dst + kTile, map_v, bar, kvh, (j0 + it) * kBK, b);
  };
  if (tid == 0 && n_slabs > 0) {
    mbar_expect_tx(bar_q, 2 * kTile);
    tma_load_tile<HD>(q_s, &tm_q, bar_q, h, q0, b);
    tma_load_tile<HD>(do_s, &tm_do, bar_q, h, q0, b);
    for (int it = 0; it < min(kDqStages, n_slabs); ++it) load_slab(it);
  }

  // This thread's rows 16w + g + 8i (i = 0, 1): their L * log2(e) and D,
  // and their allowed keys [key_lo, key_hi], less 2t (its columns are
  // 8n + 2t + j). Rows past S see no key.
  float l2[2], dr[2];
  int key_lo[2], key_hi[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qp = q0 + 16 * w + g + 8 * i;
    const size_t off = (static_cast<size_t>(b) * H + h) * S + qp;
    l2[i] = qp < S ? L[off] * kLog2e : 0.f;
    dr[i] = qp < S ? D[off] : 0.f;
    key_hi[i] = (qp < S ? (causal ? min(qp, Sk - 1) : Sk - 1) : -1) - 2 * t;
    key_lo[i] = (window > 0 ? qp - window + 1 : 0) - 2 * t;
  }
  const float sl2 = scale * kLog2e;
  float acc[HD / 2];
#pragma unroll
  for (int r = 0; r < HD / 2; ++r) acc[r] = 0.f;
  const uint32_t q_addr = smem_addr(q_s), do_addr = smem_addr(do_s);
  const uint32_t kv_addr = smem_addr(kv_s);
  if (n_slabs > 0) mbar_wait(bar_q, 0);

  for (int it = 0; it < n_slabs; ++it) {
    const int st = it % kDqStages;
    const int k0 = (j0 + it) * kBK;
    const uint32_t k_addr = kv_addr + st * 2 * kTile;
    const uint32_t v_addr = k_addr + kTile;
    mbar_wait(&bar_kv[st], (it / kDqStages) & 1);

    float s[32], dp[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss(s, desc_k<HD>(q_addr, kk), desc_k<HD>(k_addr, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss(dp, desc_k<HD>(do_addr, kk), desc_k<HD>(v_addr, kk), kk > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    fence_regs(dp);

    // P = exp2(s * scale * log2(e) - L log2(e)), 0 where masked; a slab
    // whose every (row, key) is allowed skips the mask (block uniform).
    // dS = P o (dP - D), in dp's registers.
    const bool full = q0 + kBQ <= S && k0 + kBK <= Sk &&
                      (!causal || k0 + kBK - 1 <= q0) &&
                      (window <= 0 || k0 > q0 + kBQ - 1 - window);
#pragma unroll
    for (int r = 0; r < 32; ++r) {
      const int i = (r >> 1) & 1, col = k0 + 8 * (r >> 2) + (r & 1);
      float p = fast_exp2(fmaf(s[r], sl2, -l2[i]));
      if (!full && !(col >= key_lo[i] && col <= key_hi[i])) p = 0.f;
      dp[r] = p * (dp[r] - dr[i]);
    }

    uint32_t a_hi[4][4], a_lo[4][4];
    split_frags(dp, a_hi, a_lo);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs(acc, a_hi[kk], desc_mn<HD>(k_addr, kk));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs(acc, a_lo[kk], desc_mn<HD>(k_addr, kk));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    fence_regs(a_hi);
    fence_regs(a_lo);

    __syncthreads();   // every warp is done with stage st
    if (tid == 0 && it + kDqStages < n_slabs) load_slab(it + kDqStages);
  }

  // dQ = scale * acc goes out through the Q tile's shared memory (free
  // after the loop's last barrier) and one TMA store, which skips rows
  // past S.
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = 16 * w + g + 8 * i;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(q_s +
                                         tile_offset<HD>(row, 8 * n + 2 * t)) =
          __floats2bfloat162_rn(acc[4 * n + 2 * i] * scale,
                                acc[4 * n + 2 * i + 1] * scale);
  }
  fence_async_smem();
  __syncthreads();
  if (tid == 0) tma_store_tile<HD>(q_s, &tm_dq, h, q0, b);
}

template <int HD>
int launch_dq_wgmma(const void* q, const void* k, const void* v,
                    const void* dout, const void* L, const void* D, void* dq,
                    int B, int S, int Sk, int H, int KV, int causal,
                    int window, cudaStream_t stream) {
  CUtensorMap tq, tk, tv, tdo, tdq;
  if (!fa_sm90::make_tile_map<HD>(&tq, q, B, S, H) ||
      !fa_sm90::make_tile_map<HD>(&tk, k, B, Sk, KV) ||
      !fa_sm90::make_tile_map<HD>(&tv, v, B, Sk, KV) ||
      !fa_sm90::make_tile_map<HD>(&tdo, dout, B, S, H) ||
      !fa_sm90::make_tile_map<HD>(&tdq, dq, B, S, H))
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr size_t smem = dq_wgmma_smem<HD>();
  auto kern = fa_dq_wgmma_kernel<HD>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(H, B, (S + kBQ - 1) / kBQ);
  kern<<<grid, 128, smem, stream>>>(
      tq, tk, tv, tdo, tdq, static_cast<const float*>(L),
      static_cast<const float*>(D), S, Sk, H, H / KV, causal, window,
      1.0f / sqrtf(static_cast<float>(HD)));
  return static_cast<int>(cudaGetLastError());
}

template <typename Kern>
cudaError_t set_smem(Kern kern, size_t smem) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// bf16 -> the wgmma kernel; fp32 -> the SIMT kernel.
template <typename T, int HD>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* L, const void* D, void* dq, int B, int S, int Sk,
              int H, int KV, int causal, int window, cudaStream_t stream) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    return launch_dq_wgmma<HD>(q, k, v, dout, L, D, dq, B, S, Sk, H, KV,
                               causal, window, stream);
  } else {
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
}

// bf16 -> the wgmma kernel; fp32 -> the SIMT kernel.
template <typename T, int HD>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* L, const void* D, void* dk, void* dv, int B, int S,
               int Sk, int H, int KV, int causal, int window,
               cudaStream_t stream) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    return launch_dkv_wgmma<HD>(q, k, v, dout, L, D, dk, dv, B, S, Sk, H, KV,
                                causal, window, stream);
  } else {
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
        static_cast<T*>(dk), static_cast<T*>(dv), S, Sk, H, KV, causal,
        window, 1.0f / sqrtf(static_cast<float>(HD)));
    return static_cast<int>(cudaGetLastError());
  }
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
