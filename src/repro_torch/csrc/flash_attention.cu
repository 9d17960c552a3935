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
//   stride; O is written in that layout, L as (B,H,S) f32. O takes q's
//   dtype (f32 or bf16).
//
// What bounds it: at the update's shapes (B=32, S=256, 14/2 heads, hd 64,
//   bf16) the causal forward does 3.8e9 flops on 34 MB, 112 flops a byte:
//   below the tensor cores' balance (about 295 bf16 flops a byte), so the
//   floor is the bytes, about 10 us. At S=2048 (B=4) it does 31 GFLOP on
//   17 MB and crosses the balance: the tensor cores set that floor.
//
// bf16 design (`fa_fwd_wgmma_kernel`, tile machinery in flash_sm90.cuh):
//   one warpgroup (128 threads) per (q head, b, 64-row q tile); the grid
//   puts the q tile slowest and walks it from the last tile down, so the
//   tiles with the most slabs start first. Thread 0 loads the q tile and
//   the K/V slabs by TMA into a two-stage ring completed on mbarriers, so
//   slab j+1 is in flight while slab j is multiplied; a stage is refilled
//   after the block's barrier at the end of the slab that used it. S = Q
//   K^T is one wgmma chain (A = Q, B = K, both K-major, f32 accumulators
//   in registers). Mask and online softmax run on the accumulator in
//   registers, in log2 units (one FMA and one MUFU ex2 per score); each
//   row lives on the four lanes of a quad, and its max and sum are trees.
//   Slabs whose every (row, key) is allowed skip the mask. O += P V takes
//   P from those registers as the A operand and V as an MN-major B. O
//   leaves through the q tile's shared memory and one TMA store (full
//   lines; rows past S are clipped by the map).
//   What sets its pace is latency, not issue or the tensor cores: blocks
//   are short (1-4 slabs at S = 256), so the kernel keeps as many
//   independent blocks resident as it can: 96 registers and 41 KB of
//   shared memory a block, five per SM. Two warpgroups per block (sharing
//   K/V), two q tiles per block, three stages and overlapping one slab's
//   softmax with the next slab's products were each slower at the
//   update's shape on an H100: each cost resident blocks.
//   Precision: the scale multiplies the f32 accumulator (scale * q in bf16
//   would round at hd 32, where 1/sqrt(hd) is not a power of two). P V
//   needs P in bf16, and one rounding puts about 2^-9 |v| on every output
//   element, far above the 2^-18 s gate for outputs near zero. So P is
//   split into hi = bf16(P) and lo = bf16(P - hi) and both are multiplied
//   into the same accumulator (about 2^-17 of P): the products grow from
//   112 to 168 flops a byte, still below the balance.
//   Left for later: the long-context shape, where the products set the
//   pace (a 128-row tile over two warpgroups, a producer warp with
//   setmaxnreg, softmax of one slab under the products of the next).
//
// fp32 inputs keep the first SIMT design (`fa_fwd_kernel<float>`): one
//   block of 256 threads per (b, q head, 64-row q tile); K/V slabs of 64
//   keys through padded f32 shared-memory tiles, f32 FMAs (67 TFLOP/s, so
//   a 57 us floor at the update's shape). TF32 tensor cores would break
//   the fp32 gate of 2^-18 s, and fp32 is off the main path.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_sm90.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kBQ = 64;       // query rows per tile
constexpr int kBK = 64;       // keys per slab
constexpr int kThreads = 256; // 16 x 16

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }

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

// ---- bf16: wgmma + TMA -----------------------------------------------------
constexpr int kStages = 2;    // K/V slabs in flight

template <int HD>
constexpr size_t wgmma_smem() {
  return fa_sm90::kAlignSlack + (1 + 2 * kStages) * fa_sm90::Tile<HD>::kBytes +
         (1 + kStages) * sizeof(uint64_t);
}

template <int HD>
__global__ void __launch_bounds__(128, HD == 128 ? 2 : 5)
    fa_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                        const __grid_constant__ CUtensorMap tm_k,
                        const __grid_constant__ CUtensorMap tm_v,
                        const __grid_constant__ CUtensorMap tm_o,
                        float* __restrict__ Lout, int S, int Sk, int H,
                        int group, int causal, int window, float scale) {
  using namespace fa_sm90;
  constexpr int kTile = Tile<HD>::kBytes;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* q_s = align_1024(smem_raw);
  uint8_t* kv_s = q_s + kTile;             // stage st: K, then V
  uint64_t* bar_q = reinterpret_cast<uint64_t*>(kv_s + 2 * kStages * kTile);
  uint64_t* bar_kv = bar_q + 1;

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBQ;   // longest tiles first
  const int kvh = h / group;
  const int tid = threadIdx.x;
  const int w = tid >> 5, g = (tid & 31) >> 2, t = tid & 3;

  const int q_last = min(q0 + kBQ, S) - 1;
  const int hi = causal ? min(Sk, q_last + 1) : Sk;
  const int lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int j0 = lo / kBK;
  const int n_slabs = (hi + kBK - 1) / kBK - j0;

  if (tid == 0) {
    tma_prefetch(&tm_q);
    tma_prefetch(&tm_k);
    tma_prefetch(&tm_v);
    mbar_init(bar_q, 1);
    for (int st = 0; st < kStages; ++st) mbar_init(&bar_kv[st], 1);
    mbar_init_fence();
  }
  __syncthreads();
  const CUtensorMap* map_k = &tm_k;
  const CUtensorMap* map_v = &tm_v;
  auto load_slab = [&](int it) {
    uint8_t* dst = kv_s + (it % kStages) * 2 * kTile;
    uint64_t* bar = &bar_kv[it % kStages];
    mbar_expect_tx(bar, 2 * kTile);
    tma_load_tile<HD>(dst, map_k, bar, kvh, (j0 + it) * kBK, b);
    tma_load_tile<HD>(dst + kTile, map_v, bar, kvh, (j0 + it) * kBK, b);
  };
  if (tid == 0 && n_slabs > 0) {
    mbar_expect_tx(bar_q, kTile);
    tma_load_tile<HD>(q_s, &tm_q, bar_q, h, q0, b);
    for (int it = 0; it < min(kStages, n_slabs); ++it) load_slab(it);
  }

  // This thread's rows 16w + g + 8i (i = 0, 1) and their allowed keys
  // [key_lo, key_hi], less 2t (its columns are 8n + 2t + j).
  int key_lo[2], key_hi[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qp = q0 + 16 * w + g + 8 * i;
    key_hi[i] = (qp < S ? (causal ? min(qp, Sk - 1) : Sk - 1) : -1) - 2 * t;
    key_lo[i] = (window > 0 ? qp - window + 1 : 0) - 2 * t;
  }
  // Scores in log2 units: p = exp2(s * scale * log2(e) - m).
  const float sl2 = scale * kLog2e;
  float m_run[2] = {kNegInf, kNegInf}, l_run[2] = {0.f, 0.f};
  float acc[HD / 2];
#pragma unroll
  for (int r = 0; r < HD / 2; ++r) acc[r] = 0.f;
  const uint32_t q_addr = smem_addr(q_s), kv_addr = smem_addr(kv_s);
  if (n_slabs > 0) mbar_wait(bar_q, 0);

  for (int it = 0; it < n_slabs; ++it) {
    const int st = it % kStages;
    const int k0 = (j0 + it) * kBK;
    const uint32_t k_addr = kv_addr + st * 2 * kTile;
    mbar_wait(&bar_kv[st], (it / kStages) & 1);

    float s[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss(s, desc_k<HD>(q_addr, kk), desc_k<HD>(k_addr, kk), kk > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    // A slab whose every (row, key) is allowed skips the mask (block
    // uniform); otherwise masked scores become NEG_INF in log2 units.
    const bool full = q0 + kBQ <= S && k0 + kBK <= Sk &&
                      (!causal || k0 + kBK - 1 <= q0) &&
                      (window <= 0 || k0 > q0 + kBQ - 1 - window);
    float c = sl2;
    if (!full) {
#pragma unroll
      for (int r = 0; r < 32; ++r) {
        const int i = (r >> 1) & 1, col = k0 + 8 * (r >> 2) + (r & 1);
        s[r] = col >= key_lo[i] && col <= key_hi[i] ? s[r] * sl2 : kNegInf;
      }
      c = 1.f;
    }
    float mx[2] = {row_tree<true>(s, 0), row_tree<true>(s, 1)};
    float alpha[2], m_neg[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m_run[i], mx[i] * c);
      alpha[i] = fast_exp2(m_run[i] - m_new);
      m_run[i] = m_new;
      m_neg[i] = -m_new;
      l_run[i] *= alpha[i];
    }
#pragma unroll
    for (int r = 0; r < 32; ++r)
      s[r] = fast_exp2(fmaf(s[r], c, m_neg[(r >> 1) & 1]));
    l_run[0] += row_tree<false>(s, 0);
    l_run[1] += row_tree<false>(s, 1);
#pragma unroll
    for (int r = 0; r < HD / 2; ++r) acc[r] *= alpha[(r >> 1) & 1];

    uint32_t p_hi[4][4], p_lo[4][4];
    split_frags(s, p_hi, p_lo);
    const uint32_t v_addr = k_addr + kTile;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs(acc, p_hi[kk], desc_mn<HD>(v_addr, kk));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs(acc, p_lo[kk], desc_mn<HD>(v_addr, kk));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    fence_regs(p_hi);
    fence_regs(p_lo);

    __syncthreads();   // every warp is done with stage st
    if (tid == 0 && it + kStages < n_slabs) load_slab(it + kStages);
  }

  // O goes out through the q tile's shared memory (free once the last
  // S = Q K^T is done) and one TMA store, which skips rows past S.
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_run[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    l = (l == 0.f) ? 1.f : l;                 // fully masked row -> 0
    const float inv_l = 1.f / l;
    const int row = 16 * w + g + 8 * i;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(q_s +
                                         tile_offset<HD>(row, 8 * n + 2 * t)) =
          __floats2bfloat162_rn(acc[4 * n + 2 * i] * inv_l,
                                acc[4 * n + 2 * i + 1] * inv_l);
    if (t == 0 && q0 + row < S)
      Lout[(static_cast<size_t>(b) * H + h) * S + q0 + row] =
          m_run[i] * kLn2 + logf(l);
  }
  fence_async_smem();
  __syncthreads();
  if (tid == 0) tma_store_tile<HD>(q_s, &tm_o, h, q0, b);
}

// ---- launchers --------------------------------------------------------------
template <int HD>
int launch_simt(const void* q, const void* k, const void* v, void* o,
                void* L, int B, int S, int Sk, int H, int KV, int causal,
                int window, cudaStream_t stream) {
  constexpr int P = HD + 1;
  const size_t smem =
      (static_cast<size_t>(kBQ) * P + 2 * kBK * P + kBQ * (kBK + 1) +
       3 * kBQ) * sizeof(float);
  auto kern = fa_fwd_kernel<float, HD>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o),
      static_cast<float*>(L), S, Sk, H, KV, causal, window,
      1.0f / sqrtf(static_cast<float>(HD)));
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_wgmma(const void* q, const void* k, const void* v, void* o,
                 void* L, int B, int S, int Sk, int H, int KV, int causal,
                 int window, cudaStream_t stream) {
  CUtensorMap tq, tk, tv, to;
  if (!fa_sm90::make_tile_map<HD>(&tq, q, B, S, H) ||
      !fa_sm90::make_tile_map<HD>(&tk, k, B, Sk, KV) ||
      !fa_sm90::make_tile_map<HD>(&tv, v, B, Sk, KV) ||
      !fa_sm90::make_tile_map<HD>(&to, o, B, S, H))
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr size_t smem = wgmma_smem<HD>();
  auto kern = fa_fwd_wgmma_kernel<HD>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(H, B, (S + kBQ - 1) / kBQ);
  kern<<<grid, 128, smem, stream>>>(
      tq, tk, tv, to, static_cast<float*>(L), S,
      Sk, H, H / KV, causal, window, 1.0f / sqrtf(static_cast<float>(HD)));
  return static_cast<int>(cudaGetLastError());
}

// Dispatch on (dtype code, head_dim): fp32 -> SIMT, bf16 -> wgmma.
#define FA_FWD_DISPATCH(...)                                             \
  switch (dtype * 1000 + hd) {                                           \
    case 32: return launch_simt<32>(__VA_ARGS__);                        \
    case 64: return launch_simt<64>(__VA_ARGS__);                        \
    case 128: return launch_simt<128>(__VA_ARGS__);                      \
    case 1032: return launch_wgmma<32>(__VA_ARGS__);                     \
    case 1064: return launch_wgmma<64>(__VA_ARGS__);                     \
    case 1128: return launch_wgmma<128>(__VA_ARGS__);                    \
    default: return static_cast<int>(cudaErrorInvalidValue);             \
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
  FA_FWD_DISPATCH(q, k, v, o, L, B, S, Sk, H, KV, causal, window, s)
}
