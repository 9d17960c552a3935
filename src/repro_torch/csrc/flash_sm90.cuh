// Hopper tile machinery shared by the bf16 flash-attention kernels
// (flash_attention.cu, flash_attention_bwd.cu) and the SSD scan's
// tensor-core route (ssd_scan.cu): TMA tile loads completed on
// mbarriers and TMA tile stores, shared-memory descriptors for wgmma, the
// wgmma products themselves, the conversion of an f32 accumulator tile
// into bf16 A-operand fragments, and the host code that builds the tensor
// maps. Raw PTX, sm_90a only.
//
// Tiles. Every tile is 64 rows of one head of a (B, n, heads, HD) bf16
// tensor in the model layout, loaded by TMA with a 4-D box (CW, 1, 64, 1)
// over (HD, heads, n, B). A row of CW elements is one swizzle span: 128 B
// (CW = 64) for HD 64 and 128, 64 B (CW = 32) for HD 32. HD 128 is two
// such column chunks, one after the other. TMA writes each chunk with the
// matching 128 B / 64 B swizzle and fills rows past n with zeros; every
// tile starts on a 1024-byte boundary, so the swizzle pattern wgmma reads
// is the one TMA wrote.
//
// Products (m64nNk16, bf16 in, f32 accumulators in registers):
//   - K-major operands (the reduction runs along HD, the contiguous axis):
//     Q and K in S = Q K^T, and K, Q, V, dO in the backward's transposed
//     scores. A k-step is 16 columns (32 bytes) into the row.
//   - MN-major operands (the reduction runs along the tile's rows, and HD
//     is the output width): V in O += P V, dO and Q in dV += P^T dO and
//     dK += dS^T Q. The instruction's transpose bit is set; a k-step is 16
//     rows.
// The accumulator of a 64 x N product gives thread (warp w, lane l) rows
// 16w + l/4 (+8) and columns 8n + 2(l%4) (+1) in register 4n + 2i + j
// (i: +8 rows, j: +1 column). For 16-bit A operands that is also the
// register layout of an A fragment, so an f32 tile of scores becomes the A
// operand of the next product without leaving registers.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace fa_sm90 {

constexpr int kRows = 64;   // rows of every tile, and M of every product
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Shared-memory geometry of one 64-row tile of a head of width HD.
template <int HD>
struct Tile {
  static constexpr int kSwizzle = HD >= 64 ? 128 : 64;  // bytes per row
  static constexpr int kCW = kSwizzle / 2;    // elements per chunk row
  static constexpr int kChunks = HD / kCW;
  static constexpr int kChunkBytes = kRows * kSwizzle;
  static constexpr int kBytes = kChunks * kChunkBytes;  // = 64 * HD * 2
  static_assert(HD == 32 || HD == 64 || HD == 128, "head_dim 32, 64, 128");
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers ------------------------------------------------------------
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival that also announces `bytes` of TMA traffic.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  }
}

// 2^x in one MUFU instruction (relative error about 2^-22; results below
// 2^-126 flush to 0).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Barrier over the 128 threads of one warpgroup (ids 1.. ; 0 is
// __syncthreads).
__device__ __forceinline__ void warpgroup_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

// ---- TMA ------------------------------------------------------------------
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_prefetch(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map))
               : "memory");
}

// Rows row0..row0+63 of head `head` in batch row b: Tile<HD>::kBytes bytes
// that complete on `bar`.
template <int HD>
__device__ __forceinline__ void tma_load_tile(void* dst, const CUtensorMap* map,
                                              uint64_t* bar, int head,
                                              int row0, int b) {
  using T = Tile<HD>;
#pragma unroll
  for (int c = 0; c < T::kChunks; ++c)
    tma_load_4d(static_cast<uint8_t*>(dst) + c * T::kChunkBytes, map, bar,
                c * T::kCW, head, row0, b);
}

// The tile at src (written by threads, in the layout TMA loads) to rows
// row0.. of head `head`: issue, then wait until shared memory has been
// read. Rows past n are not written. The writing threads must have run
// fence_async_smem() and met the issuing thread at a barrier.
template <int HD>
__device__ __forceinline__ void tma_store_tile(const void* src,
                                               const CUtensorMap* map,
                                               int head, int row0, int b) {
  using T = Tile<HD>;
#pragma unroll
  for (int c = 0; c < T::kChunks; ++c)
    asm volatile(
        "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
        " [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
            reinterpret_cast<uint64_t>(map)),
        "r"(smem_addr(static_cast<const uint8_t*>(src) + c * T::kChunkBytes)),
        "r"(c * T::kCW), "r"(head), "r"(row0), "r"(b)
        : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// Make this thread's shared-memory writes visible to TMA.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Byte offset of element (row, col) in a tile, with the swizzle TMA uses.
template <int HD>
__device__ __forceinline__ uint32_t tile_offset(int row, int col) {
  using T = Tile<HD>;
  const int c = col % T::kCW;
  const int swz = T::kSwizzle == 128 ? (row & 7) : ((row >> 1) & 3);
  return (col / T::kCW) * T::kChunkBytes + row * T::kSwizzle +
         ((((c * 2) >> 4) ^ swz) << 4) + ((c * 2) & 15);
}

// ---- wgmma descriptors ----------------------------------------------------
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, int swizzle) {
  const uint64_t layout = swizzle == 128 ? 1 : 2;   // B128 : B64
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (layout << 62);
}

// K-major operand, k-step kk: columns 16kk..16kk+15 of every row.
template <int HD>
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int kk) {
  using T = Tile<HD>;
  const int byte = kk * 32;
  return make_desc(tile + (byte / T::kSwizzle) * T::kChunkBytes +
                       byte % T::kSwizzle,
                   16, 8 * T::kSwizzle, T::kSwizzle);
}

// MN-major operand, k-step kk: rows 16kk..16kk+15, all HD columns (the
// chunks lie kChunkBytes apart).
template <int HD>
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int kk) {
  using T = Tile<HD>;
  return make_desc(tile + kk * 16 * T::kSwizzle, T::kChunkBytes,
                   8 * T::kSwizzle, T::kSwizzle);
}

// ---- wgmma ------------------------------------------------------------------
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}


// Keep the compiler from touching registers that an in-flight wgmma reads
// or writes: call on them after wgmma_wait_all().
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// D (64 x 64, f32) {=, +=} A (64 x 16, smem) * B (16 x 64, smem),
// both K-major; scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                          uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 32, f32) {=, +=} A (64 x 16, smem) * B (16 x 32, smem), both
// K-major; scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t da,
                                          uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 32, f32) += A (64 x 16, registers) * B (16 x 32, smem, MN-major).
__device__ __forceinline__ void wgmma_rs(float (&d)[16],
                                          const uint32_t (&a)[4],
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 64, f32) += A (64 x 16, registers) * B (16 x 64, smem, MN-major).
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                          const uint32_t (&a)[4],
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 128, f32) += A (64 x 16, registers) * B (16 x 128, smem, MN-major).
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                          const uint32_t (&a)[4],
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// Max or sum of the 16 values this thread holds of its row 16w + g + 8i of
// a 64 x 64 accumulator (registers 4n + 2i + j), as a tree of depth 4.
template <bool kMax>
__device__ __forceinline__ float row_tree(const float (&x)[32], int i) {
  float v[16];
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    v[2 * n] = x[4 * n + 2 * i];
    v[2 * n + 1] = x[4 * n + 2 * i + 1];
  }
  auto op = [](float a, float b) { return kMax ? fmaxf(a, b) : a + b; };
#pragma unroll
  for (int k = 0; k < 8; ++k) v[k] = op(v[k], v[k + 8]);
#pragma unroll
  for (int k = 0; k < 4; ++k) v[k] = op(v[k], v[k + 4]);
  return op(op(v[0], v[2]), op(v[1], v[3]));
}

// ---- accumulator -> A fragments -----------------------------------------
__device__ __forceinline__ uint32_t bf162_bits(__nv_bfloat162 v) {
  uint32_t u;
  memcpy(&u, &v, sizeof(u));
  return u;
}

// A 64 x 64 f32 accumulator tile x as the A operand of four k-steps, split
// in two bf16 terms: hi = bf16(x), lo = bf16(x - hi). hi + lo carries 16
// bits of x's mantissa, so two products into one f32 accumulator give x V
// within about 2^-17 of x, where one bf16 rounding would give 2^-9.
__device__ __forceinline__ void split_frags(const float (&x)[32],
                                            uint32_t (&hi)[4][4],
                                            uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float e0 = x[8 * kk + 2 * r], e1 = x[8 * kk + 2 * r + 1];
      const uint32_t h = bf162_bits(__floats2bfloat162_rn(e0, e1));
      hi[kk][r] = h;
      lo[kk][r] = bf162_bits(__floats2bfloat162_rn(
          e0 - __uint_as_float(h << 16), e1 - __uint_as_float(h & 0xffff0000u)));
    }
}

// ---- host: tensor maps ------------------------------------------------------
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime already loaded, so the
// library needs no -lcuda.
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &q);
#endif
    if (e != cudaSuccess || q != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// The map of 64-row tiles of one head of a (B, n, heads, HD) bf16 tensor
// whose last dim is contiguous, with the other three strides given in
// elements (each a multiple of 8: TMA takes strides in whole 16 bytes).
// Returns false if cuTensorMapEncodeTiled refuses it (for instance a base
// address that is not 16-byte aligned).
template <int HD>
bool make_tile_map_strided(CUtensorMap* map, const void* ptr, int B, int n,
                           int heads, long long s_head, long long s_n,
                           long long s_b) {
  using T = Tile<HD>;
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(HD),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(n),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(s_head) * 2,
                                 static_cast<cuuint64_t>(s_n) * 2,
                                 static_cast<cuuint64_t>(s_b) * 2};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(T::kCW), 1,
                             static_cast<cuuint32_t>(kRows), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            T::kSwizzle == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                               : CU_TENSOR_MAP_SWIZZLE_64B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The same map for a contiguous (B, n, heads, HD) tensor.
template <int HD>
bool make_tile_map(CUtensorMap* map, const void* ptr, int B, int n,
                   int heads) {
  const long long row = HD;
  return make_tile_map_strided<HD>(map, ptr, B, n, heads, row, row * heads,
                                   row * heads * n);
}

// Dynamic shared memory is only 16-byte aligned: the kernels round their
// base up to 1024 bytes and ask for this much more.
constexpr int kAlignSlack = 1024;

__device__ __forceinline__ uint8_t* align_1024(uint8_t* p) {
  const uint32_t a = smem_addr(p);
  return p + (((a + 1023u) & ~1023u) - a);
}

}  // namespace fa_sm90
