// Paged decode attention for Hopper (sm_90a), one launch per call, plain C
// entry point.
//
// Replaces: the Pallas TPU kernel `_paged_decode_kernel` in
//   src/repro/kernels/paged_attention/kernel.py:33 (wrapper
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
//   page once from device memory: at B=32, a full 256-token context, 2 kv
//   heads and hd 64 in bf16 that is 4.19 MB, 1.25 us at 3.35 TB/s. What
//   the card spends at that size is latency: two dependent round trips
//   (the block table, then the pages it maps) and the merge.
//
// Design: paged_softmax.cuh's block body, shared with spec_verify.cu, with
//   one query per row (K = 1, row attends positions < lens[b]): the page
//   axis split over a cluster of up to 8 blocks per (row, kv head), one
//   warp per query head of the group, the block table read first, 16-byte
//   cp.async loads of the live pages two tiles ahead, a key's dot product
//   over HD/8 lanes, and the chunks merged through distributed shared
//   memory in the same launch. The wrapper's split_plan picks the chunks.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "paged_softmax.cuh"

namespace {

template <typename KT, int HD, int R, int kThreads>
__global__ void __launch_bounds__(kThreads, 1024 / kThreads)
    paged_decode_kernel(paged_softmax::Args a) {
  paged_softmax::attend<KT, HD, R>(a, a.len[blockIdx.z]);
}

template <typename KT, int HD, int R, int kThreads>
struct PagedKernel {
  static auto fn() { return paged_decode_kernel<KT, HD, R, kThreads>; }
};

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16, 2 = int8 (pools only). q and out
// are (B, KV*group, hd) contiguous. The NP pages of a row are cut into
// n_chunks chunks of `chunk` whole pages (none empty, n_chunks <= 8), one
// cluster per (row, kv head). Returns the cudaError_t of the launch (0 =
// success); shapes the kernel does not take (group above 32, hd not a
// multiple of 32 up to 256, a plan that breaks those rules) return
// cudaErrorInvalidValue.
extern "C" int paged_attention_launch(
    const void* q, const void* k, const void* v, const void* k_scales,
    const void* v_scales, const void* block_table, const void* lens,
    void* out, int B, int KV, int group, int hd, int P, int ps, int NP,
    int chunk, int n_chunks, int q_dtype, int kv_dtype, void* stream) {
  paged_softmax::Args a = {};
  a.q = q;
  a.k = k;
  a.v = v;
  a.ks = static_cast<const float*>(k_scales);
  a.vs = static_cast<const float*>(v_scales);
  a.bt = static_cast<const int*>(block_table);
  a.len = static_cast<const int*>(lens);
  a.out = out;
  a.K = 1;
  a.KV = KV;
  a.group = group;
  a.P = P;
  a.ps = ps;
  a.NP = NP;
  a.chunk = chunk;
  return paged_softmax::launch_all<PagedKernel, 1>(a, B, hd, n_chunks,
                                                   q_dtype, kv_dtype, stream);
}
