// Speculative verify attention for Hopper (sm_90a), one launch per call:
// the kernel and its launcher. The entry points are three translation
// units, one per pool dtype (spec_verify_f32.cu, spec_verify_bf16.cu,
// spec_verify_int8.cu): 24 instantiations each (8 head dims x 3 row
// layouts) where one unit held 72 and took 138 s of nvcc alone on the
// card's host, the whole build's wall time; three build in parallel.
//
// Replaces: the Pallas TPU kernel `_spec_verify_kernel` in
//   src/repro/kernels/spec_verify/kernel.py:44 (wrapper
//   `spec_verify_attention_bkgd`), called once per layer per verify round
//   from `models/layers.spec_verify_chunk_attention`.
//
// Computes: for each row b and kv head h, the K chunk queries of the
//   `group` query heads that share h, numbered position-major as the JAX
//   wrapper flattens them (row r = j*group + g is chunk position j, GQA
//   member g; read in place from q (B, K, H, hd)). Query j attends the
//   pool positions <= pos[b] + j on mapped pages of the shared pool
//   (P, ps, KV, hd) read through block_table[b, :]: the committed context
//   plus the chunk's own causal prefix, whose K/V the caller has already
//   written into the pool. A query with no valid position outputs 0. Pools
//   are f32, bf16, or int8 dequantised by the (P, ps, KV) f32 scales. All
//   arithmetic is f32; the output takes q's dtype.
//
// What bounds it: operations, at the spec path's shapes. Each page of K/V
//   is read once for all K*group query rows (K times the paged kernel's
//   arithmetic on the same bytes): at B=32, K=4, 14/2 heads, hd 64 and a
//   256-token context that is 4*hd flops per (query head, key) pair,
//   117 MFLOP, 1.75 us at the f32 rate, against 4.19 MB of K/V, 1.25 us at
//   the HBM rate.
//
// Design: paged_softmax.cuh's block body, the paged kernel's own, with
//   K*group rows in place of group (one warp per row up to 8 rows, then
//   2 rows a warp up to 32, then 4) and query j attending the positions
//   < pos[b] + 1 + j. The chunks come from the paged wrapper's split_plan,
//   which depends on neither lens nor pos, so query j runs exactly the
//   operations the paged kernel runs at lens = pos + j + 1: every query row
//   is bitwise the paged kernel's output at that length, the contract
//   speculative decoding rests on.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "paged_softmax.cuh"

namespace spec_verify {

template <typename KT, int HD, int R, int kThreads>
__global__ void __launch_bounds__(kThreads, 1024 / kThreads)
    spec_verify_kernel(paged_softmax::Args a) {
  paged_softmax::attend<KT, HD, R>(a, a.len[blockIdx.z] + 1);
}

template <typename KT, int HD, int R, int kThreads>
struct VerifyKernel {
  static auto fn() { return spec_verify_kernel<KT, HD, R, kThreads>; }
};

// The launch over pools of element type KT (dtype code kv_code): the
// entry point of each unit. dtype codes: 0 = float32, 1 = bfloat16, 2 =
// int8 (pools only). The NP pages of a row are cut into n_chunks chunks of
// `chunk` whole pages (none empty, n_chunks <= 8), one cluster per (row,
// kv head). Returns the cudaError_t of the launch (0 = success); shapes
// the kernel does not take (K*group above 128 rows, hd not a multiple of
// 32 up to 256, a plan that breaks those rules, another pool dtype)
// return cudaErrorInvalidValue.
template <typename KT, int kv_code>
int launch(const void* q, const void* k, const void* v,
           const void* k_scales, const void* v_scales,
           const void* block_table, const void* pos, void* out, int B,
           int K, int KV, int group, int hd, int P, int ps, int NP,
           int chunk, int n_chunks, int q_dtype, int kv_dtype,
           void* stream) {
  if (kv_dtype != kv_code) return static_cast<int>(cudaErrorInvalidValue);
  paged_softmax::Args a = {};
  a.q = q;
  a.k = k;
  a.v = v;
  a.ks = static_cast<const float*>(k_scales);
  a.vs = static_cast<const float*>(v_scales);
  a.bt = static_cast<const int*>(block_table);
  a.len = static_cast<const int*>(pos);
  a.out = out;
  a.K = K;
  a.KV = KV;
  a.group = group;
  a.P = P;
  a.ps = ps;
  a.NP = NP;
  a.chunk = chunk;
  return paged_softmax::launch_kv<VerifyKernel, 4, KT>(a, B, hd, n_chunks,
                                                       q_dtype, stream);
}

}  // namespace spec_verify
