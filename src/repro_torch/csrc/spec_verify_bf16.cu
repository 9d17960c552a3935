// Speculative verify attention over bfloat16 pools: the entry point of
// spec_verify.cuh's kernel for pool dtype code 1 (the other dtypes are
// their own units, built in parallel).
#include "spec_verify.cuh"

extern "C" int spec_verify_launch(
    const void* q, const void* k, const void* v, const void* k_scales,
    const void* v_scales, const void* block_table, const void* pos,
    void* out, int B, int K, int KV, int group, int hd, int P, int ps,
    int NP, int chunk, int n_chunks, int q_dtype, int kv_dtype,
    void* stream) {
  return spec_verify::launch<__nv_bfloat16, 1>(
      q, k, v, k_scales, v_scales, block_table, pos, out, B, K, KV, group,
      hd, P, ps, NP, chunk, n_chunks, q_dtype, kv_dtype, stream);
}
