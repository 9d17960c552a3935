// Flash attention at head_dim 160 (stablelm-12b) for Hopper (sm_90a): the
// forward, dq and dk/dv kernels of flash_fwd.cuh and flash_bwd.cuh
// instantiated at HD = 160, plain C entry points with the signatures of
// flash_attention.cu and flash_attention_bwd.cu.
//
// A translation unit of its own: nvcc compiles each source in its own
// process, all in parallel, so these instantiations add no time to the
// build of the other head dims.
//
// bf16 runs the wgmma kernels on 160-wide tiles: a 320-byte row is 2.5 of
// the 128-byte swizzle spans the narrower head dims use, so each tile is
// five 32-column chunks with the 64-byte swizzle (TMA boxes of 32 columns),
// and the products whose output width is the head dim (O += P V, dQ += dS K,
// dV += P^T dO, dK += dS^T Q) are m64n160k16 (flash_sm90.cuh). fp32 runs
// the SIMT kernels.
#include "flash_bwd.cuh"
#include "flash_fwd.cuh"

// dtype codes: 0 = float32, 1 = bfloat16; head_dim 160 only. Each returns
// the cudaError_t of its launch. The forward's q_off is the position of
// query row 0 (flash_fwd.cuh).
extern "C" int flash_attention_fwd_launch(const void* q, const void* k,
                                          const void* v, void* o, void* L,
                                          int B, int S, int Sk, int H, int KV,
                                          int hd, int causal, int window,
                                          int dtype, int q_off,
                                          void* stream) {
  if (B == 0 || S == 0 || H == 0) return 0;
  if (hd != 160 || KV < 1 || H % KV != 0 || Sk < 1 || q_off < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return fa_fwd::launch_simt<160>(q, k, v, o, L, B, S, Sk, H, KV, causal,
                                    window, q_off, s);
  if (dtype == 1)
    return fa_fwd::launch_wgmma<160>(q, k, v, o, L, B, S, Sk, H, KV, causal,
                                     window, q_off, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int flash_attention_dq_launch(const void* q, const void* k,
                                         const void* v, const void* dout,
                                         const void* L, const void* D,
                                         void* dq, int B, int S, int Sk,
                                         int H, int KV, int hd, int causal,
                                         int window, int dtype,
                                         void* stream) {
  if (B == 0 || S == 0 || H == 0) return 0;
  if (hd != 160 || KV < 1 || H % KV != 0 || Sk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return fa_bwd::launch_dq<float, 160>(q, k, v, dout, L, D, dq, B, S, Sk,
                                         H, KV, causal, window, s);
  if (dtype == 1)
    return fa_bwd::launch_dq<__nv_bfloat16, 160>(q, k, v, dout, L, D, dq, B,
                                                 S, Sk, H, KV, causal, window,
                                                 s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int flash_attention_dkv_launch(const void* q, const void* k,
                                          const void* v, const void* dout,
                                          const void* L, const void* D,
                                          void* dk, void* dv, int B, int S,
                                          int Sk, int H, int KV, int hd,
                                          int causal, int window, int dtype,
                                          void* stream) {
  if (B == 0 || Sk == 0 || KV == 0) return 0;
  if (hd != 160 || H % KV != 0 || S < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return fa_bwd::launch_dkv<float, 160>(q, k, v, dout, L, D, dk, dv, B, S,
                                          Sk, H, KV, causal, window, s);
  if (dtype == 1)
    return fa_bwd::launch_dkv<__nv_bfloat16, 160>(q, k, v, dout, L, D, dk,
                                                  dv, B, S, Sk, H, KV, causal,
                                                  window, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
