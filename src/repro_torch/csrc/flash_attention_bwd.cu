// Flash attention backward for Hopper (sm_90a): the dq and dk/dv
// passes, plain C entry points, at head_dim 32, 64 and 128 (flash_hd160.cu
// instantiates 160). The kernels and their design are in flash_bwd.cuh.
#include "flash_bwd.cuh"

namespace {
using namespace fa_bwd;

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
