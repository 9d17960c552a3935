// Flash attention forward for Hopper (sm_90a), plain C entry point, at
// head_dim 32, 64 and 128 (flash_hd160.cu instantiates 160). The kernels
// and their design are in flash_fwd.cuh.
#include "flash_fwd.cuh"

namespace {
using namespace fa_fwd;

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
// head_dim 32, 64 or 128; q_off is the position of query row 0
// (flash_fwd.cuh). Returns the cudaError_t of the launch.
extern "C" int flash_attention_fwd_launch(const void* q, const void* k,
                                          const void* v, void* o, void* L,
                                          int B, int S, int Sk, int H, int KV,
                                          int hd, int causal, int window,
                                          int dtype, int q_off,
                                          void* stream) {
  if (B == 0 || S == 0 || H == 0) return 0;
  if (KV < 1 || H % KV != 0 || Sk < 1 || q_off < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  FA_FWD_DISPATCH(q, k, v, o, L, B, S, Sk, H, KV, causal, window, q_off, s)
}
