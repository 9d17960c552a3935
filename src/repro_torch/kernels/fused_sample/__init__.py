from repro_torch.kernels.fused_sample.ops import (apply_top_p, fused_sample,
                                                  fused_sample_tokens)
from repro_torch.kernels.fused_sample.ref import fused_sample_ref

__all__ = ["apply_top_p", "fused_sample", "fused_sample_tokens",
           "fused_sample_ref"]
