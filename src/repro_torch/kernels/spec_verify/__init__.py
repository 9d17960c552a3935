from repro_torch.kernels.spec_verify.ops import spec_verify_attention
from repro_torch.kernels.spec_verify.ref import spec_verify_attention_ref

__all__ = ["spec_verify_attention", "spec_verify_attention_ref"]
