from repro_torch.kernels.flash_attention.ops import (flash_attention,
                                                    flash_attention_bwd,
                                                    flash_attention_fwd)
from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref,
                                                    attention_fwd_ref)

__all__ = ["attention_bwd_ref", "attention_fwd_ref", "flash_attention",
           "flash_attention_bwd", "flash_attention_fwd"]
