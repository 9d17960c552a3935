"""Device resolution shared by the port's entry points."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the GPU: entry points run on the card unless the
    caller asks for the CPU. Raises when a CUDA device is requested and
    none is present (no silent CPU fallback)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' explicitly to "
            "run the port on the CPU (kernels then use their plain PyTorch "
            "versions)")
    return dev
