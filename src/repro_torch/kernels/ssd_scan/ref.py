"""Plain PyTorch version of the SSD scan kernel (port of
``repro/kernels/ssd_scan/ref.py``).

The plain version IS the model's own chunked SSD (``models/mamba.
ssd_chunked``), as in JAX: the kernel must agree with what the mamba2
family computes. It is what the wrapper runs for CPU tensors and what the
CUDA kernel is held against on the card.
"""
from repro_torch.models.mamba import ssd_chunked as ssd_ref  # noqa: F401
