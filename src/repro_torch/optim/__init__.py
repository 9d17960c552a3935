from repro_torch.optim.adamw import OptState, Optimizer, adamw, apply_updates
from repro_torch.optim.schedule import constant, cosine_schedule, linear_warmup

__all__ = ["OptState", "Optimizer", "adamw", "apply_updates", "constant",
           "cosine_schedule", "linear_warmup"]
