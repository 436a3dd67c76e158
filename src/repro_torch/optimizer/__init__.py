"""In-repo optimizers: AdamW with global-norm clipping and LR schedules."""
from repro_torch.optimizer.adam import AdamW, AdamWState, global_norm
from repro_torch.optimizer.schedule import cosine_schedule, linear_warmup_cosine

__all__ = ["AdamW", "AdamWState", "global_norm", "cosine_schedule",
           "linear_warmup_cosine"]
