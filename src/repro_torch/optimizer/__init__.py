"""In-repo optimizers: AdamW with global-norm clipping, LR schedules and
gradient compression with error feedback."""
from repro_torch.optimizer.adam import AdamW, AdamWState, global_norm
from repro_torch.optimizer.grad_compress import (
    ErrorFeedbackState, compress_with_error_feedback, init_error_feedback,
    int8_compress, int8_decompress, topk_compress, topk_decompress)
from repro_torch.optimizer.schedule import cosine_schedule, linear_warmup_cosine

__all__ = ["AdamW", "AdamWState", "global_norm", "cosine_schedule",
           "linear_warmup_cosine", "int8_compress", "int8_decompress",
           "topk_compress", "topk_decompress", "ErrorFeedbackState",
           "compress_with_error_feedback", "init_error_feedback"]
