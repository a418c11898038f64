from repro_torch.optim.adamw import adamw_init, adamw_update
from repro_torch.optim.schedule import cosine_schedule
from repro_torch.optim.grad_compress import (
    compress_decompress_grads, init_error_feedback,
)
