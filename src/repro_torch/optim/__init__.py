"""Training optimizers: AdamW with optional posit-compressed moments, and the
learning-rate schedule."""
from repro_torch.optim.adamw import (  # noqa: F401
    AdamWConfig, adamw_init, adamw_update, clip_by_global_norm,
)
from repro_torch.optim.schedule import cosine_warmup  # noqa: F401
