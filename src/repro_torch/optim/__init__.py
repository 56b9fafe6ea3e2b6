from repro_torch.optim.adamw import AdamW, AdamWConfig  # noqa: F401
from repro_torch.optim.schedule import (  # noqa: F401
    constant, cosine_with_warmup, linear_warmup)
