from repro_torch.kernels.flash_attention.flash import (  # noqa: F401
    flash_attention)
