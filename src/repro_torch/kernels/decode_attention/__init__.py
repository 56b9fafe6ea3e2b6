from repro_torch.kernels.decode_attention.decode import (  # noqa: F401
    decode_attention)
from repro_torch.kernels.decode_attention.paged import (  # noqa: F401
    paged_decode_attention)
from repro_torch.kernels.decode_attention.prefill_paged import (  # noqa: F401
    paged_prefill_attention)
