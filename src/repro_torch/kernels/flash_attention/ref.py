"""Plain PyTorch versions for the flash kernel — port of
``repro/kernels/flash_attention/ref.py``: the direct softmax attention and
the chunked flash reference.  The wrapper takes the chunked reference
(on kv heads repeated to H) for CPU tensors, at the block sizes the JAX
wrapper uses; the three must agree."""
from repro_torch.models.attention import direct_attention  # noqa: F401
from repro_torch.models.flash import flash_attention_ref  # noqa: F401
