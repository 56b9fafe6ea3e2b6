"""falcon-mamba-7b — pure Mamba1, attention-free.  [arXiv:2410.05355]
64L d_model=4096 (attn-free) vocab=65024, ssm_state=16.
No KV cache: decode carries a constant-size (conv, ssm) state per layer.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="falcon-mamba-7b",
    family="ssm",
    n_layers=64,
    d_model=4096,
    n_heads=1,                       # unused (attention-free)
    n_kv_heads=1,
    d_ff=0,
    vocab_size=65024,
    ssm_state=16,
    ssm_expand=2,
    mamba_version=1,
    tie_embeddings=True,
))
