"""zamba2-7b — hybrid Mamba2 trunk + shared attention block.
[arXiv:2411.15242; unverified]
81L d_model=3584 32H (GQA kv=32) d_ff=14336 vocab=32000, ssm_state=64.
Served whole-batch (``ServingEngine``); the paged engine refuses it,
as the JAX package's does.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    d_ff=14336,
    vocab_size=32000,
    ssm_state=64,
    ssm_expand=2,
    ssm_head_dim=64,
    mamba_version=2,
    attn_every=6,
    tie_embeddings=True,
))
