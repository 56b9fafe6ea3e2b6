"""grok-1-314b — MoE, 8 experts top-2.  [hf:xai-org/grok-1; unverified]
64L d_model=6144 48H (GQA kv=8) d_ff=32768 vocab=131072, MoE 8e top-2.
Runs in the port (``models/moe.py``), paged and whole-batch.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="grok-1-314b",
    family="moe",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=32768,
    vocab_size=131072,
    n_experts=8,
    experts_per_token=2,
    ffn_kind="gelu",                 # grok uses GeGLU-style; gelu variant
))
