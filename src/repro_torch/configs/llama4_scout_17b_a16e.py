"""llama4-scout-17b-a16e — MoE, 16 experts top-1, early fusion.
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]
48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048, MoE 16e top-1.
Runs in the port (``models/moe.py``), paged and whole-batch.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=202048,
    n_experts=16,
    experts_per_token=1,
    rope_theta=500000.0,
))
