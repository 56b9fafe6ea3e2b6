"""qwen2-vl-72b — VLM backbone with M-RoPE.  [arXiv:2409.12191; hf]
80L d_model=8192 64H (GQA kv=8) d_ff=29568 vocab=152064.
Runs in the port: ``Model.prefill`` takes the stub frontend's (B, S, d)
embeddings and (3, B, S) M-RoPE position streams; decode and the paged
engine take text tokens through the embedding table.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="qwen2-vl-72b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=29568,
    vocab_size=152064,
    embed_inputs=False,
    mrope_sections=(16, 24, 24),     # sums to head_dim/2 = 64
    qkv_bias=True,
))
