"""whisper-large-v3 — encoder-decoder audio backbone.  [arXiv:2212.04356]
32L d_model=1280 20H (kv=20) d_ff=5120 vocab=51866.
Config mirror only: ``transformer.check_supported`` refuses the
encoder-decoder family.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="whisper-large-v3",
    family="audio",
    n_layers=32,                     # decoder layers
    encoder_layers=32,
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    d_ff=5120,
    vocab_size=51866,
    is_encoder_decoder=True,
    embed_inputs=False,              # frontend stub feeds embeddings
    ffn_kind="gelu",
    norm_kind="layernorm",
    rope_theta=0.0,                  # learned absolute positions
    tie_embeddings=True,
))
