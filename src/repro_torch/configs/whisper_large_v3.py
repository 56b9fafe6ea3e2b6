"""whisper-large-v3 — encoder-decoder audio backbone.  [arXiv:2212.04356]
32L d_model=1280 20H (kv=20) d_ff=5120 vocab=51866.
Runs in the port at the Model level (``Model.prefill`` with the stub
frontend's frames and the decoder's tokens, ``decode_step``,
``decode_many``); both engines refuse it, as the JAX package's do.
Encoder and decoder positions are the fixed sinusoidal table
(``layers.sinusoidal_positions``), as the JAX code computes them.
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
    rope_theta=0.0,                  # no rotary: sinusoidal positions
    tie_embeddings=True,
))
