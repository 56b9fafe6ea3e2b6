"""granite-20b — dense llama-arch code model with MQA.  [arXiv:2405.04324; hf]
52L d_model=6144 48H (GQA kv=1 == MQA) d_ff=24576 vocab=49152.
48 query heads over one KV head: the paged decode kernel's row-tile walk
(G = 48 > 16 rows a tile) serves it.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="granite-20b",
    family="dense",
    n_layers=52,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,
    d_ff=24576,
    vocab_size=49152,
))
