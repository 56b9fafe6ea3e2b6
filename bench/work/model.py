"""A model's parameter count and operations per token, from its
configuration file: frozen copies of ``ArchConfig.n_params`` (dense
family: attention, SwiGLU FFN, two norms a layer, the embedding once when
tied and twice when not) and of ``Model.model_flops``' 6 N D for a
training step (the train phase's formula in ``chip_smoke.py``); a served
token costs 2 N, N without the embedding tables.
"""
from __future__ import annotations

from typing import Dict


def dense_params(cfg: Dict, embedding: bool = True) -> float:
    d = cfg["hidden_size"]
    ff = cfg["intermediate_size"]
    H, KV = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = cfg.get("head_dim") or d // H
    attn = d * H * hd * 2 + d * KV * hd * 2
    block = attn + 3 * d * ff + 2 * d
    total = cfg["num_hidden_layers"] * block
    if embedding:
        tables = 1 if cfg.get("tie_word_embeddings") else 2
        total += cfg["vocab_size"] * d * tables
    return float(total)


def train_step_flops(cfg: Dict, tokens: int) -> float:
    """6 N D: N with the embedding, D the step's tokens."""
    return 6.0 * dense_params(cfg) * tokens


def forward_flops(cfg: Dict, tokens: int) -> float:
    """2 N D with N the non-embedding parameters."""
    return 2.0 * dense_params(cfg, embedding=False) * tokens
