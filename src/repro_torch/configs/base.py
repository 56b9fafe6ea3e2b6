"""ArchConfig — the port's copy of ``repro/configs/base.py``.

The dataclass is copied field for field (the tests hold it equal to the
JAX package's for every ported arch), so one config describes the same
model in both packages.  All ten of the JAX package's archs are
registered, and all run: the dense ones (granite-8b, the serving arch;
granite-20b; qwen2-0.5b, the test arch; phi4-mini-3.8b), the MoE ones
(llama4-scout-17b-a16e, grok-1-314b), falcon-mamba-7b (Mamba1,
whole-batch serving), zamba2-7b (the Mamba2 hybrid with a shared
attention block, whole-batch serving), qwen2-vl-72b (M-RoPE, embedding
inputs; paged serving of text prompts) and whisper-large-v3 (the
encoder-decoder, at the Model level).
``n_params`` / ``active_params`` (the 6ND count of ``model_flops``) and
``ShapeConfig`` / ``SHAPES`` and ``shape_applicable`` are copied too.
``attention_impl`` is mirrored for equality only: in the port the DEVICE
of the tensors picks the paged-attention implementation (CUDA tensors
always reach the hand-written kernels, CPU tensors the plain version),
never this field.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense | moe | hybrid | ssm | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: int = 0                  # 0 -> d_model // n_heads
    # --- attention flavor --------------------------------------------------
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    mrope_sections: Tuple[int, ...] = ()   # qwen2-vl M-RoPE (t, h, w) halves
    causal: bool = True
    # --- ffn ---------------------------------------------------------------
    ffn_kind: str = "swiglu"         # swiglu | gelu
    # --- MoE ---------------------------------------------------------------
    n_experts: int = 0
    experts_per_token: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    ep_shards: int = 16
    # --- SSM (mamba) --------------------------------------------------------
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    mamba_version: int = 0           # 0 none | 1 | 2
    attn_every: int = 0
    # --- encoder-decoder -----------------------------------------------------
    is_encoder_decoder: bool = False
    encoder_layers: int = 0
    # --- frontend ---------------------------------------------------------
    embed_inputs: bool = True
    # --- norms / numerics -------------------------------------------------
    norm_kind: str = "rmsnorm"       # rmsnorm | layernorm
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    tie_embeddings: bool = False
    # --- implementation switches ------------------------------------------
    attention_impl: str = "reference"     # mirrored only (see module doc)
    pages_per_step: int = 1          # accepted by the paged kernels; does
                                     # not change any result
    prefill_chunk_tokens: int = 0    # prompt tokens per prefill-lane chunk
                                     # (0 = auto: 2x the serving page size)
    kv_dtype: str = "bf16"           # paged KV pools: "bf16" | "int8"
    draft_arch: str = ""
    attn_chunk_q: int = 1024
    attn_chunk_kv: int = 1024
    ssm_chunk: int = 256
    remat: str = "block"
    remat_group: int = 1
    scan_layers: bool = True

    @property
    def head_dim(self) -> int:
        return self.d_head or (self.d_model // self.n_heads)

    @property
    def param_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32

    @property
    def kv_quantized(self) -> bool:
        if self.kv_dtype not in ("bf16", "int8"):
            raise ValueError(f"kv_dtype must be 'bf16' or 'int8', "
                             f"got {self.kv_dtype!r}")
        return self.kv_dtype == "int8"

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        return self.family in ("ssm", "hybrid")

    def n_params(self) -> float:
        """Approximate parameter count (embedding + blocks), for 6ND."""
        d, ff, v = self.d_model, self.d_ff, self.vocab_size
        hd = self.head_dim
        attn = d * (self.n_heads * hd) * 2 + d * (self.n_kv_heads * hd) * 2
        if self.ffn_kind == "swiglu":
            ffn = 3 * d * ff
        else:
            ffn = 2 * d * ff
        if self.n_experts:
            ffn = ffn * self.n_experts + d * self.n_experts
        block = attn + ffn + 2 * d
        if self.mamba_version:
            d_in = d * self.ssm_expand
            if self.mamba_version == 1:
                dt_rank = max(1, d // 16)
                ssm_blk = (d * 2 * d_in + d_in * self.ssm_conv
                           + d_in * (dt_rank + 2 * self.ssm_state)
                           + dt_rank * d_in + d_in * self.ssm_state
                           + d_in + d_in * d)
            else:
                n_heads = d_in // self.ssm_head_dim
                ssm_blk = (d * (2 * d_in + 2 * self.ssm_state * 1 + n_heads)
                           + d_in * self.ssm_conv + d_in * d + n_heads)
            if self.family == "hybrid" and self.attn_every:
                n_attn = self.n_layers // self.attn_every
                block = ssm_blk + 2 * d
                total_blocks = self.n_layers * block + (attn + 2 * d)  # shared
                return float(total_blocks + v * d * (1 if self.tie_embeddings else 2))
            block = ssm_blk + 2 * d
        total = self.n_layers * block
        if self.is_encoder_decoder:
            # encoder blocks + decoder cross-attn
            enc_block = attn + ffn + 2 * d
            total += self.encoder_layers * enc_block + self.n_layers * (attn + d)
        total += v * d * (1 if self.tie_embeddings else 2)
        return float(total)

    def active_params(self) -> float:
        """Params touched per token (MoE: only routed experts)."""
        if not self.n_experts:
            return self.n_params()
        d, ff = self.d_model, self.d_ff
        expert = 3 * d * ff if self.ffn_kind == "swiglu" else 2 * d * ff
        inactive = (self.n_experts - self.experts_per_token) * expert
        return self.n_params() - self.n_layers * inactive

    def reduced(self) -> "ArchConfig":
        """Tiny same-family variant for CPU smoke tests."""
        scale = dict(
            n_layers=min(self.n_layers, 2 if not self.attn_every
                         else self.attn_every),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) or 1,
            d_ff=128,
            vocab_size=256,
            d_head=16,
            n_experts=min(self.n_experts, 4),
            experts_per_token=min(self.experts_per_token, 2),
            ep_shards=min(self.n_experts, 4) if self.n_experts else 16,
            ssm_state=min(self.ssm_state, 8) if self.ssm_state else 0,
            ssm_head_dim=16,
            encoder_layers=min(self.encoder_layers, 2),
            mrope_sections=(4, 2, 2) if self.mrope_sections else (),
            attn_chunk_q=32,
            attn_chunk_kv=32,
            ssm_chunk=16,
            name=self.name + "-reduced",
        )
        return dataclasses.replace(self, **scale)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # train | prefill | decode


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def shape_applicable(arch: ArchConfig, shape: ShapeConfig) -> Optional[str]:
    """None if the (arch, shape) cell runs; else the reason it is
    skipped, the JAX package's."""
    if shape.name == "long_500k" and not arch.sub_quadratic:
        return ("long_500k requires sub-quadratic attention (skip: pure "
                "full-attention arch)")
    return None


_REGISTRY: Dict[str, ArchConfig] = {}


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def registry() -> Dict[str, ArchConfig]:
    if not _REGISTRY:
        from repro_torch.configs import (  # noqa: F401  (populates)
            falcon_mamba_7b, granite_8b, granite_20b, grok_1_314b,
            llama4_scout_17b_a16e, phi4_mini_3_8b, qwen2_0_5b, qwen2_vl_72b,
            whisper_large_v3, zamba2_7b)
    return _REGISTRY


def get(name: str) -> ArchConfig:
    reg = registry()
    if name not in reg:
        raise KeyError(f"unknown arch {name!r}; have {sorted(reg)}")
    return reg[name]
