"""Plain PyTorch versions of the dense and the two paged decode-attention
kernels — port of ``repro/kernels/decode_attention/ref.py``.

``decode_attention_ref`` is ``direct_attention`` with the whole-batch
cache's masks.  For the paged pair, a block-table gather materializes
each slot's logical view of the pool (live pages plus null-page padding,
never the whole pool), then ``direct_attention`` masks and softmaxes it.
The CPU tests hold these against the JAX package's Pallas kernels and
oracles, the kernel wrappers take them for CPU tensors, and
``chip_smoke.py`` holds the CUDA kernels against them on the card.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models.attention import direct_attention


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         kv_len, kv_start: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """q (B, 1, H, D); k, v (B, T, KV, D); kv_len a scalar (positions >=
    kv_len masked); kv_start (B,) or None (positions < kv_start[b]
    masked).  A slot whose window is empty softmaxes uniformly over all T
    positions here, where the CUDA kernel gives zeros.  Returns
    (B, 1, H, D)."""
    return direct_attention(q, k, v, causal=True, q_offset=kv_len - 1,
                            kv_len=kv_len, kv_start=kv_start)


def _gather_logical(q, k_pool, v_pool, block_table, layer,
                    k_scale=None, v_scale=None):
    """Each slot's pages gathered into the logical (B, NB*page, KV, D)
    view.  int8 pools are dequantized with the kernels' arithmetic (upcast
    to f32, times the row's scale), then cast to q's dtype as the JAX
    oracle does."""
    if k_pool.ndim == 4:
        k_pool, v_pool = k_pool[None], v_pool[None]
        if k_scale is not None:
            k_scale, v_scale = k_scale[None], v_scale[None]
    B, NB = block_table.shape
    _, _, page, KV, D = k_pool.shape
    tbl = block_table.long()
    kg = k_pool[layer][tbl]                  # (B, NB, page, KV, D)
    vg = v_pool[layer][tbl]
    if k_scale is not None:                  # int8 pages + per-row scales
        kg = kg.to(torch.float32) * k_scale[layer][tbl][..., None]
        vg = vg.to(torch.float32) * v_scale[layer][tbl][..., None]
        kg = kg.to(q.dtype)
        vg = vg.to(q.dtype)
    return (kg.reshape(B, NB * page, KV, D),
            vg.reshape(B, NB * page, KV, D))


def paged_decode_attention_ref(q: torch.Tensor, k_pool: torch.Tensor,
                               v_pool: torch.Tensor,
                               block_table: torch.Tensor,
                               kv_len: torch.Tensor, layer: int = 0,
                               k_scale: Optional[torch.Tensor] = None,
                               v_scale: Optional[torch.Tensor] = None
                               ) -> torch.Tensor:
    """q (B, 1, H, D); pools (L, num_pages, page, KV, D) (4D single-layer
    pools are promoted); block_table (B, NB) int32; kv_len (B,) int32;
    optional (L, num_pages, page, KV) f32 scales for int8 pools.  Masks
    positions >= kv_len[b].  Returns (B, 1, H, D)."""
    kg, vg = _gather_logical(q, k_pool, v_pool, block_table, layer,
                             k_scale, v_scale)
    return direct_attention(q, kg, vg, causal=False, kv_len=kv_len)


def paged_prefill_attention_ref(q: torch.Tensor, k_pool: torch.Tensor,
                                v_pool: torch.Tensor,
                                block_table: torch.Tensor,
                                base_len: torch.Tensor,
                                new_len: torch.Tensor, layer: int = 0,
                                k_scale: Optional[torch.Tensor] = None,
                                v_scale: Optional[torch.Tensor] = None
                                ) -> torch.Tensor:
    """q (B, T, H, D), a chunk whose K/V rows are already in the pool;
    base_len (B,) tokens resident before the chunk; new_len (B,) = base +
    granted tokens.  Row t attends positions <= base[b] + t and
    < new_len[b].  A fully empty slot (new_len == 0) softmaxes uniformly
    here, where the kernel emits zeros; both are garbage the engine never
    reads.  Returns (B, T, H, D)."""
    kg, vg = _gather_logical(q, k_pool, v_pool, block_table, layer,
                             k_scale, v_scale)
    return direct_attention(q, kg, vg, causal=True, q_offset=base_len,
                            kv_len=new_len)
