"""Symmetric int8 row quantization for the paged KV page pools.

Port of ``repro/models/kv_quant.py``: one f32 scale per row per KV head
(pool (L, num_pages, page, KV, hd) -> scales (L, num_pages, page, KV)).
The arithmetic is the JAX package's, bit for bit: scale = absmax / 127,
round half to even, clip to [-127, 127], and all-zero rows get scale 1.0
so the null page dequantizes to exact zeros.
"""
from __future__ import annotations

import torch

QMAX = 127.0


def quantize_rows(x: torch.Tensor):
    """``x`` (..., hd) -> (int8 rows (..., hd), f32 scales (...))."""
    xf = x.to(torch.float32)
    absmax = xf.abs().amax(dim=-1)
    scale = torch.where(absmax > 0, absmax / QMAX,
                        torch.ones_like(absmax)).to(torch.float32)
    q = torch.clamp(torch.round(xf / scale[..., None]), -QMAX, QMAX)
    return q.to(torch.int8), scale


def dequantize_rows(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Inverse of ``quantize_rows``: int8 rows + f32 scales -> f32 rows."""
    return q.to(torch.float32) * scale[..., None].to(torch.float32)
