"""Int8 error-feedback gradient compression — port of
``repro/optim/grad_compress.py``, as pure functions.

Each block of 256 values is sent as int8 codes with an f32 scale, and
error feedback carries the quantization residual into the next step's
gradient, so errors cannot accumulate.  Its use, compressing the
data-parallel all-reduce, needs more than one card; on one card these
are the functions alone.
"""
from __future__ import annotations

from typing import Tuple

import torch

BLOCK = 256


def compress(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (any shape) -> (int8 blocks (nb, BLOCK), f32 scales (nb, 1))."""
    flat = x.to(torch.float32).reshape(-1)
    flat = torch.nn.functional.pad(flat, (0, (-flat.numel()) % BLOCK))
    blk = flat.reshape(-1, BLOCK)
    scale = torch.clamp(blk.abs().amax(dim=1, keepdim=True),
                        min=1e-12) / 127.0
    q = torch.clamp(torch.round(blk / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress(q: torch.Tensor, scale: torch.Tensor, shape) -> torch.Tensor:
    flat = (q.to(torch.float32) * scale).reshape(-1)
    n = 1
    for d in shape:
        n *= d
    return flat[:n].reshape(tuple(shape))


def ef_step(grad: torch.Tensor, residual: torch.Tensor):
    """One error-feedback compression step.  Returns (q, scale,
    new_residual, dequantized)."""
    comp_in = grad.to(torch.float32) + residual
    q, scale = compress(comp_in)
    deq = decompress(q, scale, grad.shape)
    return q, scale, comp_in - deq, deq
