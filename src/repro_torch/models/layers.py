"""Core layers of the paged serving path: rmsnorm, dense, embeddings,
rotary.  Port of the same functions in ``repro/models/layers.py``, with
the same dtype discipline (the tests hold each against its JAX function).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm: the variance accumulates in f32, the rsqrt factor and the
    scale are applied in x's dtype (as the JAX package does, to keep bf16
    activations from being upcast wholesale)."""
    var = (x * x).to(torch.float32).mean(dim=-1, keepdim=True)
    r = torch.rsqrt(var + eps).to(x.dtype)
    return x * r * scale.to(x.dtype)


def dense(x: torch.Tensor, w: torch.Tensor,
          b: Optional[torch.Tensor] = None) -> torch.Tensor:
    y = x @ w
    if b is not None:
        y = y + b.to(y.dtype)
    return y


def embed(tokens: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    return table[tokens]


def unembed(h: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Logits via the (possibly tied) embedding table: (..., d) @ (V, d)^T."""
    return h @ table.T


def rope_angles(positions: torch.Tensor, head_dim: int,
                theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions (..., S) -> (cos, sin) of shape (..., S, head_dim/2)."""
    half = head_dim // 2
    exps = -torch.arange(0, half, dtype=torch.float32,
                         device=positions.device) / half
    freqs = torch.pow(torch.tensor(theta, dtype=torch.float32,
                                   device=positions.device), exps)
    ang = positions.to(torch.float32)[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x (B, S, H, D); cos/sin (B, S, D/2).  Rotate-half convention."""
    x32 = x.to(torch.float32)
    half = x.shape[-1] // 2
    x1, x2 = x32[..., :half], x32[..., half:]
    c = cos[..., None, :]
    s = sin[..., None, :]
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return out.to(x.dtype)


def swiglu(x, w_gate, w_up, w_down):
    g = dense(x, w_gate)
    u = dense(x, w_up)
    return dense(F.silu(g) * u, w_down)
